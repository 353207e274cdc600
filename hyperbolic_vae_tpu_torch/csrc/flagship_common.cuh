// What K2 (flagship_fused.cu) and K3 (flagship_train.cu) share: the
// flagship's constants, the NaN-keeping clamps, the elementwise helpers
// and their derivatives, the latent chain, the gyroplane epilogue and the
// wrapped-normal density, and the forward pass of one cluster of CTAs over
// kRows batch rows.
//
// The cluster design (both kernels). A cluster of kCluster = 8 CTAs takes
// kRows = 18 batch rows, so B = 256 runs 15 clusters = 120 CTAs. The card
// holds 15 such clusters at once (8 SMs of one GPC each, one CTA per SM at
// this shared memory): 16 rows a cluster gave B = 256 a 16th cluster, a
// second wave that doubled the kernels' time. CTA `rank` of a cluster owns
// hidden units [8 rank, 8 rank + 8) of the first layer and pixels
// [P5 rank, P5 rank + P5) of the last (P5 = ceil(D / 8) = 98 at D = 784).
// At its start it
// copies the cluster's rows of x (18 x 3,136 B), its 8 rows of w1 (25,088 B)
// and its P5 rows of w5 (98 x 256 B, into rows padded to 68 floats so that
// the pixel-major reads of layer 5 hit distinct banks) into shared memory
// with bulk asynchronous copies completing on one mbarrier; each weight
// byte is read from L2 once per cluster. Then:
//   layer 1  (784 -> 64): its 8 units for the 18 rows from shared memory.
//            Warp w takes unit w % 8 for 9 rows (w / 8 picks the half), 9
//            sums per lane, the lanes striding over the inputs. The 64
//            units are then gathered from the cluster's CTAs over
//            distributed shared memory.
//   middle   (64 -> 16, the two heads, the latent chain, the 16 gyroplanes
//            and 16 -> 64; ~2,000 multiply-adds a row) redundantly in
//            every CTA, with no exchange. The chain to z runs one lane per
//            row; once z is known its independent parts run side by side:
//            288 threads take one (row, gyroplane) epilogue each, and the
//            next 36 the two log densities of every row (K3 runs their
//            backward, whose cotangent is a constant, beside the
//            epilogues' backward, off the forward's critical path).
//   layer 5  (64 -> 784): its P5 pixels x 18 rows from shared memory, six
//            rows per thread, fused with the sigmoid, the clamps and the
//            RelaxedBernoulli term (and in K3 d loss / d logit); each
//            row's log density over the CTA's pixels is one warp's sum.
// Each row's recon is then the sum over the cluster's CTAs in rank order:
// no atomics anywhere, so the same inputs give the same bits.
//
// Rounding: built with -fmad=false, every product and sum rounds on its
// own, as the plain PyTorch version's separate elementwise ops do, and
// every value up to the logits is summed in the order of the earlier
// design of one CTA per 4 rows, so a row's activations, z, kl and logits
// keep their bits; only the sums over a row's pixels (recon) and, in K3,
// over the pixels of d logit w5 change order. Near the projection margin a
// row's z is so ill-conditioned (the gyroplane epilogue amplifies a last-
// bit change ~1,000-fold) that its error against float64 is a draw of the
// rounding; keeping the earlier design's rounding keeps its draw.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace flagship {

constexpr int kH1 = 64;   // first hidden width (and the decoder's)
constexpr int kH2 = 16;   // second hidden width = number of gyroplanes
constexpr int kP = kH2;
constexpr int kMaxLatent = 8;
constexpr int kNParams = 14;
constexpr int kPts = 8;   // index of the gyroplane points in the parameters
constexpr int kCluster = 8;             // CTAs per cluster
constexpr int kRows = 18;               // batch rows per cluster
constexpr int kThreads = 512;           // threads per CTA
constexpr int kWarps = kThreads / 32;
constexpr int kUnits = kH1 / kCluster;  // first-layer units per CTA
constexpr int kW5Stride = kH1 + 4;      // floats per staged row of w5
constexpr int kFixedSmem = 72 * 1024;   // bound on the fixed part of shared memory
constexpr int kRowsL1 = kRows / 2;      // layer 1: rows per warp (two row halves x 8 units)
constexpr int kRowsL5 = kRows / 3;      // layer 5: rows per thread (three row groups)
static_assert(kUnits == 8 && kWarps == 2 * kUnits && kRows % 6 == 0, "the layers' thread maps");


constexpr float kMinNorm = 1e-15f;
constexpr float kMinNorm2 = 1e-30f;
constexpr float kAtanhLo = (float)(-1.0 + 1.19e-7);
constexpr float kAtanhHi = (float)(1.0 - 1.19e-7);
constexpr float kTanhClamp = 15.0f;
constexpr float kProbLo = 1e-7f;
constexpr float kProbHi = (float)(1.0 - 1e-7);
constexpr float kTiny = 1.1754944e-38f;
constexpr float kXHi = (float)(1.0 - 1.1920929e-7);
constexpr float kLog2 = 0.69314718055994530942f;
constexpr float kGeluC0 = 0.79788456080286535588f;  // sqrt(2 / pi)
constexpr float kGeluC3 = (float)(3.0 * 0.044715);
constexpr float kHalfLog2Pi = 0.91893853320467274178f;
constexpr float kMaxRadius = 10.0f;  // MAX_SAMPLE_RADIUS

struct Params {
  // w1 b1 w2 b2 wm bm ws bs points pbias w4 b4 w5 b5 (_params_tuple's order)
  const float* p[kNParams];
};

struct Consts {
  float c, two_c, c_sq, sqrt_c, two_sqrt_c, two_over_sqrt_c;
  float max_norm, d_max, max_d2, beta, prior_scale, lsr_coef;
  float d_lp, g_kl;  // d loss_total / d lp (= -1/B) and / d kl (= beta/B)
};

inline Consts make_consts(double c, double beta, double prior_scale, int L, int B) {
  Consts k;
  const double sqrt_c = sqrt(c);
  k.c = (float)c;
  k.two_c = (float)(2.0 * c);
  k.c_sq = (float)(c * c);
  k.sqrt_c = (float)sqrt_c;
  k.two_sqrt_c = (float)(2.0 * sqrt_c);
  k.two_over_sqrt_c = (float)(2.0 / sqrt_c);
  k.max_norm = (float)((1.0 - 4e-3) / sqrt_c);
  k.d_max = (float)(2.0 / sqrt_c * atanh(1.0 - 4e-3));
  k.max_d2 = (float)((1.0 - 1e-4) * (1.0 - 1e-4) / c);
  k.beta = (float)beta;
  k.prior_scale = (float)prior_scale;
  k.lsr_coef = (float)(L - 1);
  k.d_lp = (float)(-1.0 / B);
  k.g_kl = (float)(beta / B);
  return k;
}

// per-row scratch in device memory that K3's rows kernel writes for its
// gradient sums (K2 writes only rows: (recon, kl) per row)
struct RowsOut {
  float *rows, *h1, *da1, *h2, *da2, *dmue, *dse, *gpts, *da3, *hd, *h4, *da4, *dout;
};

// max / min that keep a NaN in their first operand, as XLA's max / min and
// torch.clamp do (CUDA's fmaxf / fminf would drop it: a NaN pixel would
// give a finite recon)
__device__ __forceinline__ float maxn(float a, float b) { return a != a ? a : fmaxf(a, b); }
__device__ __forceinline__ float minn(float a, float b) { return a != a ? a : fminf(a, b); }

// ---- elementwise helpers ---------------------------------------------------

__device__ __forceinline__ float artanh_c(float x) {
  x = minn(maxn(x, kAtanhLo), kAtanhHi);
  return 0.5f * (log1pf(x) - log1pf(-x));
}

__device__ __forceinline__ float arsinh_g(float y) {
  const float a = fabsf(y);
  const float a_small = minn(a, 1e10f);
  const float small = logf(a_small + sqrtf(a_small * a_small + 1.0f));
  const float big = logf(maxn(a, 1e-30f)) + kLog2;
  const float s = y > 0.0f ? 1.0f : (y < 0.0f ? -1.0f : 0.0f);
  return s * (a > 1e10f ? big : small);
}

__device__ __forceinline__ float tanh_c(float x) {
  return tanhf(minn(maxn(x, -kTanhClamp), kTanhClamp));
}

__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.0f + tanhf(kGeluC0 * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float softplus(float x) {
  return maxn(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float log_sinh_ratio(float t) {
  const float t_safe = maxn(t, 0.1f);
  const float big = t_safe + log1pf(-expf(-2.0f * t_safe)) - kLog2 - logf(t_safe);
  const float t2 = t * t;
  const float small = t2 / 6.0f - t2 * t2 / 180.0f + t2 * t2 * t2 / 2835.0f;
  return t < 0.2f ? small : big;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---- derivative helpers (JAX's autodiff conventions) -----------------------

// d max(x, lo) / dx: 1, 1/2 at a tie, 0
__device__ __forceinline__ float ge(float x, float lo) {
  return x > lo ? 1.0f : (x == lo ? 0.5f : 0.0f);
}
// d min(x, hi) / dx: 1, 1/2 at a tie, 0
__device__ __forceinline__ float le(float x, float hi) {
  return x < hi ? 1.0f : (x == hi ? 0.5f : 0.0f);
}
// d clip(x, lo, hi) / dx, clip = min(max(x, lo), hi)
__device__ __forceinline__ float clip_grad(float x, float lo, float hi) {
  return ge(x, lo) * le(maxn(x, lo), hi);
}

__device__ __forceinline__ float gelu_grad(float x) {
  const float t = tanhf(kGeluC0 * (x + 0.044715f * x * x * x));
  return 0.5f * (1.0f + t) + 0.5f * x * (1.0f - t * t) * kGeluC0 * (1.0f + kGeluC3 * x * x);
}

__device__ __forceinline__ float artanh_grad(float x) {
  const float xc = minn(maxn(x, kAtanhLo), kAtanhHi);
  return 0.5f * (1.0f / (1.0f + xc) + 1.0f / (1.0f - xc)) * clip_grad(x, kAtanhLo, kAtanhHi);
}

__device__ __forceinline__ float tanh_grad(float x, float th) {
  return (1.0f - th * th) * clip_grad(x, -kTanhClamp, kTanhClamp);
}

__device__ __forceinline__ float lsr_grad(float t) {
  const float t_safe = maxn(t, 0.1f);
  const float e = expf(-2.0f * t_safe);
  const float big = (1.0f + 2.0f * e / (1.0f - e) - 1.0f / t_safe) * ge(t, 0.1f);
  const float t2 = t * t;
  const float small =
      (1.0f / 6.0f - 2.0f * t2 / 180.0f + 3.0f * t2 * t2 / 2835.0f) * 2.0f * t;
  return t < 0.2f ? small : big;
}

// ---- Mobius addition and its backward ---------------------------------------

struct Mob {
  float a2, b2, ab, ca, cb, den_raw, den;
};

// out = a (+) b on the c-ball, for L-vectors
__device__ inline void mob_fwd(const float* a, const float* b, float* out, int L, const Consts& k,
                               Mob& s) {
  float a2 = 0.0f, b2 = 0.0f, ab = 0.0f;
  for (int l = 0; l < L; ++l) {
    a2 += a[l] * a[l];
    b2 += b[l] * b[l];
    ab += a[l] * b[l];
  }
  s.a2 = a2;
  s.b2 = b2;
  s.ab = ab;
  s.ca = 1.0f + k.two_c * ab + k.c * b2;
  s.cb = 1.0f - k.c * a2;
  s.den_raw = 1.0f + k.two_c * ab + k.c_sq * a2 * b2;
  s.den = maxn(s.den_raw, kMinNorm);
  for (int l = 0; l < L; ++l) out[l] = (s.ca * a[l] + s.cb * b[l]) / s.den;
}

// (d a, d b) for the cotangent g of out = a (+) b
__device__ inline void mob_bwd(const float* a, const float* b, const float* out, const Mob& s,
                               const float* g, float* da, float* db, int L, const Consts& k) {
  float d_den = 0.0f, d_ca = 0.0f, d_cb = 0.0f;
  for (int l = 0; l < L; ++l) d_den += g[l] * out[l];
  d_den = -d_den / s.den * ge(s.den_raw, kMinNorm);
  for (int l = 0; l < L; ++l) {
    const float d_num = g[l] / s.den;
    d_ca += d_num * a[l];
    d_cb += d_num * b[l];
  }
  const float d_ab = k.two_c * (d_ca + d_den);
  const float d_b2 = k.c * d_ca + k.c_sq * s.a2 * d_den;
  const float d_a2 = -k.c * d_cb + k.c_sq * s.b2 * d_den;
  for (int l = 0; l < L; ++l) {
    const float d_num = g[l] / s.den;
    const float ga = d_num * s.ca + 2.0f * a[l] * d_a2 + b[l] * d_ab;
    const float gb = d_num * s.cb + 2.0f * b[l] * d_b2 + a[l] * d_ab;
    da[l] = ga;
    db[l] = gb;
  }
}

// ---- the wrapped-normal log density and its backward -----------------------

struct WN {
  Mob mob;
  float neg[kMaxLatent], sub[kMaxLatent], vv[kMaxLatent], uu[kMaxLatent];
  float s_sub, sub_n, om_raw, om, lam, xa, at, kk, t;
};

__device__ inline float wn_fwd(const float* loc, float loc2, const float* sc, const float* z, int L,
                               const Consts& k, WN& w) {
  for (int l = 0; l < L; ++l) w.neg[l] = -loc[l];
  mob_fwd(w.neg, z, w.sub, L, k, w.mob);
  float s = 0.0f;
  for (int l = 0; l < L; ++l) s += w.sub[l] * w.sub[l];
  w.s_sub = s;
  w.sub_n = sqrtf(maxn(s, kMinNorm2));
  w.om_raw = 1.0f - k.c * loc2;
  w.om = maxn(w.om_raw, kMinNorm);
  w.lam = 2.0f / w.om;
  w.xa = k.sqrt_c * w.sub_n;
  w.at = artanh_c(w.xa);
  w.kk = 2.0f / (k.sqrt_c * w.lam);
  float npdf = 0.0f;
  for (int l = 0; l < L; ++l) {
    w.vv[l] = w.kk * w.at * w.sub[l] / w.sub_n;
    w.uu[l] = w.vv[l] * w.lam;
    npdf += -(w.uu[l] * w.uu[l]) / (2.0f * sc[l] * sc[l]) - logf(sc[l]) - kHalfLog2Pi;
  }
  w.t = k.sqrt_c * (k.two_over_sqrt_c * w.at);
  return npdf - k.lsr_coef * log_sinh_ratio(w.t);
}

// cotangent g of the density -> d loc, d loc2, d sc, d z
__device__ inline void wn_bwd(const WN& w, const float* sc, const float* z, float g, int L,
                              const Consts& k, float* d_loc, float* d_loc2, float* d_sc,
                              float* d_z) {
  float d_sub[kMaxLatent], d_neg[kMaxLatent];
  float d_lam = 0.0f, d_k = 0.0f, d_at2 = 0.0f, d_subn = 0.0f;
  const float d_t = -g * k.lsr_coef * lsr_grad(w.t);
  float d_at = d_t * k.sqrt_c * k.two_over_sqrt_c;
  for (int l = 0; l < L; ++l) {
    const float d_uu = g * -(w.uu[l] / (sc[l] * sc[l]));
    d_sc[l] = g * (w.uu[l] * w.uu[l] / (sc[l] * sc[l] * sc[l]) - 1.0f / sc[l]);
    const float d_vv = d_uu * w.lam;
    d_lam += d_uu * w.vv[l];
    d_k += d_vv * w.at * w.sub[l] / w.sub_n;
    d_at2 += d_vv * w.kk * w.sub[l] / w.sub_n;
    d_sub[l] = d_vv * (w.kk * w.at) / w.sub_n;
    d_subn += d_vv * w.vv[l];
  }
  d_at = d_at + d_at2;
  d_subn = -d_subn / w.sub_n;
  d_lam = d_lam - d_k * w.kk / w.lam;
  d_subn = d_subn + d_at * artanh_grad(w.xa) * k.sqrt_c;
  const float m_sub = ge(w.s_sub, kMinNorm2);
  for (int l = 0; l < L; ++l) d_sub[l] = d_sub[l] + d_subn / w.sub_n * w.sub[l] * m_sub;
  *d_loc2 = -d_lam * w.lam / w.om * ge(w.om_raw, kMinNorm) * (-k.c);
  mob_bwd(w.neg, z, w.sub, w.mob, d_sub, d_neg, d_z, L, k);
  for (int l = 0; l < L; ++l) d_loc[l] = -d_neg[l];
}

// ---- the per-row latent chain to z: expmap0, project, scale, the
// truncated rsample, Mobius addition, project ---------------------------------

struct Row {
  float mue[kMaxLatent], se[kMaxLatent], e[kMaxLatent];
  float mu0[kMaxLatent], mu[kMaxLatent], sp[kMaxLatent], scale[kMaxLatent];
  float v0[kMaxLatent], v[kMaxLatent], u[kMaxLatent], second[kMaxLatent];
  float z0[kMaxLatent], z[kMaxLatent];
  float s_mue, mu_n, th, s_mu0, n_mu0, r1, f1, mu2, q, rr;
  float s_v0, vn, r2, f2, om_raw, om, lam_mu, s_u, u_n, w_arg, tu;
  float s_z0, nz, r3, f3;
  Mob mz;
};

// what the two log densities' backward gives the chain's backward (K3)
struct DensGrad {
  float d_locq[kMaxLatent], d_scale[kMaxLatent], d_z[2][kMaxLatent];
  float d_mu2;
};

__device__ inline void latent_fwd(Row& R, int L, const Consts& k) {
  float s = 0.0f;
  for (int l = 0; l < L; ++l) s += R.mue[l] * R.mue[l];
  R.s_mue = s;
  R.mu_n = sqrtf(maxn(s, kMinNorm2));
  R.th = tanh_c(k.sqrt_c * R.mu_n);
  s = 0.0f;
  for (int l = 0; l < L; ++l) {
    R.mu0[l] = R.th * R.mue[l] / (k.sqrt_c * R.mu_n);
    s += R.mu0[l] * R.mu0[l];
  }
  R.s_mu0 = s;
  R.n_mu0 = sqrtf(maxn(s, kMinNorm2));
  R.r1 = k.max_norm / R.n_mu0;
  R.f1 = minn(R.r1, 1.0f);
  float mu2 = 0.0f;
  for (int l = 0; l < L; ++l) {
    R.mu[l] = R.mu0[l] * R.f1;
    mu2 += R.mu[l] * R.mu[l];
    R.sp[l] = softplus(R.se[l]);
    R.scale[l] = minn(maxn(R.sp[l] + 1e-3f, 1e-3f), 10.0f);
  }
  R.mu2 = mu2;
  R.q = sqrtf(maxn(mu2, kMinNorm2));
  const float dist0 = k.two_over_sqrt_c * artanh_c(k.sqrt_c * R.q);
  R.rr = k.d_max - dist0;
  const float r_allowed = minn(maxn(R.rr, 1e-2f), kMaxRadius);
  s = 0.0f;
  for (int l = 0; l < L; ++l) {
    R.v0[l] = R.scale[l] * R.e[l];
    s += R.v0[l] * R.v0[l];
  }
  R.s_v0 = s;
  R.vn = sqrtf(maxn(s, 1e-24f));
  R.r2 = r_allowed / R.vn;
  R.f2 = minn(R.r2, 1.0f);
  R.om_raw = 1.0f - k.c * mu2;
  R.om = maxn(R.om_raw, kMinNorm);
  R.lam_mu = 2.0f / R.om;
  s = 0.0f;
  for (int l = 0; l < L; ++l) {
    R.v[l] = R.v0[l] * R.f2 / 2.0f;
    R.u[l] = R.v[l] * R.om;
    s += R.u[l] * R.u[l];
  }
  R.s_u = s;
  R.u_n = sqrtf(maxn(s, kMinNorm2));
  R.w_arg = k.sqrt_c * R.lam_mu * R.u_n / 2.0f;
  R.tu = tanh_c(R.w_arg);
  for (int l = 0; l < L; ++l) R.second[l] = R.tu * R.u[l] / (k.sqrt_c * R.u_n);
  mob_fwd(R.mu, R.second, R.z0, L, k, R.mz);
  s = 0.0f;
  for (int l = 0; l < L; ++l) s += R.z0[l] * R.z0[l];
  R.s_z0 = s;
  R.nz = sqrtf(maxn(s, kMinNorm2));
  R.r3 = k.max_norm / R.nz;
  R.f3 = minn(R.r3, 1.0f);
  for (int l = 0; l < L; ++l) R.z[l] = R.z0[l] * R.f3;
}

// ---- the gyroplane epilogue of one (row, plane) ------------------------------

struct Gyro {
  float z2, p2, zp;
  float den_raw, den, al, be, scd, e_raw, dn2, pn, q_raw, q_den, arg;
};

__device__ inline float gyro_fwd(const Consts& k, Gyro& g) {
  const float z2 = g.z2, p2 = g.p2, zp = g.zp;
  g.den_raw = 1.0f - k.two_c * zp + k.c_sq * p2 * z2;
  g.den = maxn(g.den_raw, kMinNorm);
  g.al = (1.0f - k.two_c * zp + k.c * z2) / g.den;
  g.be = (1.0f - k.c * p2) / g.den;
  g.scd = -g.al * p2 + g.be * zp;
  g.e_raw = g.al * g.al * p2 - 2.0f * g.al * g.be * zp + g.be * g.be * z2;
  g.dn2 = minn(maxn(g.e_raw, kMinNorm), k.max_d2);
  g.pn = sqrtf(maxn(p2, kMinNorm2));
  g.q_raw = (1.0f - k.c * g.dn2) * g.pn;
  g.q_den = maxn(g.q_raw, kMinNorm);
  g.arg = k.two_sqrt_c * g.scd / g.q_den;
  return arsinh_g(g.arg) / k.sqrt_c;
}

// ---- shared memory of one CTA ------------------------------------------------

// the fixed part; after it come x's rows (kRows x D4), the w1 slice (kUnits
// x D4), the w5 slice (P5 x kW5Stride), the rows' log density terms
// (kRows x P5r) and, in K3, d loss / d logit (kRows x P5r)
struct Shared {
  alignas(16) float a4[kRows][kH1];
  alignas(16) float h4[kRows][kH1];
  uint64_t bar;
  float b1[kH1], b2[kH2], bm[kMaxLatent], bs[kMaxLatent], pb[kP], b4[kH1];
  float w2[kH2][kH1 + 1];  // rows padded by one float: the layer reads them across lanes
  float wm[kMaxLatent * kH2], ws[kMaxLatent * kH2];
  float pts[kP * kMaxLatent];
  float w4[kH1][kH2 + 1];
  float red1[kRows][kUnits];  // layer 1's sums
  float a1[kRows][kUnits];        // this CTA's units of a1
  float h1[kRows][kH1];
  float a2[kRows][kH2], h2[kRows][kH2];
  float a3[kRows][kP], hd[kRows][kP];
  float z[kRows][kMaxLatent];
  float recp[kRows];      // this CTA's share of each row's log density sum
  float logd[kRows][2];   // log q(z), log p(z)
  Row rs[kRows];
  // K3's backward
  float da4p[kRows][kH1];  // this CTA's share of d logit w5
  float da4[kRows][kH1];
  float dzp[kRows][kP], dz2[kRows][kP];
  float dmue[kRows][kMaxLatent], dse[kRows][kMaxLatent];
  float da2[kRows][kH2];
  DensGrad dg[kRows];
  WN wn[kRows][2];  // the densities' forward values, for their backward
};
static_assert(sizeof(Shared) <= kFixedSmem, "the fixed part outgrew its bound");

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int pixels_per_cta(int D) { return (D + kCluster - 1) / kCluster; }

// dynamic shared memory of a rows kernel for D pixels (K3: train = true).
// ops/flagship_fused.py's _rows_smem_bytes mirrors it with kFixedSmem in
// place of sizeof(Shared).
inline size_t rows_smem_bytes(int D, bool train) {
  const int d4 = round4(D), p5 = pixels_per_cta(D), p5r = round4(p5);
  const size_t floats = (size_t)(kRows + kUnits) * d4 + (size_t)p5 * kW5Stride +
                        (size_t)(train ? 2 : 1) * kRows * p5r;
  return (sizeof(Shared) + 15) / 16 * 16 + 4 * floats;
}

// ---- the forward pass of one cluster -----------------------------------------

struct Slices {
  float *xs, *w1s, *w5s, *lps, *dos;
  int d4, p5r, p0, npix, rank, row0, nrows;
};

__device__ inline Slices carve(Shared& S, int B, int D, bool train) {
  Slices v;
  v.d4 = round4(D);
  const int p5 = pixels_per_cta(D);
  v.p5r = round4(p5);
  float* base = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(&S) +
                                         (sizeof(Shared) + 15) / 16 * 16);
  v.xs = base;
  v.w1s = v.xs + kRows * v.d4;
  v.w5s = v.w1s + kUnits * v.d4;
  v.lps = v.w5s + p5 * kW5Stride;
  v.dos = train ? v.lps + kRows * v.p5r : nullptr;
  v.rank = (int)(blockIdx.x % kCluster);
  v.row0 = (int)(blockIdx.x / kCluster) * kRows;
  v.nrows = min(kRows, B - v.row0);
  v.p0 = v.rank * p5;
  v.npix = max(0, min(p5, D - v.p0));
  return v;
}

// Phases 0-8 of the design above for the cluster's rows. On return
// S.recp, S.logd and (kTrain) S.dg, v.dos hold this CTA's results, and
// thread t < kRows kP holds in g the epilogue of (row t / 16, plane t % 16).
// kTrain also writes this CTA's share of so (h1, h2, hd, h4, dout).
// Ends with a __syncthreads; no remote access is pending.
template <bool kTrain>
__device__ __forceinline__ void cluster_forward(Shared& S, const Slices& v, const float* x,
                                                const float* eps, const Params& prm,
                                                const RowsOut& so, int D, int L,
                                                const Consts& k, Gyro& g) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* __restrict__ w1 = prm.p[0];
  const float* __restrict__ w5 = prm.p[12];
  const int d4 = v.d4, rank = v.rank, row0 = v.row0, nrows = v.nrows;

  // 0. stage x's rows, the w1 slice and the w5 slice by bulk copies when
  //    every source is 16-byte aligned and D % 4 == 0 (else by plain loads,
  //    zero-padding each row to d4); rows past the batch end are zeros
  if (tid == 0) hopper::mbar_init(&S.bar, 1);
  __syncthreads();
  hopper::grid_dependency_wait();  // x and the parameters may come from the previous launch
  const bool bulk = D % 4 == 0 &&
                    ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w1) |
                      reinterpret_cast<uintptr_t>(w5)) & 15) == 0;
  if (bulk) {
    if (tid == 0) {
      const uint32_t xb = (uint32_t)(nrows * D * 4), wb = (uint32_t)(kUnits * D * 4);
      hopper::mbar_arrive_expect_tx(&S.bar, xb + wb + (uint32_t)v.npix * kH1 * 4);
      hopper::bulk_copy_g2s(v.xs, x + (size_t)row0 * D, xb, &S.bar);
      hopper::bulk_copy_g2s(v.w1s, w1 + (size_t)rank * kUnits * D, wb, &S.bar);
    }
    for (int i = tid; i < v.npix; i += kThreads)
      hopper::bulk_copy_g2s(v.w5s + i * kW5Stride, w5 + (size_t)(v.p0 + i) * kH1, kH1 * 4, &S.bar);
  } else {
    for (int e = tid; e < nrows * d4; e += kThreads) {
      const int r = e / d4, c = e - r * d4;
      v.xs[e] = c < D ? x[(size_t)(row0 + r) * D + c] : 0.0f;
    }
    for (int e = tid; e < kUnits * d4; e += kThreads) {
      const int u = e / d4, c = e - u * d4;
      v.w1s[e] = c < D ? w1[(size_t)(rank * kUnits + u) * D + c] : 0.0f;
    }
    for (int e = tid; e < v.npix * kH1; e += kThreads)
      v.w5s[(e >> 6) * kW5Stride + (e & 63)] = w5[(size_t)v.p0 * kH1 + e];
  }
  for (int e = nrows * d4 + tid; e < kRows * d4; e += kThreads) v.xs[e] = 0.0f;
  // the small parameters, by plain loads meanwhile
  for (int e = tid; e < kH2 * kH1; e += kThreads) S.w2[e >> 6][e & 63] = prm.p[2][e];
  for (int e = tid; e < kH1 * kH2; e += kThreads) S.w4[e >> 4][e & 15] = prm.p[10][e];
  if (tid < kH1) {
    S.b1[tid] = prm.p[1][tid];
    S.b4[tid] = prm.p[11][tid];
  }
  if (tid < kH2) {
    S.b2[tid] = prm.p[3][tid];
    S.pb[tid] = prm.p[9][tid];
  }
  if (tid < L * kH2) {
    S.wm[tid] = prm.p[4][tid];
    S.ws[tid] = prm.p[6][tid];
  }
  if (tid < kP * L) S.pts[tid] = prm.p[8][tid];
  if (tid < L) {
    S.bm[tid] = prm.p[5][tid];
    S.bs[tid] = prm.p[7][tid];
  }
  if (tid < kRows * L) {
    const int r = tid / L, l = tid - r * L;
    S.rs[r].e[l] = r < nrows ? eps[(size_t)(row0 + r) * L + l] : 0.0f;
  }
  if (bulk) hopper::mbar_wait(&S.bar, 0);
  __syncthreads();

  // 1. a1 for this CTA's 8 units: warp -> (row half, unit), lanes stride
  //    over the inputs (the earlier design's order: each lane's inputs in
  //    turn, then the warp's butterfly sum)
  {
    const int rh = warp / kUnits, u = warp % kUnits;
    const float* xr = v.xs + (size_t)(kRowsL1 * rh) * d4;
    const float* wr = v.w1s + (size_t)u * d4;
    float acc[kRowsL1];
#pragma unroll
    for (int r = 0; r < kRowsL1; ++r) acc[r] = 0.0f;
    for (int i = lane; i < D; i += 32) {
      const float w = wr[i];
#pragma unroll
      for (int r = 0; r < kRowsL1; ++r) acc[r] += xr[r * d4 + i] * w;
    }
#pragma unroll
    for (int r = 0; r < kRowsL1; ++r) {
      const float s = warp_sum(acc[r]);
      if (lane == 0) S.red1[kRowsL1 * rh + r][u] = s;
    }
  }
  __syncthreads();
  if (tid < kRows * kUnits) {
    const int r = tid / kUnits, u = tid % kUnits, j = rank * kUnits + u;
    const float a = S.red1[r][u] + S.b1[j];
    const float h = gelu(a);
    S.a1[r][u] = a;
    S.h1[r][j] = h;
    if (kTrain && r < nrows) so.h1[(size_t)(row0 + r) * kH1 + j] = h;
  }
  // every CTA's units of h1 to every CTA, over distributed shared memory
  hopper::cluster_sync();
  for (int e = tid; e < kRows * kH1; e += kThreads) {
    const int r = e >> 6, j = e & 63, owner = j / kUnits;
    if (owner != rank) S.h1[r][j] = *hopper::cluster_map(&S.h1[r][j], (uint32_t)owner);
  }
  __syncthreads();

  // 2. a2 = h1 w2^T + b2: one thread per (row, output)
  if (tid < kRows * kH2) {
    const int r = tid >> 4, j = tid & 15;
    float s = 0.0f;
    for (int i = 0; i < kH1; ++i) s += S.h1[r][i] * S.w2[j][i];
    const float a = s + S.b2[j];
    S.a2[r][j] = a;
    S.h2[r][j] = gelu(a);
    if (kTrain && rank == 0 && r < nrows) so.h2[(size_t)(row0 + r) * kH2 + j] = S.h2[r][j];
  }
  __syncthreads();

  // 3. the mean and scale heads: one thread per (head, row, latent)
  if (tid < 2 * kRows * L) {
    const int head = tid / (kRows * L);
    const int r = (tid / L) % kRows, l = tid % L;
    const float* w = head == 0 ? S.wm : S.ws;
    float s = 0.0f;
    for (int i = 0; i < kH2; ++i) s += S.h2[r][i] * w[l * kH2 + i];
    if (head == 0) S.rs[r].mue[l] = s + S.bm[l];
    else S.rs[r].se[l] = s + S.bs[l];
  }
  __syncthreads();

  // 4. the latent chain to z, one lane per row
  if (tid < kRows) {
    Row& R = S.rs[tid];
    latent_fwd(R, L, k);
    for (int l = 0; l < L; ++l) S.z[tid][l] = R.z[l];
  }
  __syncthreads();

  // 5. side by side: the 16 gyroplane epilogues of each row (one thread per
  //    (row, plane)), and the two log densities of each row on the next
  //    2 kRows threads (one per (row, density))
  if (tid < kRows * kP) {
    const int r = tid >> 4, p = tid & 15;
    float z2 = 0.0f, p2 = 0.0f, zp = 0.0f;
    for (int l = 0; l < L; ++l) {
      const float pv = S.pts[p * L + l];
      z2 += S.z[r][l] * S.z[r][l];
      p2 += pv * pv;
      zp += S.z[r][l] * pv;
    }
    g.z2 = z2;
    g.p2 = p2;
    g.zp = zp;
    const float a = gyro_fwd(k, g) + S.pb[p];
    S.a3[r][p] = a;
    S.hd[r][p] = gelu(a);
    if (kTrain && rank == 0 && r < nrows) so.hd[(size_t)(row0 + r) * kP + p] = S.hd[r][p];
  } else if (tid < kRows * kP + 2 * kRows) {
    const int r = (tid - kRows * kP) >> 1, prior = tid & 1;
    const Row& R = S.rs[r];
    float loc[kMaxLatent], sc[kMaxLatent];
    for (int l = 0; l < L; ++l) {
      loc[l] = prior ? 0.0f : R.mu[l];
      sc[l] = prior ? k.prior_scale : R.scale[l];
    }
    WN w;
    S.logd[r][prior] = wn_fwd(loc, prior ? 0.0f : R.mu2, sc, R.z, L, k, w);
    if (kTrain) S.wn[r][prior] = w;  // K3 runs the backward beside the epilogues'
  }
  __syncthreads();

  // 6. a4 = hd w4^T + b4: two (row, output) per thread
  for (int e = tid; e < kRows * kH1; e += kThreads) {
    const int r = e >> 6, j = e & 63;
    float s = 0.0f;
    for (int i = 0; i < kH2; ++i) s += S.hd[r][i] * S.w4[j][i];
    const float a = s + S.b4[j];
    S.a4[r][j] = a;
    S.h4[r][j] = gelu(a);
    if (kTrain && rank == 0 && r < nrows) so.h4[(size_t)(row0 + r) * kH1 + j] = S.h4[r][j];
  }
  __syncthreads();

  // 7. this CTA's pixels: the logit, the RelaxedBernoulli(T = 1) log density
  //    (and in K3 d loss / d logit), kRowsL5 rows per thread
  {
    const float* __restrict__ b5 = prm.p[13];
    const int npix = v.npix;
    for (int t = tid; t < (kRows / kRowsL5) * npix; t += kThreads) {
      const int rq = t / npix, i = t - rq * npix;
      const float4* wr = reinterpret_cast<const float4*>(v.w5s + i * kW5Stride);
      float o[kRowsL5];
#pragma unroll
      for (int r = 0; r < kRowsL5; ++r) o[r] = 0.0f;
#pragma unroll 4
      for (int q = 0; q < kH1 / 4; ++q) {
        const float4 w = wr[q];
#pragma unroll
        for (int r = 0; r < kRowsL5; ++r) {
          const float4 h = reinterpret_cast<const float4*>(S.h4[kRowsL5 * rq + r])[q];
          float a = o[r] + h.x * w.x;
          a = a + h.y * w.y;
          a = a + h.z * w.z;
          o[r] = a + h.w * w.w;
        }
      }
      const float bias = b5[v.p0 + i];
#pragma unroll
      for (int r = 0; r < kRowsL5; ++r) {
        const int row = kRowsL5 * rq + r;
        const float xhat = 1.0f / (1.0f + expf(-(o[r] + bias)));
        const float pc = minn(maxn(xhat, kProbLo), kProbHi);
        const float logits = logf(pc) - log1pf(-pc);
        const float xc = minn(maxn(v.xs[row * d4 + v.p0 + i], kTiny), kXHi);
        const float y = logf(xc) - log1pf(-xc);
        const float diff = logits - y;
        const float base = diff - 2.0f * softplus(diff);
        v.lps[row * v.p5r + i] = base - logf(xc) - log1pf(-xc);
        if (kTrain) {
          const float d_diff = k.d_lp - 2.0f * k.d_lp * sigmoid(diff);
          const float d_pc = d_diff / pc + d_diff / (1.0f - pc);
          const float d_o = d_pc * clip_grad(xhat, kProbLo, kProbHi) * xhat * (1.0f - xhat);
          v.dos[row * v.p5r + i] = d_o;
          if (row < nrows) so.dout[(size_t)(row0 + row) * D + v.p0 + i] = d_o;
        }
      }
    }
  }
  __syncthreads();

  // 8. each row's sum over this CTA's pixels: one warp per row
  for (int r = warp; r < kRows; r += kWarps) {
    float s = 0.0f;
    for (int i = lane; i < v.npix; i += 32) s += v.lps[r * v.p5r + i];
    s = warp_sum(s);
    if (lane == 0) S.recp[r] = s;
  }
  __syncthreads();
}

}  // namespace flagship
