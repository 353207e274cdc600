// The flagship GyroplaneVAE's whole training step for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   hyperbolic_vae_tpu/ops/flagship_fused.py::_train_kernel
// (launched by make_fused_train_step). For a batch x (B, D), draws eps
// (B, L) and the 14 parameters of the flagship with their two Adam moments
// (nn.Linear's (out, in) layout, hidden widths 64 and 16, 16 gyroplanes,
// L <= 8) it computes the forward pass and ELBO (as K2), the gradient of
// loss_total with respect to all 14 parameters, the finite guard
// ok = isfinite(loss) & isfinite(sum g^2), and the Riemannian Adam update
// (Adam for 13 tensors; for the gyroplane points g / lambda^2, expmap
// retraction, projection, exp_avg transported by the gyration), and where
// ok it writes the new parameters and moments in place. count advances
// every step, as in JAX's K3. The TPU kernel gets its backward from
// jax.value_and_grad at trace time; here it is derived by hand and follows
// ops/flagship_fused.py::flagship_grads_torch of the port stage by stage.
//
// Bound on this card: at B = 256, D = 784, L = 2 the step reads x (802,816
// B) and three copies of the parameters (3 x 413,776 B) and writes three,
// ~3.3 MB, ~1 us at 3.35 TB/s; it does ~0.26 M multiply-adds per row for
// the forward and the backward (no gradient for x), ~135 MFLOP at B = 256
// plus ~20 MFLOP of elementwise work, ~2.3 us at 67 TFLOP/s f32. So it is
// bound by operations; a few launches of a few us are its real floor.
//
// Why the TPU design does not carry over: the TPU kernel holds the batch,
// the weights and both moments in VMEM in one grid cell and lets Mosaic
// lower the autodiff's matmuls. Here:
//   1. train_rows_kernel: kRows batch rows per block, as K2: x staged in
//      shared memory, w1 and w5 read in place; the forward, then the
//      backward down to per-row activation gradients (dlogit, da4, da3,
//      the per-row point gradients, dmu_e, dsigma_e, da2, da1), written
//      with the activations the weight gradients need to a scratch in
//      device memory. The 2-D latent chain runs one thread per row, the 16
//      gyroplane epilogues one thread per (row, plane).
//   2. train_grad_kernel: every weight and bias gradient as a sum over the
//      batch in b order, 32 x 32 output tiles per block with the operands
//      staged in shared memory, and per-block partial sums of g^2 in a
//      fixed order. No atomics: a step gives the same bits every run.
//   3. train_finalize_kernel (one block): the loss means, sum g^2, ok,
//      count + 1 (written back) and the bias corrections, in f32.
//   4. train_update_kernel: one thread per element of the 13 Euclidean
//      tensors, one per row of the gyroplane points; each thread reads its
//      own elements before it writes them, so the update is in place.
// Plain f32 on the CUDA cores, built with -fmad=false so each product and
// sum rounds as the plain PyTorch version's separate elementwise ops do.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kH1 = 64;       // first hidden width (and the decoder's)
constexpr int kH2 = 16;       // second hidden width = number of gyroplanes
constexpr int kP = kH2;
constexpr int kMaxLatent = 8;
constexpr int kRows = 4;      // batch rows per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;     // weight-gradient tile
constexpr int kNParams = 14;
constexpr int kPts = 8;       // index of the gyroplane points
constexpr int kJobs = 8;
static_assert(kRows * kH1 == kThreads, "the decoder layer maps one thread per (row, output)");

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

// per-row scratch in device memory, written by the rows kernel
struct RowsOut {
  float *rows, *h1, *da1, *h2, *da2, *dmue, *dse, *gpts, *da3, *hd, *h4, *da4, *dout;
};

// max / min that keep a NaN in their first operand, as XLA's max / min and
// torch.clamp do (CUDA's fmaxf / fminf would drop it: a NaN pixel would
// give a finite recon)
__device__ __forceinline__ float maxn(float a, float b) { return a != a ? a : fmaxf(a, b); }
__device__ __forceinline__ float minn(float a, float b) { return a != a ? a : fminf(a, b); }

// ---- forward helpers (as K2) ---------------------------------------------

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

// ---- derivative helpers (JAX's autodiff conventions) ---------------------

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

// ---- Mobius addition and its backward -----------------------------------

struct Mob {
  float a2, b2, ab, ca, cb, den_raw, den;
};

// out = a (+) b on the c-ball, for L-vectors
__device__ void mob_fwd(const float* a, const float* b, float* out, int L, const Consts& k,
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
__device__ void mob_bwd(const float* a, const float* b, const float* out, const Mob& s,
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

// ---- the wrapped-normal log density and its backward ---------------------

struct WN {
  Mob mob;
  float neg[kMaxLatent], sub[kMaxLatent], vv[kMaxLatent], uu[kMaxLatent];
  float s_sub, sub_n, om_raw, om, lam, xa, at, kk, t;
};

__device__ float wn_fwd(const float* loc, float loc2, const float* sc, const float* z, int L,
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

// cotangent g of the density -> d loc, d loc2, d sc (if d_sc), d z
__device__ void wn_bwd(const WN& w, const float* sc, const float* z, float g, int L,
                       const Consts& k, float* d_loc, float* d_loc2, float* d_sc, float* d_z) {
  float d_sub[kMaxLatent], d_neg[kMaxLatent];
  float d_lam = 0.0f, d_k = 0.0f, d_at2 = 0.0f, d_subn = 0.0f;
  const float d_t = -g * k.lsr_coef * lsr_grad(w.t);
  float d_at = d_t * k.sqrt_c * k.two_over_sqrt_c;
  for (int l = 0; l < L; ++l) {
    const float d_uu = g * -(w.uu[l] / (sc[l] * sc[l]));
    if (d_sc) d_sc[l] = g * (w.uu[l] * w.uu[l] / (sc[l] * sc[l] * sc[l]) - 1.0f / sc[l]);
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

// ---- the per-row latent chain: expmap0, project, scale, the truncated
// rsample, Mobius addition, project, both log densities -------------------

struct Row {
  float mue[kMaxLatent], se[kMaxLatent], e[kMaxLatent];
  float mu0[kMaxLatent], mu[kMaxLatent], sp[kMaxLatent], scale[kMaxLatent];
  float v0[kMaxLatent], v[kMaxLatent], u[kMaxLatent], second[kMaxLatent];
  float z0[kMaxLatent], z[kMaxLatent];
  float s_mue, mu_n, th, s_mu0, n_mu0, r1, f1, mu2, q, rr;
  float s_v0, vn, r2, f2, om_raw, om, lam_mu, s_u, u_n, w_arg, tu;
  float s_z0, nz, r3, f3, kl;
  Mob mz;
  WN wq, wp;
};

__device__ void latent_fwd(Row& R, int L, const Consts& k) {
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

  // kl = log q(z | mu, scale) - log p(z | 0, prior_scale)
  float zero[kMaxLatent], prior[kMaxLatent];
  for (int l = 0; l < L; ++l) {
    zero[l] = 0.0f;
    prior[l] = k.prior_scale;
  }
  R.kl = wn_fwd(R.mu, R.mu2, R.scale, R.z, L, k, R.wq) -
         wn_fwd(zero, 0.0f, prior, R.z, L, k, R.wp);
}

// d_z (in: the gyroplanes' cotangent of z) -> d mu_e, d sigma_e (the heads)
__device__ void latent_bwd(Row& R, float* d_z, int L, const Consts& k, float* d_mue,
                           float* d_se) {
  float d_locq[kMaxLatent], d_scale[kMaxLatent], d_zq[kMaxLatent], d_zpr[kMaxLatent];
  float d_tmp[kMaxLatent], prior[kMaxLatent];
  float d_mu2, d_tmp2;
  wn_bwd(R.wq, R.scale, R.z, k.g_kl, L, k, d_locq, &d_mu2, d_scale, d_zq);
  for (int l = 0; l < L; ++l) prior[l] = k.prior_scale;
  wn_bwd(R.wp, prior, R.z, -k.g_kl, L, k, d_tmp, &d_tmp2, nullptr, d_zpr);
  for (int l = 0; l < L; ++l) d_z[l] = d_z[l] + d_zq[l] + d_zpr[l];

  // z = project(mu (+) second)
  float d_f3 = 0.0f;
  for (int l = 0; l < L; ++l) d_f3 += d_z[l] * R.z0[l];
  const float d_nz = -d_f3 * le(R.r3, 1.0f) * R.r3 / R.nz;
  float d_z0[kMaxLatent], d_mu[kMaxLatent], d_second[kMaxLatent];
  const float m_z0 = ge(R.s_z0, kMinNorm2);
  for (int l = 0; l < L; ++l) d_z0[l] = d_z[l] * R.f3 + d_nz / R.nz * R.z0[l] * m_z0;
  mob_bwd(R.mu, R.second, R.z0, R.mz, d_z0, d_mu, d_second, L, k);

  // second = tanh(sqrt(c) lam_mu |u| / 2) u / (sqrt(c) |u|)
  const float den_s = k.sqrt_c * R.u_n;
  float d_tu = 0.0f, d_un = 0.0f, d_u[kMaxLatent];
  for (int l = 0; l < L; ++l) {
    d_tu += d_second[l] * R.u[l];
    d_u[l] = d_second[l] * R.tu / den_s;
    d_un += d_second[l] * R.second[l];
  }
  d_tu = d_tu / den_s;
  d_un = -d_un / R.u_n;
  const float d_w = d_tu * tanh_grad(R.w_arg, R.tu);
  const float d_lam = d_w * k.sqrt_c * R.u_n / 2.0f;
  d_un = d_un + d_w * k.sqrt_c * R.lam_mu / 2.0f;
  const float m_u = ge(R.s_u, kMinNorm2);
  float d_om = 0.0f;
  for (int l = 0; l < L; ++l) {
    d_u[l] = d_u[l] + d_un / R.u_n * R.u[l] * m_u;
    d_om += d_u[l] * R.v[l];
  }
  // u = v om, lam_mu = 2 / om, v = v0 f2 / 2
  d_om = d_om - d_lam * R.lam_mu / R.om;
  d_mu2 = d_mu2 + d_om * ge(R.om_raw, kMinNorm) * (-k.c);
  float d_v1[kMaxLatent], d_f2 = 0.0f;
  for (int l = 0; l < L; ++l) {
    d_v1[l] = d_u[l] * R.om / 2.0f;
    d_f2 += d_v1[l] * R.v0[l];
  }
  const float d_r2 = d_f2 * le(R.r2, 1.0f);
  const float d_vn = -d_r2 * R.r2 / R.vn;
  const float m_v0 = ge(R.s_v0, 1e-24f);
  for (int l = 0; l < L; ++l) {
    const float d_v0 = d_v1[l] * R.f2 + d_vn / R.vn * R.v0[l] * m_v0;
    d_scale[l] = d_scale[l] + d_v0 * R.e[l];
  }
  // r_allowed = clip(d_max - dist0, 1e-2, MAX_SAMPLE_RADIUS), dist0 of |mu|
  const float d_dist0 = -(d_r2 / R.vn) * clip_grad(R.rr, 1e-2f, kMaxRadius);
  const float d_q = d_dist0 * k.two_over_sqrt_c * artanh_grad(k.sqrt_c * R.q) * k.sqrt_c;
  d_mu2 = d_mu2 + d_q * 0.5f / R.q * ge(R.mu2, kMinNorm2);
  float d_f1 = 0.0f;
  for (int l = 0; l < L; ++l) {
    d_mu[l] = d_mu[l] + d_locq[l] + 2.0f * R.mu[l] * d_mu2;
    d_f1 += d_mu[l] * R.mu0[l];
  }
  // mu = project(expmap0(mu_e))
  const float d_nmu0 = -d_f1 * le(R.r1, 1.0f) * R.r1 / R.n_mu0;
  const float m_mu0 = ge(R.s_mu0, kMinNorm2);
  const float den_m = k.sqrt_c * R.mu_n;
  float d_th = 0.0f, d_mun = 0.0f, d_mu0[kMaxLatent];
  for (int l = 0; l < L; ++l) {
    d_mu0[l] = d_mu[l] * R.f1 + d_nmu0 / R.n_mu0 * R.mu0[l] * m_mu0;
    d_th += d_mu0[l] * R.mue[l];
    d_mun += d_mu0[l] * R.mu0[l];
  }
  d_th = d_th / den_m;
  d_mun = -d_mun / R.mu_n;
  d_mun = d_mun + d_th * tanh_grad(k.sqrt_c * R.mu_n, R.th) * k.sqrt_c;
  const float m_mue = ge(R.s_mue, kMinNorm2);
  for (int l = 0; l < L; ++l) {
    d_mue[l] = d_mu0[l] * R.th / den_m + d_mun / R.mu_n * R.mue[l] * m_mue;
    d_se[l] = d_scale[l] * clip_grad(R.sp[l] + 1e-3f, 1e-3f, 10.0f) * sigmoid(R.se[l]);
  }
}

// ---- the gyroplane epilogue of one (row, plane) and its backward ---------

struct Gyro {
  float den_raw, den, al, be, scd, e_raw, dn2, pn, q_raw, q_den, arg;
};

__device__ float gyro_fwd(float z2, float p2, float zp, const Consts& k, Gyro& g) {
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

// d dist -> (d zp, d z2, d p2)
__device__ void gyro_bwd(const Gyro& g, float z2, float p2, float zp, float d_dist,
                         const Consts& k, float* d_zp_out, float* d_z2_out, float* d_p2_out) {
  const float a_abs = fabsf(g.arg);
  const float a_small = minn(a_abs, 1e10f);
  const float d_s =
      a_abs > 1e10f ? 1.0f / a_abs : le(a_abs, 1e10f) / sqrtf(a_small * a_small + 1.0f);
  const float d_arg = d_dist / k.sqrt_c * d_s * (g.arg != 0.0f ? 1.0f : 0.0f);
  const float d_scd = d_arg * k.two_sqrt_c / g.q_den;
  const float d_qraw = -d_arg * g.arg / g.q_den * ge(g.q_raw, kMinNorm);
  const float d_e = d_qraw * (-k.c) * g.pn * clip_grad(g.e_raw, kMinNorm, k.max_d2);
  const float d_al = d_e * (2.0f * g.al * p2 - 2.0f * g.be * zp) - d_scd * p2;
  const float d_be = d_e * (2.0f * g.be * z2 - 2.0f * g.al * zp) + d_scd * zp;
  float d_p2 = d_e * g.al * g.al - d_scd * g.al;
  float d_zp = d_e * (-2.0f * g.al * g.be) + d_scd * g.be;
  float d_z2 = d_e * g.be * g.be;
  d_zp = d_zp + d_al * (-k.two_c) / g.den;
  d_z2 = d_z2 + d_al * k.c / g.den;
  d_p2 = d_p2 + d_be * (-k.c) / g.den;
  const float d_den = -(d_al * g.al + d_be * g.be) / g.den * ge(g.den_raw, kMinNorm);
  d_zp = d_zp + d_den * (-k.two_c);
  d_p2 = d_p2 + d_den * k.c_sq * z2;
  d_z2 = d_z2 + d_den * k.c_sq * p2;
  d_p2 = d_p2 + d_qraw * (1.0f - k.c * g.dn2) * 0.5f / g.pn * ge(p2, kMinNorm2);
  *d_zp_out = d_zp;
  *d_z2_out = d_z2;
  *d_p2_out = d_p2;
}

// ---- 1. per block: kRows rows, forward and backward to per-row gradients

__global__ void __launch_bounds__(kThreads)
train_rows_kernel(const float* __restrict__ x, const float* __restrict__ eps, Params prm,
                  RowsOut so, int B, int D, int L, Consts k) {
  extern __shared__ float dyn[];  // x rows (kRows, D), then d logit (kRows, D)
  float* xs = dyn;
  float* dos = dyn + kRows * D;
  __shared__ float a1s[kRows][kH1], h1s[kRows][kH1];
  __shared__ float a2s[kRows][kH2], h2s[kRows][kH2];
  __shared__ float a3s[kRows][kP], hds[kRows][kP];
  __shared__ float a4s[kRows][kH1], h4s[kRows][kH1], da4s[kRows][kH1];
  __shared__ float zs[kRows][kMaxLatent];
  __shared__ float dzp[kRows][kP], dz2[kRows][kP];
  __shared__ float dmue[kRows][kMaxLatent], dse[kRows][kMaxLatent];
  __shared__ float da2s[kRows][kH2];
  __shared__ float red[kWarps][kRows];
  __shared__ Row rs[kRows];

  const float* __restrict__ w1 = prm.p[0];
  const float* __restrict__ b1 = prm.p[1];
  const float* __restrict__ w2 = prm.p[2];
  const float* __restrict__ b2 = prm.p[3];
  const float* __restrict__ wm = prm.p[4];
  const float* __restrict__ bm = prm.p[5];
  const float* __restrict__ ws = prm.p[6];
  const float* __restrict__ bs = prm.p[7];
  const float* __restrict__ pts = prm.p[8];
  const float* __restrict__ pb = prm.p[9];
  const float* __restrict__ w4 = prm.p[10];
  const float* __restrict__ b4 = prm.p[11];
  const float* __restrict__ w5 = prm.p[12];
  const float* __restrict__ b5 = prm.p[13];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, B - row0);

  // 1. the block's rows of x (rows past the batch end read as 0)
  const float* xb = x + (size_t)row0 * D;
  for (int i = tid; i < kRows * D; i += kThreads) xs[i] = i < nrows * D ? xb[i] : 0.0f;
  __syncthreads();

  // 2. a1 = x w1^T + b1: one warp per output, lanes over the inputs
  for (int j = warp; j < kH1; j += kWarps) {
    const float* wr = w1 + (size_t)j * D;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
    for (int i = lane; i < D; i += 32) {
      const float w = wr[i];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] += xs[r * D + i] * w;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = warp_sum(acc[r]);
    if (lane == 0) {
      for (int r = 0; r < nrows; ++r) {
        const float a = acc[r] + b1[j];
        a1s[r][j] = a;
        h1s[r][j] = gelu(a);
        so.h1[(size_t)(row0 + r) * kH1 + j] = h1s[r][j];
      }
    }
  }
  __syncthreads();

  // 3. a2 = h1 w2^T + b2: one thread per (row, output)
  if (tid < kRows * kH2) {
    const int r = tid / kH2, j = tid % kH2;
    if (r < nrows) {
      float s = 0.0f;
      for (int i = 0; i < kH1; ++i) s += h1s[r][i] * w2[j * kH1 + i];
      const float a = s + b2[j];
      a2s[r][j] = a;
      h2s[r][j] = gelu(a);
      so.h2[(size_t)(row0 + r) * kH2 + j] = h2s[r][j];
    }
  }
  __syncthreads();

  // 4. the mean and scale heads: one thread per (head, row, latent)
  if (tid < 2 * kRows * L) {
    const int head = tid / (kRows * L);
    const int r = (tid / L) % kRows, l = tid % L;
    if (r < nrows) {
      const float* w = head == 0 ? wm : ws;
      float s = 0.0f;
      for (int i = 0; i < kH2; ++i) s += h2s[r][i] * w[l * kH2 + i];
      if (head == 0) rs[r].mue[l] = s + bm[l];
      else rs[r].se[l] = s + bs[l];
    }
  }
  __syncthreads();

  // 5. the latent chain and the kl, one thread per row
  if (tid < nrows) {
    Row& R = rs[tid];
    for (int l = 0; l < L; ++l) R.e[l] = eps[(size_t)(row0 + tid) * L + l];
    latent_fwd(R, L, k);
    for (int l = 0; l < L; ++l) zs[tid][l] = R.z[l];
  }
  __syncthreads();

  // 6. the gyroplane distances -> gelu(dist + bias): one thread per (row, plane)
  if (tid < kRows * kP) {
    const int r = tid / kP, p = tid % kP;
    if (r < nrows) {
      float z2 = 0.0f, p2 = 0.0f, zp = 0.0f;
      for (int l = 0; l < L; ++l) {
        const float pv = pts[p * L + l];
        z2 += zs[r][l] * zs[r][l];
        p2 += pv * pv;
        zp += zs[r][l] * pv;
      }
      Gyro g;
      const float a = gyro_fwd(z2, p2, zp, k, g) + pb[p];
      a3s[r][p] = a;
      hds[r][p] = gelu(a);
      so.hd[(size_t)(row0 + r) * kP + p] = hds[r][p];
    }
  }
  __syncthreads();

  // 7. a4 = hd w4^T + b4: one thread per (row, output)
  {
    const int r = tid / kH1, j = tid % kH1;
    if (r < nrows) {
      float s = 0.0f;
      for (int i = 0; i < kH2; ++i) s += hds[r][i] * w4[j * kH2 + i];
      const float a = s + b4[j];
      a4s[r][j] = a;
      h4s[r][j] = gelu(a);
      so.h4[(size_t)(row0 + r) * kH1 + j] = h4s[r][j];
    }
  }
  __syncthreads();

  // 8. per pixel: the logit, the RelaxedBernoulli(T = 1) log density and
  //    d loss / d logit
  float lp_acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) lp_acc[r] = 0.0f;
  for (int i = tid; i < D; i += kThreads) {
    const float* wr = w5 + (size_t)i * kH1;
    float o[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) o[r] = 0.0f;
    for (int j = 0; j < kH1; ++j) {
      const float w = wr[j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) o[r] += h4s[r][j] * w;
    }
    const float bias = b5[i];
    for (int r = 0; r < nrows; ++r) {
      const float xhat = 1.0f / (1.0f + expf(-(o[r] + bias)));
      const float pc = minn(maxn(xhat, kProbLo), kProbHi);
      const float logits = logf(pc) - log1pf(-pc);
      const float xc = minn(maxn(xs[r * D + i], kTiny), kXHi);
      const float y = logf(xc) - log1pf(-xc);
      const float diff = logits - y;
      const float base = diff - 2.0f * softplus(diff);
      lp_acc[r] += base - logf(xc) - log1pf(-xc);
      const float d_diff = k.d_lp - 2.0f * k.d_lp * sigmoid(diff);
      const float d_pc = d_diff / pc + d_diff / (1.0f - pc);
      const float d_o = d_pc * clip_grad(xhat, kProbLo, kProbHi) * xhat * (1.0f - xhat);
      dos[r * D + i] = d_o;
      so.dout[(size_t)(row0 + r) * D + i] = d_o;
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float v = warp_sum(lp_acc[r]);
    if (lane == 0) red[warp][r] = v;
  }
  __syncthreads();
  if (tid < nrows) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += red[w][tid];
    so.rows[(size_t)(row0 + tid) * 2] = -s;
    so.rows[(size_t)(row0 + tid) * 2 + 1] = rs[tid].kl;
  }

  // 9. d a4 = (d logit w5) gelu'(a4): one thread per (row, unit), over the pixels
  {
    const int r = tid / kH1, j = tid % kH1;
    if (r < nrows) {
      float s = 0.0f;
      for (int i = 0; i < D; ++i) s += dos[r * D + i] * w5[(size_t)i * kH1 + j];
      const float d = s * gelu_grad(a4s[r][j]);
      da4s[r][j] = d;
      so.da4[(size_t)(row0 + r) * kH1 + j] = d;
    }
  }
  __syncthreads();

  // 10. d a3 = (d a4 w4) gelu'(a3), then the epilogue's backward: one
  //     thread per (row, plane); the per-row gradient of the points
  if (tid < kRows * kP) {
    const int r = tid / kP, p = tid % kP;
    if (r < nrows) {
      float s = 0.0f;
      for (int j = 0; j < kH1; ++j) s += da4s[r][j] * w4[j * kH2 + p];
      const float d_a3 = s * gelu_grad(a3s[r][p]);
      so.da3[(size_t)(row0 + r) * kP + p] = d_a3;
      float z2 = 0.0f, p2 = 0.0f, zp = 0.0f;
      for (int l = 0; l < L; ++l) {
        const float pv = pts[p * L + l];
        z2 += zs[r][l] * zs[r][l];
        p2 += pv * pv;
        zp += zs[r][l] * pv;
      }
      Gyro g;
      gyro_fwd(z2, p2, zp, k, g);
      float d_zp, d_z2, d_p2;
      gyro_bwd(g, z2, p2, zp, d_a3, k, &d_zp, &d_z2, &d_p2);
      dzp[r][p] = d_zp;
      dz2[r][p] = d_z2;
      float* gp = so.gpts + ((size_t)(row0 + r) * kP + p) * L;
      for (int l = 0; l < L; ++l) gp[l] = 2.0f * d_p2 * pts[p * L + l] + d_zp * zs[r][l];
    }
  }
  __syncthreads();

  // 11. the latent chain's backward, one thread per row
  if (tid < nrows) {
    Row& R = rs[tid];
    float d_z[kMaxLatent], d_mu_e[kMaxLatent], d_s_e[kMaxLatent];
    float sz2 = 0.0f;
    for (int p = 0; p < kP; ++p) sz2 += dz2[tid][p];
    for (int l = 0; l < L; ++l) {
      float s = 0.0f;
      for (int p = 0; p < kP; ++p) s += dzp[tid][p] * pts[p * L + l];
      d_z[l] = s + 2.0f * R.z[l] * sz2;
    }
    latent_bwd(R, d_z, L, k, d_mu_e, d_s_e);
    for (int l = 0; l < L; ++l) {
      dmue[tid][l] = d_mu_e[l];
      dse[tid][l] = d_s_e[l];
      so.dmue[(size_t)(row0 + tid) * L + l] = d_mu_e[l];
      so.dse[(size_t)(row0 + tid) * L + l] = d_s_e[l];
    }
  }
  __syncthreads();

  // 12. d a2 = (d mu_e wm + d sigma_e ws) gelu'(a2): one thread per (row, unit)
  if (tid < kRows * kH2) {
    const int r = tid / kH2, j = tid % kH2;
    if (r < nrows) {
      float sm = 0.0f, ss = 0.0f;
      for (int l = 0; l < L; ++l) {
        sm += dmue[r][l] * wm[l * kH2 + j];
        ss += dse[r][l] * ws[l * kH2 + j];
      }
      const float d = (sm + ss) * gelu_grad(a2s[r][j]);
      da2s[r][j] = d;
      so.da2[(size_t)(row0 + r) * kH2 + j] = d;
    }
  }
  __syncthreads();

  // 13. d a1 = (d a2 w2) gelu'(a1): one thread per (row, unit)
  {
    const int r = tid / kH1, j = tid % kH1;
    if (r < nrows) {
      float s = 0.0f;
      for (int i = 0; i < kH2; ++i) s += da2s[r][i] * w2[i * kH1 + j];
      so.da1[(size_t)(row0 + r) * kH1 + j] = s * gelu_grad(a1s[r][j]);
    }
  }
}

// ---- 2. weight and bias gradients: out[m, n] = sum_b a[b, m] b[b, n] ------

struct Job {
  const float* a;  // (B, M), or null for a row of ones (M = 1)
  const float* b;  // (B, N)
  float* w;        // (M, N)
  float* bias;     // (M): sum_b a[b, m], or null
  int M, N, tiles_n, tile0;
};

struct Jobs {
  Job j[kJobs];
  int n_tiles;
};

__global__ void __launch_bounds__(kThreads)
train_grad_kernel(Jobs jobs, int B, float* __restrict__ partials) {
  __shared__ float as[kTile][kTile + 1];
  __shared__ float bsm[kTile][kTile + 1];
  __shared__ float red[kThreads];
  int ji = 0;
  while (ji + 1 < kJobs && (int)blockIdx.x >= jobs.j[ji + 1].tile0) ++ji;
  const Job jb = jobs.j[ji];
  const int t = blockIdx.x - jb.tile0;
  const int m0 = (t / jb.tiles_n) * kTile, n0 = (t % jb.tiles_n) * kTile;
  const int ncols = jb.N + (jb.bias ? 1 : 0);  // column N is the bias (b = 1)
  const int tm = threadIdx.x >> 3, tn = (threadIdx.x & 7) * 4;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int b0 = 0; b0 < B; b0 += kTile) {
    for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
      const int bb = e / kTile, cc = e % kTile, b = b0 + bb;
      const int mm = m0 + cc, nn = n0 + cc;
      float av = 0.0f, bv = 0.0f;
      if (b < B) {
        if (mm < jb.M) av = jb.a ? jb.a[(size_t)b * jb.M + mm] : 1.0f;
        if (nn < jb.N) bv = jb.b[(size_t)b * jb.N + nn];
        else if (nn < ncols) bv = 1.0f;
      }
      as[bb][cc] = av;
      bsm[bb][cc] = bv;
    }
    __syncthreads();
    const int nb = min(kTile, B - b0);
    for (int bb = 0; bb < nb; ++bb) {
      const float a = as[bb][tm];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] += a * bsm[bb][tn + q];
    }
    __syncthreads();
  }
  float g2 = 0.0f;
  const int m = m0 + tm;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int n = n0 + tn + q;
    if (m < jb.M && n < ncols) {
      if (n < jb.N) jb.w[(size_t)m * jb.N + n] = acc[q];
      else jb.bias[m] = acc[q];
      g2 += acc[q] * acc[q];
    }
  }
  red[threadIdx.x] = g2;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if ((int)threadIdx.x < half) red[threadIdx.x] += red[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) partials[blockIdx.x] = red[0];
}

// ---- 3. one block: loss means, the guard, count and the bias corrections

__global__ void __launch_bounds__(kThreads)
train_finalize_kernel(const float* __restrict__ rows, int B, float beta,
                      const float* __restrict__ partials, int n_part, int* count, float b1,
                      float b2, float* __restrict__ scal, float* __restrict__ metrics) {
  __shared__ float st[4][kThreads];
  float tot = 0.0f, rec = 0.0f, kl = 0.0f, g2 = 0.0f;
  for (int i = threadIdx.x; i < B; i += kThreads) {
    const float rr = rows[2 * (size_t)i], kk = rows[2 * (size_t)i + 1];
    tot += rr + beta * kk;
    rec += rr;
    kl += kk;
  }
  for (int i = threadIdx.x; i < n_part; i += kThreads) g2 += partials[i];
  st[0][threadIdx.x] = tot;
  st[1][threadIdx.x] = rec;
  st[2][threadIdx.x] = kl;
  st[3][threadIdx.x] = g2;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if ((int)threadIdx.x < half) {
      for (int q = 0; q < 4; ++q) st[q][threadIdx.x] += st[q][threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float n = (float)B;
    const float lt = st[0][0] / n, rm = st[1][0] / n, km = st[2][0] / n;
    const bool ok = isfinite(lt) && isfinite(st[3][0]);
    const int cnt = *count + 1;  // advances on a skipped step too, as JAX's K3
    *count = cnt;
    const float cf = (float)cnt;
    scal[0] = 1.0f - powf(b1, cf);
    scal[1] = 1.0f - powf(b2, cf);
    scal[2] = ok ? 1.0f : 0.0f;
    metrics[0] = lt;
    metrics[1] = rm;
    metrics[2] = km;
    metrics[3] = ok ? 0.0f : 1.0f;
  }
}

// ---- 4. the Riemannian Adam update, in place where ok ---------------------

struct Upd {
  float* p[kNParams];
  float* m[kNParams];
  float* v[kNParams];
  const float* g;         // the gradients, packed in params order
  int off[kNParams + 1];  // element offsets of the 14 tensors
};

__global__ void __launch_bounds__(kThreads)
train_update_kernel(Upd u, int L, const float* __restrict__ scal, float lr, float b1,
                    float omb1, float b2, float omb2, float adam_eps, Consts k) {
  if (scal[2] == 0.0f) return;  // not ok: params and moments stay as they are
  const float bc1 = scal[0], bc2 = scal[1];
  const int n_total = u.off[kNParams];
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < n_total) {
    int s = 0;
    while (idx >= u.off[s + 1]) ++s;
    if (s == kPts) return;
    const int e = idx - u.off[s];
    const float p = u.p[s][e], g = u.g[idx], m = u.m[s][e], v = u.v[s][e];
    const float nm = b1 * m + omb1 * g;
    const float nv = b2 * v + omb2 * g * g;
    u.p[s][e] = p - lr * (nm / bc1) / (sqrtf(nv / bc2) + adam_eps);
    u.m[s][e] = nm;
    u.v[s][e] = nv;
    return;
  }
  const int r = idx - n_total;  // one row of the gyroplane points
  if (r >= kP) return;
  float* pp = u.p[kPts] + r * L;
  float* mp = u.m[kPts] + r * L;
  float* vp = u.v[kPts] + r * L;
  const float* gp = u.g + u.off[kPts] + r * L;
  float p[kMaxLatent], nm[kMaxLatent], uu[kMaxLatent], second[kMaxLatent];
  float np[kMaxLatent], neg_p[kMaxLatent], t1[kMaxLatent], t2[kMaxLatent], t3[kMaxLatent];
  float gyr[kMaxLatent];
  Mob ms;
  float p2 = 0.0f;
  for (int l = 0; l < L; ++l) {
    p[l] = pp[l];
    p2 += p[l] * p[l];
  }
  const float lam = 2.0f / maxn(1.0f - k.c * p2, kMinNorm);
  float su = 0.0f;
  for (int l = 0; l < L; ++l) {
    const float g_r = gp[l] / (lam * lam);
    nm[l] = b1 * mp[l] + omb1 * g_r;
    const float nv = b2 * vp[l] + omb2 * (lam * lam) * g_r * g_r;
    vp[l] = nv;
    const float dir = (nm[l] / bc1) / (sqrtf(nv / bc2) + adam_eps);
    uu[l] = -lr * dir;
    su += uu[l] * uu[l];
  }
  const float u_n = sqrtf(maxn(su, kMinNorm2));
  const float tu = tanh_c(k.sqrt_c * lam * u_n / 2.0f);
  for (int l = 0; l < L; ++l) second[l] = tu * uu[l] / (k.sqrt_c * u_n);
  mob_fwd(p, second, np, L, k, ms);
  float s = 0.0f;
  for (int l = 0; l < L; ++l) s += np[l] * np[l];
  const float f = minn(k.max_norm / sqrtf(maxn(s, kMinNorm2)), 1.0f);
  float np2 = 0.0f;
  for (int l = 0; l < L; ++l) {
    np[l] = np[l] * f;
    np2 += np[l] * np[l];
    neg_p[l] = -p[l];
  }
  // gyr[new_p, -p] m = -(new_p (+) -p) (+) (new_p (+) (-p (+) m))
  mob_fwd(np, neg_p, t1, L, k, ms);
  for (int l = 0; l < L; ++l) t1[l] = -t1[l];
  mob_fwd(neg_p, nm, t2, L, k, ms);
  mob_fwd(np, t2, t3, L, k, ms);
  mob_fwd(t1, t3, gyr, L, k, ms);
  const float lam_new = 2.0f / maxn(1.0f - k.c * np2, kMinNorm);
  for (int l = 0; l < L; ++l) {
    pp[l] = np[l];
    mp[l] = gyr[l] * lam / lam_new;
  }
}

// ---- the scratch layout ---------------------------------------------------

struct Layout {
  size_t rows, h1, da1, h2, da2, dmue, dse, gpts, da3, hd, h4, da4, dout;
  size_t grads, partials, scal, total;
  int sizes[kNParams];
  int off[kNParams + 1];
};

Layout make_layout(int B, int D, int L, int n_tiles) {
  Layout y;
  const int sizes[kNParams] = {kH1 * D, kH1, kH2 * kH1, kH2, L * kH2, L, L * kH2, L,
                               kP * L, kP, kH1 * kH2, kH1, D * kH1, D};
  y.off[0] = 0;
  for (int i = 0; i < kNParams; ++i) {
    y.sizes[i] = sizes[i];
    y.off[i + 1] = y.off[i] + sizes[i];
  }
  size_t o = 0;
  auto take = [&o](size_t n) {
    const size_t at = o;
    o += (n + 31) / 32 * 32;  // 128-byte aligned segments
    return at;
  };
  const size_t b = (size_t)B;
  y.rows = take(b * 2);
  y.h1 = take(b * kH1);
  y.da1 = take(b * kH1);
  y.h2 = take(b * kH2);
  y.da2 = take(b * kH2);
  y.dmue = take(b * L);
  y.dse = take(b * L);
  y.gpts = take(b * kP * L);
  y.da3 = take(b * kP);
  y.hd = take(b * kP);
  y.h4 = take(b * kH1);
  y.da4 = take(b * kH1);
  y.dout = take(b * D);
  y.grads = take((size_t)y.off[kNParams]);
  y.partials = take((size_t)n_tiles);
  y.scal = take(4);
  y.total = o;
  return y;
}

void set_job(Job& j, const float* a, const float* b, float* w, float* bias, int M, int N,
             int& tile0) {
  j.a = a;
  j.b = b;
  j.w = w;
  j.bias = bias;
  j.M = M;
  j.N = N;
  const int ncols = N + (bias ? 1 : 0);
  j.tiles_n = (ncols + kTile - 1) / kTile;
  j.tile0 = tile0;
  tile0 += ((M + kTile - 1) / kTile) * j.tiles_n;
}

// the eight gradient jobs over the scratch layout y at base; the gradients
// are packed there in params order and layout
Jobs build_jobs(const float* x, float* base, const Layout& y, int D, int L) {
  Jobs js;
  float* g = base + y.grads;
  auto gp = [&](int i) { return g + y.off[i]; };
  int t = 0;
  set_job(js.j[0], base + y.da1, x, gp(0), gp(1), kH1, D, t);
  set_job(js.j[1], base + y.da2, base + y.h1, gp(2), gp(3), kH2, kH1, t);
  set_job(js.j[2], base + y.dmue, base + y.h2, gp(4), gp(5), L, kH2, t);
  set_job(js.j[3], base + y.dse, base + y.h2, gp(6), gp(7), L, kH2, t);
  set_job(js.j[4], nullptr, base + y.gpts, gp(8), nullptr, 1, kP * L, t);
  set_job(js.j[5], nullptr, base + y.da3, gp(9), nullptr, 1, kP, t);
  set_job(js.j[6], base + y.da4, base + y.hd, gp(10), gp(11), kH1, kP, t);
  set_job(js.j[7], base + y.dout, base + y.h4, gp(12), gp(13), D, kH1, t);
  js.n_tiles = t;
  return js;
}

int tiles(int M, int ncols) { return ((M + kTile - 1) / kTile) * ((ncols + kTile - 1) / kTile); }

// blocks of train_grad_kernel: the tiles of build_jobs' eight jobs
int count_tiles(int D, int L) {
  return tiles(kH1, D + 1) + tiles(kH2, kH1 + 1) + 2 * tiles(L, kH2 + 1) + tiles(1, kP * L) +
         tiles(1, kP) + tiles(kH1, kP + 1) + tiles(D, kH1 + 1);
}

Layout full_layout(int B, int D, int L) { return make_layout(B, D, L, count_tiles(D, L)); }

}  // namespace

// floats of scratch the launch needs for (B, D, L)
extern "C" long flagship_train_scratch_floats(int B, int D, int L) {
  return (long)full_layout(B, D, L).total;
}

// x (B, D), eps (B, L), ops: a host array of 42 device pointers (the 14
// params in _params_tuple's order and nn.Linear (out, in) layout, then
// their exp_avg, then their exp_avg_sq), count: a device int32, scratch:
// flagship_train_scratch_floats(B, D, L) floats, metrics (4,): contiguous
// f32 on the current device. Updates params, moments and count in place
// and writes (loss_total, recon, kl, skipped). Returns the cudaError_t of
// the launches (0 = success).
extern "C" int flagship_train_launch(const void* x, const void* eps, void* const* ops,
                                     void* count, void* scratch, void* metrics, int B, int D,
                                     int L, double c, double beta, double prior_scale,
                                     double lr, double b1, double b2, double adam_eps,
                                     void* stream) {
  if (B <= 0 || D <= 0 || L <= 0 || L > kMaxLatent) return (int)cudaErrorInvalidValue;
  const Layout y = full_layout(B, D, L);
  float* base = static_cast<float*>(scratch);
  const float* xf = static_cast<const float*>(x);
  Params prm;
  Upd upd;
  for (int i = 0; i < kNParams; ++i) {
    prm.p[i] = static_cast<const float*>(ops[i]);
    upd.p[i] = static_cast<float*>(ops[i]);
    upd.m[i] = static_cast<float*>(ops[kNParams + i]);
    upd.v[i] = static_cast<float*>(ops[2 * kNParams + i]);
  }
  for (int i = 0; i <= kNParams; ++i) upd.off[i] = y.off[i];
  upd.g = base + y.grads;
  RowsOut so;
  so.rows = base + y.rows;
  so.h1 = base + y.h1;
  so.da1 = base + y.da1;
  so.h2 = base + y.h2;
  so.da2 = base + y.da2;
  so.dmue = base + y.dmue;
  so.dse = base + y.dse;
  so.gpts = base + y.gpts;
  so.da3 = base + y.da3;
  so.hd = base + y.hd;
  so.h4 = base + y.h4;
  so.da4 = base + y.da4;
  so.dout = base + y.dout;

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

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * 2 * (size_t)kRows * D;
  if (smem > 32 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        train_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  train_rows_kernel<<<(B + kRows - 1) / kRows, kThreads, smem, s>>>(
      xf, static_cast<const float*>(eps), prm, so, B, D, L, k);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const Jobs js = build_jobs(xf, base, y, D, L);
  train_grad_kernel<<<js.n_tiles, kThreads, 0, s>>>(js, B, base + y.partials);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  train_finalize_kernel<<<1, kThreads, 0, s>>>(base + y.rows, B, k.beta, base + y.partials,
                                                js.n_tiles, static_cast<int*>(count),
                                                (float)b1, (float)b2, base + y.scal,
                                                static_cast<float*>(metrics));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n_upd = y.off[kNParams] + kP;
  train_update_kernel<<<(n_upd + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      upd, L, base + y.scal, (float)lr, (float)b1, (float)(1.0 - b1), (float)b2,
      (float)(1.0 - b2), (float)adam_eps, k);
  return (int)cudaGetLastError();
}
