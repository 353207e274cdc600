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
// lower the autodiff's matmuls. Here, three launches, each starting while
// the one before drains (programmatic dependent launch):
//   1. train_rows_kernel: clusters of 8 CTAs over 18 batch rows each, the
//      weights cut across a cluster's CTAs and held in shared memory (K2's
//      forward, flagship_common.cuh), then the backward down to per-row
//      activation gradients: each CTA's share of d logit w5 over its pixels,
//      summed across the cluster in rank order over distributed shared
//      memory, then (redundantly in every CTA) d a4, d a3 with the 16
//      epilogues' backward from the forward's values kept in registers,
//      beside them the two densities' backward, the latent
//      chain's backward one lane per row, d a2, and d a1 for the CTA's own
//      8 units. The per-row gradients and activations the weight gradients
//      need go to a scratch in device memory, each written by one CTA.
//   2. train_grad_kernel: every weight and bias gradient as a sum over the
//      batch, 32 x 32 output tiles per block of 512 threads: two groups of
//      256 take alternate chunks of 32 rows, each from a ring of 4 chunks
//      in shared memory filled by cp.async (at B = 256 every row is in
//      flight at once), and add their sums in a fixed order; per-block
//      partial sums of g^2. One block takes the gyroplane points: their
//      gradient (column sums) and then their Riemannian step, computed
//      before the guard is known, beside the other tiles.
//      The block that finishes last (a ticket counter picks it) sums the
//      partials and the loss terms in index order: the loss means, sum g^2,
//      ok, count + 1 (written back) and the bias corrections, in f32. The
//      ticket only picks the block; the order of every sum is fixed, so a
//      step gives the same bits every run.
//   3. train_update_kernel, where ok: Adam on four consecutive elements of
//      one of the 13 Euclidean tensors per thread (each block within one
//      tensor; each thread reads its elements before it writes them, so
//      the update is in place), and the points' step copied in.
// Plain f32 on the CUDA cores, built with -fmad=false: each product and sum
// rounds on its own (flagship_common.cuh says in which order).

#include "flagship_common.cuh"
#include "point_step.cuh"

namespace {

using namespace flagship;

constexpr int kTile = 32;     // weight-gradient tile (and its b chunk)
constexpr int kGroups = 2;    // thread groups of a gradient block, over alternate b chunks
constexpr int kGroupThreads = 256;
constexpr int kGradThreads = kGroups * kGroupThreads;
constexpr int kStages = 4;    // b chunks in flight per group
constexpr size_t kGradSmem = sizeof(float) * 2 * kGroups * kStages * kTile * kTile;
constexpr int kJobs = 8;
constexpr int kUpdThreads = 256;
constexpr int kUpdRun = 4;    // consecutive elements per update thread

// ---- the backward of the chain's pieces --------------------------------------

// d dist -> (d zp, d z2, d p2) of the epilogue g
__device__ void gyro_bwd(const Gyro& g, float d_dist, const Consts& k, float* d_zp_out,
                         float* d_z2_out, float* d_p2_out) {
  const float z2 = g.z2, p2 = g.p2, zp = g.zp;
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

// d_z (in: the gyroplanes' cotangent of z), G (the densities' backward) ->
// d mu_e, d sigma_e (the heads)
__device__ void latent_bwd(const Row& R, float* d_z, const DensGrad& G, int L, const Consts& k,
                           float* d_mue, float* d_se) {
  float d_scale[kMaxLatent];
  float d_mu2 = G.d_mu2;
  for (int l = 0; l < L; ++l) {
    d_z[l] = d_z[l] + G.d_z[0][l] + G.d_z[1][l];
    d_scale[l] = G.d_scale[l];
  }

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
    d_mu[l] = d_mu[l] + G.d_locq[l] + 2.0f * R.mu[l] * d_mu2;
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

// ---- 1. one cluster per kRows rows: the forward, then the backward to
// per-row gradients --------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
train_rows_kernel(const float* __restrict__ x, const float* __restrict__ eps, Params prm,
                  RowsOut so, int B, int D, int L, Consts k) {
  Shared& S = *reinterpret_cast<Shared*>(hopper::dyn_smem());
  const Slices v = carve(S, B, D, true);
  Gyro g;
  cluster_forward<true>(S, v, x, eps, prm, so, D, L, k, g);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = v.rank, row0 = v.row0, nrows = v.nrows;

  // 9. this CTA's share of d logit w5 over its pixels: three rows per thread
  if (tid < kRows / 3 * kH1) {
    const int j = tid & 63, r = 3 * (tid >> 6);
    const float* d0 = v.dos + r * v.p5r;
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
    for (int i = 0; i < v.npix; ++i) {
      const float w = v.w5s[i * kW5Stride + j];
      s0 += d0[i] * w;
      s1 += d0[v.p5r + i] * w;
      s2 += d0[2 * v.p5r + i] * w;
    }
    S.da4p[r][j] = s0;
    S.da4p[r + 1][j] = s1;
    S.da4p[r + 2][j] = s2;
  }
  hopper::cluster_sync();
  // each row's recon (rank 0), and d a4 = (d logit w5) gelu'(a4) in every
  // CTA: the CTAs' shares added in rank order
  if (rank == 0 && tid < nrows) {
    float s = 0.0f;
    for (int o = 0; o < kCluster; ++o) s += *hopper::cluster_map(&S.recp[tid], (uint32_t)o);
    so.rows[(size_t)(row0 + tid) * 2] = -s;
    so.rows[(size_t)(row0 + tid) * 2 + 1] = S.logd[tid][0] - S.logd[tid][1];
  }
  for (int e = tid; e < kRows * kH1; e += kThreads) {
    const int r = e >> 6, j = e & 63;
    float part[kCluster];
#pragma unroll
    for (int o = 0; o < kCluster; ++o) part[o] = *hopper::cluster_map(&S.da4p[r][j], (uint32_t)o);
    float s = 0.0f;
#pragma unroll
    for (int o = 0; o < kCluster; ++o) s += part[o];
    const float d = s * gelu_grad(S.a4[r][j]);
    S.da4[r][j] = d;
    if (rank == 0 && r < nrows) so.da4[(size_t)(row0 + r) * kH1 + j] = d;
  }
  hopper::cluster_arrive();  // done reading the other CTAs' shared memory
  __syncthreads();

  // 10. d a3 = (d a4 w4) gelu'(a3) and the epilogue's backward, one thread
  //     per (row, plane), from the forward's values in g; the per-row
  //     gradient of the points. Beside them, one thread per (row,
  //     density): the two log densities' backward (cotangent +-beta / B).
  if (tid < kRows * kP) {
    const int r = tid >> 4, p = tid & 15;
    float s = 0.0f;
    for (int j = 0; j < kH1; ++j) s += S.da4[r][j] * S.w4[j][p];
    const float d_a3 = s * gelu_grad(S.a3[r][p]);
    float d_zp, d_z2, d_p2;
    gyro_bwd(g, d_a3, k, &d_zp, &d_z2, &d_p2);
    S.dzp[r][p] = d_zp;
    S.dz2[r][p] = d_z2;
    if (rank == 0 && r < nrows) {
      so.da3[(size_t)(row0 + r) * kP + p] = d_a3;
      float* gp = so.gpts + ((size_t)(row0 + r) * kP + p) * L;
      for (int l = 0; l < L; ++l) gp[l] = 2.0f * d_p2 * S.pts[p * L + l] + d_zp * S.z[r][l];
    }
  } else if (tid < kRows * kP + 2 * kRows) {
    const int r = (tid - kRows * kP) >> 1, prior = tid & 1;
    const Row& R = S.rs[r];
    float sc[kMaxLatent], d_loc[kMaxLatent], d_loc2, d_sc[kMaxLatent], d_z[kMaxLatent];
    for (int l = 0; l < L; ++l) sc[l] = prior ? k.prior_scale : R.scale[l];
    wn_bwd(S.wn[r][prior], sc, R.z, prior ? -k.g_kl : k.g_kl, L, k, d_loc, &d_loc2, d_sc, d_z);
    DensGrad& G = S.dg[r];
    for (int l = 0; l < L; ++l) G.d_z[prior][l] = d_z[l];
    if (!prior) {
      for (int l = 0; l < L; ++l) {
        G.d_locq[l] = d_loc[l];
        G.d_scale[l] = d_sc[l];
      }
      G.d_mu2 = d_loc2;
    }
  }
  __syncthreads();

  // 11. the latent chain's backward, one lane per row
  if (tid < kRows) {
    const Row& R = S.rs[tid];
    float d_z[kMaxLatent], d_mu_e[kMaxLatent], d_s_e[kMaxLatent];
    float sz2 = 0.0f;
    for (int p = 0; p < kP; ++p) sz2 += S.dz2[tid][p];
    for (int l = 0; l < L; ++l) {
      float s = 0.0f;
      for (int p = 0; p < kP; ++p) s += S.dzp[tid][p] * S.pts[p * L + l];
      d_z[l] = s + 2.0f * R.z[l] * sz2;
    }
    latent_bwd(R, d_z, S.dg[tid], L, k, d_mu_e, d_s_e);
    for (int l = 0; l < L; ++l) {
      S.dmue[tid][l] = d_mu_e[l];
      S.dse[tid][l] = d_s_e[l];
    }
    if (rank == 0 && tid < nrows) {
      for (int l = 0; l < L; ++l) {
        so.dmue[(size_t)(row0 + tid) * L + l] = d_mu_e[l];
        so.dse[(size_t)(row0 + tid) * L + l] = d_s_e[l];
      }
    }
  }
  __syncthreads();

  // 12. d a2 = (d mu_e wm + d sigma_e ws) gelu'(a2): one thread per (row, unit)
  if (tid < kRows * kH2) {
    const int r = tid >> 4, j = tid & 15;
    float sm = 0.0f, ss = 0.0f;
    for (int l = 0; l < L; ++l) {
      sm += S.dmue[r][l] * S.wm[l * kH2 + j];
      ss += S.dse[r][l] * S.ws[l * kH2 + j];
    }
    const float d = (sm + ss) * gelu_grad(S.a2[r][j]);
    S.da2[r][j] = d;
    if (rank == 0 && r < nrows) so.da2[(size_t)(row0 + r) * kH2 + j] = d;
  }
  __syncthreads();

  // 13. d a1 = (d a2 w2) gelu'(a1) for this CTA's 8 units
  if (tid < kRows * kUnits) {
    const int r = tid >> 3, u = tid & 7, j = rank * kUnits + u;
    float s = 0.0f;
    for (int i = 0; i < kH2; ++i) s += S.da2[r][i] * S.w2[i][j];
    if (r < nrows) so.da1[(size_t)(row0 + r) * kH1 + j] = s * gelu_grad(S.a1[r][u]);
  }
  hopper::launch_dependents();
  hopper::cluster_wait();  // no CTA leaves while another reads its shared memory
}

// ---- 2. weight and bias gradients, out[m, n] = sum_b a[b, m] b[b, n], the
// gyroplane points' step, and in the last block the finalize ----------------------

struct Job {
  const float* a;  // (B, M), or null for a row of ones (M = 1)
  const float* b;  // (B, N)
  float* w;        // (M, N)
  float* bias;     // (M): sum_b a[b, m], or null
  int M, N, tiles_n, tile0;
  bool points;     // the points' job: one block, column sums, then their step
};

struct Jobs {
  Job j[kJobs];
  int n_tiles;
};

struct Final {
  const float* rows;  // (B, 2)
  int* count;
  unsigned* ticket;   // 0 between launches
  float* scal;        // bias corrections and ok, for the update
  float* metrics;     // (loss_total, recon, kl, skipped)
  float beta, b1, b2;
  // the points' step: their params and moments, and where its result goes
  const float *pts, *pts_m, *pts_v;
  float* cand;        // (3, kP, L): new points, exp_avg, exp_avg_sq
  const float* lr;    // 0-d, in device memory: the controller writes it between steps
  float omb1, omb2, adam_eps;
};

__global__ void __launch_bounds__(kGradThreads)
train_grad_kernel(Jobs jobs, int B, int L, float* __restrict__ partials, Final fin, Consts k) {
  // per group of 256 threads, kStages chunks of 32 rows of both operands:
  // a ring in dynamic shared memory
  typedef float Ring[kStages][kTile][kTile];
  Ring* as = reinterpret_cast<Ring*>(hopper::dyn_smem());
  Ring* bsm = as + kGroups;
  __shared__ float red[kGradThreads / 32];
  __shared__ float gpts[kP * kMaxLatent];
  __shared__ bool last;
  int ji = 0;
  while (ji + 1 < kJobs && (int)blockIdx.x >= jobs.j[ji + 1].tile0) ++ji;
  const Job jb = jobs.j[ji];
  const int t = blockIdx.x - jb.tile0;
  const int m0 = (t / jb.tiles_n) * kTile, n0 = (t % jb.tiles_n) * kTile;
  // the bias: column N of the b operand (all ones) where N % 32 != 0, so
  // that it lies inside the last column tile; else one more sum per row
  // of the last column tile, kept by the threads at its first column
  const bool bias_col = jb.bias && jb.N % kTile != 0;
  const bool bias_sum = jb.bias && !bias_col && n0 + kTile == jb.N;
  const int ncols = jb.N + (bias_col ? 1 : 0);
  const int tid = threadIdx.x;
  hopper::grid_dependency_wait();  // the rows kernel's scratch

  float g2 = 0.0f;
  if (jb.points) {
    // the points' gradient, column sums: thread (part, j) sums rows b = part
    // mod parts of column j, then the parts add in order
    const int n = jb.N, parts = kGradThreads / n;
    float* psum = &as[0][0][0][0];
    if (tid < parts * n) {
      float s = 0.0f;
      for (int b = tid / n; b < B; b += parts) s += jb.b[(size_t)b * n + tid % n];
      psum[tid] = s;
    }
    __syncthreads();
    for (int j = tid; j < n; j += kGradThreads) {
      float s = 0.0f;
      for (int q = 0; q < parts; ++q) s += psum[q * n + j];
      jb.w[j] = s;
      gpts[j] = s;
      g2 += s * s;
    }
    __syncthreads();
    // their step, before the guard is known (the update kernel keeps it
    // only where ok); count + 1 as the finalize will write it
    if (tid < kP) {
      const float cf = (float)(*fin.count + 1);
      const float bc1 = 1.0f - powf(fin.b1, cf), bc2 = 1.0f - powf(fin.b2, cf);
      const int n = kP * L;
      const AdamScalars as{*fin.lr, fin.b1, fin.omb1, fin.b2, fin.omb2, fin.adam_eps};
      PointVecs<kMaxLatent> w;
      point_step(fin.pts + tid * L, fin.pts_m + tid * L, fin.pts_v + tid * L, gpts + tid * L, L,
                 as, bc1, bc2, k, w, fin.cand + tid * L, fin.cand + n + tid * L,
                 fin.cand + 2 * n + tid * L);
    }
  } else {
    // two groups of 256 threads take alternate chunks of 32 rows; each
    // thread sums a 1 x 4 strip of the 32 x 32 tile
    const int grp = tid / kGroupThreads, gt = tid % kGroupThreads;
    const int tm = gt >> 3, tn = (gt & 7) * 4;
    // rows [b0, b0 + 32) of both operands into the group's stage buf:
    // cp.async where the element exists, else the ones of a bias or null
    // operand, else 0
    auto stage = [&](int buf, int b0) {
      for (int e = gt; e < kTile * kTile; e += kGroupThreads) {
        const int bb = e >> 5, cc = e & 31, b = b0 + bb;
        const int mm = m0 + cc, nn = n0 + cc;
        float* ad = &as[grp][buf][bb][cc];
        float* bd = &bsm[grp][buf][bb][cc];
        if (b < B && mm < jb.M && jb.a) hopper::cp_async4(ad, jb.a + (size_t)b * jb.M + mm);
        else *ad = (b < B && mm < jb.M) ? 1.0f : 0.0f;
        if (b < B && nn < jb.N) hopper::cp_async4(bd, jb.b + (size_t)b * jb.N + nn);
        else *bd = (b < B && nn < ncols) ? 1.0f : 0.0f;
      }
    };
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float accb = 0.0f;  // the bias sum, where bias_sum and tn == 0
    const bool keeps_bias = bias_sum && tn == 0;
    const int n_chunks = (B + kTile - 1) / kTile;
    const int n_iter = (n_chunks + kGroups - 1) / kGroups;
    for (int q = 0; q < kStages - 1; ++q) {
      const int c = q * kGroups + grp;
      if (c < n_chunks) stage(q, c * kTile);
      hopper::cp_async_commit();
    }
    for (int q = 0; q < n_iter; ++q) {
      hopper::cp_async_wait<kStages - 2>();  // the group's chunk q has landed
      __syncthreads();                       // for every thread; chunk q - 1 is summed
      const int next = q + kStages - 1, cn = next * kGroups + grp;
      if (cn < n_chunks) stage(next % kStages, cn * kTile);
      hopper::cp_async_commit();
      if (q * kGroups + grp < n_chunks) {
        const int buf = q % kStages;
#pragma unroll 8
        for (int bb = 0; bb < kTile; ++bb) {
          const float a = as[grp][buf][bb][tm];
          const float4 bv = *reinterpret_cast<const float4*>(&bsm[grp][buf][bb][tn]);
          acc[0] += a * bv.x;
          acc[1] += a * bv.y;
          acc[2] += a * bv.z;
          acc[3] += a * bv.w;
          if (keeps_bias) accb += a;
        }
      }
    }
    hopper::cp_async_wait<0>();
    __syncthreads();
    // group 0's sums plus group 1's, in that order
    float* part = &as[0][0][0][0];
    if (grp == 1) {
#pragma unroll
      for (int q = 0; q < 4; ++q) part[gt * 4 + q] = acc[q];
      if (keeps_bias) part[kTile * kTile + tm] = accb;
    }
    __syncthreads();
    if (grp == 0) {
      const int m = m0 + tm;
      if (keeps_bias && m < jb.M) {
        const float v = accb + part[kTile * kTile + tm];
        jb.bias[m] = v;
        g2 += v * v;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float v = acc[q] + part[gt * 4 + q];
        const int n = n0 + tn + q;
        if (m < jb.M && n < ncols) {
          if (n < jb.N) jb.w[(size_t)m * jb.N + n] = v;
          else jb.bias[m] = v;
          g2 += v * v;
        }
      }
    }
  }
  g2 = warp_sum(g2);
  if ((tid & 31) == 0) red[tid >> 5] = g2;
  __syncthreads();
  if (tid == 0) {
    float s = 0.0f;
    for (int w = 0; w < kGradThreads / 32; ++w) s += red[w];
    partials[blockIdx.x] = s;
    __threadfence();
    last = atomicAdd(fin.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  hopper::launch_dependents();
  if (!last) return;

  // the last block: loss means, sum g^2, the guard, count and the bias
  // corrections, every sum in index order
  __threadfence();
  __shared__ float st[4][kGradThreads];
  float tot = 0.0f, rec = 0.0f, kl = 0.0f, gs = 0.0f;
  for (int i = tid; i < B; i += kGradThreads) {
    const float rr = fin.rows[2 * (size_t)i], kk = fin.rows[2 * (size_t)i + 1];
    tot += rr + fin.beta * kk;
    rec += rr;
    kl += kk;
  }
  for (int i = tid; i < (int)gridDim.x; i += kGradThreads) gs += __ldcg(partials + i);
  st[0][tid] = tot;
  st[1][tid] = rec;
  st[2][tid] = kl;
  st[3][tid] = gs;
  __syncthreads();
  for (int half = kGradThreads / 2; half > 0; half >>= 1) {
    if (tid < half) {
      for (int q = 0; q < 4; ++q) st[q][tid] += st[q][tid + half];
    }
    __syncthreads();
  }
  if (tid == 0) {
    const float n = (float)B;
    const float lt = st[0][0] / n, rm = st[1][0] / n, km = st[2][0] / n;
    const bool ok = isfinite(lt) && isfinite(st[3][0]);
    const int cnt = *fin.count + 1;  // advances on a skipped step too, as JAX's K3
    *fin.count = cnt;
    const float cf = (float)cnt;
    fin.scal[0] = 1.0f - powf(fin.b1, cf);
    fin.scal[1] = 1.0f - powf(fin.b2, cf);
    fin.scal[2] = ok ? 1.0f : 0.0f;
    fin.metrics[0] = lt;
    fin.metrics[1] = rm;
    fin.metrics[2] = km;
    fin.metrics[3] = ok ? 0.0f : 1.0f;
    *fin.ticket = 0u;
  }
}

// ---- 3. the Riemannian Adam update, in place where ok ----------------------------

struct Upd {
  float* p[kNParams];
  float* m[kNParams];
  float* v[kNParams];
  const float* g;              // the gradients, packed in params order
  const float* cand;           // the points' step (train_grad_kernel)
  int off[kNParams + 1];       // element offsets of the 14 tensors
  int blk[kNParams + 1];       // first block of each tensor (the points: one block)
};

__global__ void __launch_bounds__(kUpdThreads)
train_update_kernel(Upd u, const float* __restrict__ scal, const float* __restrict__ lr_ptr,
                    float b1, float omb1, float b2, float omb2, float adam_eps) {
  int s = 0;  // the block's tensor
  while (s + 1 < kNParams && (int)blockIdx.x >= u.blk[s + 1]) ++s;
  hopper::grid_dependency_wait();  // the gradients, the points' step and the guard
  if (scal[2] == 0.0f) return;  // not ok: params and moments stay as they are
  const int n = u.off[s + 1] - u.off[s];
  if (s == kPts) {  // the points' step, computed by train_grad_kernel
    for (int e = threadIdx.x; e < n; e += kUpdThreads) {
      u.p[s][e] = u.cand[e];
      u.m[s][e] = u.cand[n + e];
      u.v[s][e] = u.cand[2 * n + e];
    }
    return;
  }
  const float bc1 = scal[0], bc2 = scal[1], lr = *lr_ptr;
  const int e0 = ((blockIdx.x - u.blk[s]) * kUpdThreads + threadIdx.x) * kUpdRun;
  float p[kUpdRun], g[kUpdRun], m[kUpdRun], v[kUpdRun];
#pragma unroll
  for (int q = 0; q < kUpdRun; ++q) {  // every load before any store
    if (e0 + q < n) {
      p[q] = u.p[s][e0 + q];
      g[q] = u.g[u.off[s] + e0 + q];
      m[q] = u.m[s][e0 + q];
      v[q] = u.v[s][e0 + q];
    }
  }
#pragma unroll
  for (int q = 0; q < kUpdRun; ++q) {
    if (e0 + q < n) {
      const float nm = b1 * m[q] + omb1 * g[q];
      const float nv = b2 * v[q] + omb2 * g[q] * g[q];
      u.p[s][e0 + q] = p[q] - lr * (nm / bc1) / (sqrtf(nv / bc2) + adam_eps);
      u.m[s][e0 + q] = nm;
      u.v[s][e0 + q] = nv;
    }
  }
}

// ---- the scratch layout -------------------------------------------------------

struct Layout {
  size_t rows, h1, da1, h2, da2, dmue, dse, gpts, da3, hd, h4, da4, dout;
  size_t grads, partials, scal, ticket, cand, total;
  int off[kNParams + 1];
};

int tiles(int M, int ncols) { return ((M + kTile - 1) / kTile) * ((ncols + kTile - 1) / kTile); }

// blocks of train_grad_kernel: the tiles of build_jobs' eight jobs
int count_tiles(int D, int L) {
  return tiles(kH1, D) + tiles(kH2, kH1) + 2 * tiles(L, kH2) + 1 + tiles(1, kP) + tiles(kH1, kP) +
         tiles(D, kH1);
}

Layout make_layout(int B, int D, int L) {
  Layout y;
  const int sizes[kNParams] = {kH1 * D, kH1, kH2 * kH1, kH2, L * kH2, L, L * kH2, L,
                               kP * L, kP, kH1 * kH2, kH1, D * kH1, D};
  y.off[0] = 0;
  for (int i = 0; i < kNParams; ++i) y.off[i + 1] = y.off[i] + sizes[i];
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
  y.partials = take((size_t)count_tiles(D, L));
  y.scal = take(4);
  y.ticket = take(1);
  y.cand = take(3 * (size_t)kP * L);
  y.total = o;
  return y;
}

void set_job(Job& j, const float* a, const float* b, float* w, float* bias, int M, int N,
             int& tile0, bool points = false) {
  j.a = a;
  j.b = b;
  j.w = w;
  j.bias = bias;
  j.M = M;
  j.N = N;
  j.points = points;
  j.tiles_n = j.points ? 1 : (N + kTile - 1) / kTile;  // a bias needs no tile of its own
  j.tile0 = tile0;
  tile0 += j.points ? 1 : ((M + kTile - 1) / kTile) * j.tiles_n;
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
  set_job(js.j[4], nullptr, base + y.gpts, gp(8), nullptr, 1, kP * L, t, true);
  set_job(js.j[5], nullptr, base + y.da3, gp(9), nullptr, 1, kP, t);
  set_job(js.j[6], base + y.da4, base + y.hd, gp(10), gp(11), kH1, kP, t);
  set_job(js.j[7], base + y.dout, base + y.h4, gp(12), gp(13), D, kH1, t);
  js.n_tiles = t;
  return js;
}

}  // namespace

// floats of scratch the launch needs for (B, D, L); the wrapper zeroes it
// once (the ticket counter must start at 0; the kernel leaves it at 0)
extern "C" long flagship_train_scratch_floats(int B, int D, int L) {
  return (long)make_layout(B, D, L).total;
}

// bytes of dynamic shared memory the rows kernel takes for D pixels
extern "C" long flagship_train_smem_bytes(int D) { return (long)rows_smem_bytes(D, true); }

// clusters of the rows kernel the card holds at once for D pixels
extern "C" int flagship_train_max_clusters(int D) {
  return hopper::max_active_clusters(train_rows_kernel, kThreads, rows_smem_bytes(D, true),
                                     kCluster);
}

// x (B, D), eps (B, L), ops: a host array of 42 device pointers (the 14
// params in _params_tuple's order and nn.Linear (out, in) layout, then
// their exp_avg, then their exp_avg_sq), count: a device int32, scratch:
// flagship_train_scratch_floats(B, D, L) floats, zeroed before the first
// launch, metrics (4,), lr: a device f32 read by the kernels (so a CUDA
// graph of the step follows the value a controller writes there): contiguous
// on the current device. Updates params, moments and count in place and
// writes (loss_total, recon, kl, skipped). Returns the cudaError_t of the
// launches (0 = success).
extern "C" int flagship_train_launch(const void* x, const void* eps, void* const* ops,
                                     void* count, void* scratch, void* metrics, int B, int D,
                                     int L, double c, double beta, double prior_scale,
                                     const void* lr, double b1, double b2, double adam_eps,
                                     void* stream) {
  if (B <= 0 || D <= 0 || L <= 0 || L > kMaxLatent) return (int)cudaErrorInvalidValue;
  const Layout y = make_layout(B, D, L);
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
  upd.blk[0] = 0;
  for (int i = 0; i <= kNParams; ++i) upd.off[i] = y.off[i];
  for (int i = 0; i < kNParams; ++i) {
    const int n = y.off[i + 1] - y.off[i];
    const int per_block = kUpdThreads * kUpdRun;
    upd.blk[i + 1] = upd.blk[i] + (i == kPts ? 1 : (n + per_block - 1) / per_block);
  }
  upd.g = base + y.grads;
  upd.cand = base + y.cand;
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
  const Consts k = make_consts(c, beta, prior_scale, L, B);

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = rows_smem_bytes(D, true);
  static size_t allowed_rows[hopper::kMaxDevices] = {}, allowed_grad[hopper::kMaxDevices] = {};
  cudaError_t e = hopper::allow_smem(train_rows_kernel, smem, allowed_rows);
  if (e != cudaSuccess) return (int)e;
  const int clusters = (B + kRows - 1) / kRows;
  e = hopper::launch(train_rows_kernel, dim3(clusters * kCluster), dim3(kThreads), smem, s,
                     kCluster, xf, static_cast<const float*>(eps), prm, so, B, D, L, k);
  if (e != cudaSuccess) return (int)e;
  const Jobs js = build_jobs(xf, base, y, D, L);
  Final fin;
  fin.rows = base + y.rows;
  fin.count = static_cast<int*>(count);
  fin.ticket = reinterpret_cast<unsigned*>(base + y.ticket);
  fin.scal = base + y.scal;
  fin.metrics = static_cast<float*>(metrics);
  fin.beta = k.beta;
  fin.b1 = (float)b1;
  fin.b2 = (float)b2;
  fin.pts = static_cast<const float*>(ops[kPts]);
  fin.pts_m = static_cast<const float*>(ops[kNParams + kPts]);
  fin.pts_v = static_cast<const float*>(ops[2 * kNParams + kPts]);
  fin.cand = base + y.cand;
  fin.lr = static_cast<const float*>(lr);
  fin.omb1 = (float)(1.0 - b1);
  fin.omb2 = (float)(1.0 - b2);
  fin.adam_eps = (float)adam_eps;
  e = hopper::allow_smem(train_grad_kernel, kGradSmem, allowed_grad);
  if (e != cudaSuccess) return (int)e;
  e = hopper::launch(train_grad_kernel, dim3(js.n_tiles), dim3(kGradThreads), kGradSmem, s, 1, js,
                     B, L, base + y.partials, fin, k);
  if (e != cudaSuccess) return (int)e;
  e = hopper::launch(train_update_kernel, dim3(upd.blk[kNParams]), dim3(kUpdThreads), 0, s, 1,
                     upd, static_cast<const float*>(base + y.scal), static_cast<const float*>(lr),
                     (float)b1, (float)(1.0 - b1), (float)b2, (float)(1.0 - b2), (float)adam_eps);
  return (int)e;
}
