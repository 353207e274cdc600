// The flagship GyroplaneVAE's whole forward pass and ELBO for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   hyperbolic_vae_tpu/ops/flagship_fused.py::_flagship_kernel
// (launched by _fused_pallas). For a batch x (B, D), standard-normal draws
// eps (B, L) and the 14 parameter tensors of the flagship (hidden widths
// 64 and 16, 16 gyroplanes, L <= 8; nn.Linear's (out, in) layout) it writes
// (loss_total, mean recon, mean kl), with the formulas and clamps of
// _body: the tanh-GELU encoder, expmap0 and project, the softplus scale
// clamp, the truncated wrapped-normal rsample, the gyroplane distances
// (analytic epilogue, guarded-log arsinh), the decoder and sigmoid, the
// RelaxedBernoulli(T = 1) log density and both wrapped-normal log
// densities with the log(sinh(t)/t) series. It follows
// ops/flagship_fused.py::flagship_forward_torch of the port op by op.
//
// Bound on this card: at the flagship's training batch (B = 256, D = 784,
// L = 2) the op reads x (802,816 B) and the parameters (413,776 B), about
// 0.36 us at 3.35 TB/s, and does ~52.5 MFLOP of products plus a few MFLOP
// of elementwise work, ~0.9 us at 67 TFLOP/s f32. So it is bound by
// operations, and a launch of a few us is its real floor.
//
// Why the TPU design does not carry over: the TPU kernel keeps the 14
// parameter arrays and the whole batch resident in VMEM in one grid cell.
// The weights alone (404 KiB) exceed the 227 KB of shared memory of one
// H100 block, and one block would leave 131 SMs idle. So the weights are
// cut across the 8 CTAs of a thread block cluster, each CTA holding its
// slices of w1 and w5 in shared memory, and the batch across clusters of
// 18 rows (flagship_common.cuh says how). Then:
//   1. flagship_rows_kernel: one cluster per 18 rows -> (recon, kl) per row
//      into rows_out (B, 2);
//   2. flagship_mean_kernel (one block): the batch means in a fixed order,
//      so the loss is the same every run (atomics would make it vary).
// The second launch starts while the first drains (programmatic dependent
// launch) and waits for its results.

#include "flagship_common.cuh"

namespace {

using namespace flagship;

__global__ void __launch_bounds__(kThreads, 1)
flagship_rows_kernel(const float* __restrict__ x, const float* __restrict__ eps, Params prm,
                     float* __restrict__ rows_out, int B, int D, int L, Consts k) {
  Shared& S = *reinterpret_cast<Shared*>(hopper::dyn_smem());
  const Slices v = carve(S, B, D, false);
  Gyro g;
  cluster_forward<false>(S, v, x, eps, prm, RowsOut{}, D, L, k, g);
  hopper::launch_dependents();
  // each row's recon: the CTAs' shares added in rank order by rank 0
  hopper::cluster_sync();
  const int tid = threadIdx.x;
  if (v.rank == 0 && tid < v.nrows) {
    float s = 0.0f;
    for (int o = 0; o < kCluster; ++o) s += *hopper::cluster_map(&S.recp[tid], (uint32_t)o);
    rows_out[(size_t)(v.row0 + tid) * 2] = -s;
    rows_out[(size_t)(v.row0 + tid) * 2 + 1] = S.logd[tid][0] - S.logd[tid][1];
  }
  hopper::cluster_sync();  // no CTA leaves while rank 0 reads its shared memory
}

// One block: the batch means of (recon + beta kl, recon, kl), in a fixed order.
__global__ void __launch_bounds__(256)
flagship_mean_kernel(const float* __restrict__ rows, int B, float beta,
                     float* __restrict__ out) {
  __shared__ float st[3][256];
  hopper::grid_dependency_wait();
  float tot = 0.0f, rec = 0.0f, kl = 0.0f;
  for (int i = threadIdx.x; i < B; i += 256) {
    const float rr = rows[2 * (size_t)i], kk = rows[2 * (size_t)i + 1];
    tot += rr + beta * kk;
    rec += rr;
    kl += kk;
  }
  st[0][threadIdx.x] = tot;
  st[1][threadIdx.x] = rec;
  st[2][threadIdx.x] = kl;
  __syncthreads();
  for (int half = 128; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
      for (int q = 0; q < 3; ++q) st[q][threadIdx.x] += st[q][threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float n = (float)B;
    out[0] = st[0][0] / n;
    out[1] = st[1][0] / n;
    out[2] = st[2][0] / n;
  }
}

}  // namespace

// bytes of dynamic shared memory the rows kernel takes for D pixels
extern "C" long flagship_fused_smem_bytes(int D) { return (long)rows_smem_bytes(D, false); }

// clusters of the rows kernel the card holds at once for D pixels
extern "C" int flagship_fused_max_clusters(int D) {
  return hopper::max_active_clusters(flagship_rows_kernel, kThreads, rows_smem_bytes(D, false),
                                     kCluster);
}

// x (B, D), eps (B, L), params: a host array of the 14 device pointers in
// _params_tuple's order (nn.Linear (out, in) layout), rows (B, 2) scratch,
// out (3,): contiguous f32 on the current device. Returns the cudaError_t
// of the launches (0 = success).
extern "C" int flagship_fused_launch(const void* x, const void* eps,
                                     const void* const* params, void* rows,
                                     void* out, int B, int D, int L, double c,
                                     double beta, double prior_scale,
                                     void* stream) {
  if (B <= 0 || D <= 0 || L <= 0 || L > kMaxLatent) return (int)cudaErrorInvalidValue;
  Params prm;
  for (int i = 0; i < kNParams; ++i) prm.p[i] = static_cast<const float*>(params[i]);
  const Consts k = make_consts(c, beta, prior_scale, L, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = rows_smem_bytes(D, false);
  static size_t allowed[hopper::kMaxDevices] = {};
  cudaError_t e = hopper::allow_smem(flagship_rows_kernel, smem, allowed);
  if (e != cudaSuccess) return (int)e;
  const int clusters = (B + kRows - 1) / kRows;
  e = hopper::launch(flagship_rows_kernel, dim3(clusters * kCluster), dim3(kThreads), smem, s,
                     kCluster, static_cast<const float*>(x), static_cast<const float*>(eps), prm,
                     static_cast<float*>(rows), B, D, L, k);
  if (e != cudaSuccess) return (int)e;
  e = hopper::launch(flagship_mean_kernel, dim3(1), dim3(256), 0, s, 1,
                     static_cast<const float*>(rows), B, k.beta, static_cast<float*>(out));
  return (int)e;
}
