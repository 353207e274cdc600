// Gyroplane distances for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   hyperbolic_vae_tpu/ops/gyroplane.py::_gyroplane_kernel
// (launched by gyroplane_distances_pallas). For x (B, D), points (P, D)
// and an optional bias (P,), it writes out (B, P):
//
//   xp = <x, p>, x2 = |x|^2, p2 = |p|^2
//   den   = max(1 - 2c xp + c^2 p2 x2, MIN_NORM)
//   alpha = (1 - 2c xp + c x2) / den,  beta = (1 - c p2) / den
//   <diff,p> = -alpha p2 + beta xp            (|.| when unsigned)
//   |diff|^2 = clip(alpha^2 p2 - 2 alpha beta xp + beta^2 x2,
//                   MIN_NORM, (1 - 1e-4)^2 / c)
//   out = asinh(2 sqrt(c) <diff,p> / max((1 - c|diff|^2) max(|p|, MIN_NORM),
//                                        MIN_NORM)) / sqrt(c) + bias
//
// which is ops/gyroplane.py::_epilogue with every clamp.
//
// Bound on this card. The op reads x and writes out once: 4 (B D + P D +
// P + B P) bytes. At the decode of the flagship's importance-weighted bound
// (B = 128,000 latents, P = 16, D = 2) that is 9.2 MB, 2.75 us at
// 3.35 TB/s, against ~40 flops an output (1.2 us at 67 TFLOP/s): the
// bytes bound it. At the training and serving batch (B = 256) the work is
// 18.6 KB and the launch is the floor.
//
// The first design gave each thread one output, divided a 64-bit index by P
// for it, reread its row of x and recomputed |x|^2 for each of the row's P
// outputs, and took three IEEE divisions and an accurate asinhf: at
// B = 128,000 its arithmetic, not the bytes, set its time. This design:
//
//   * one thread per (row, group of 4 planes), a block of G = P / 4
//     groups by 256 / G rows (no index division); x is loaded once as a
//     float2, |x|^2 and c|x|^2 are computed once, and the 4 outputs leave
//     as one 16-byte store, so a warp writes 512 contiguous bytes;
//   * one wave of blocks (as many as the card holds at once), each thread
//     keeping its 4 planes' constants (p, |p|^2, 1 - c|p|^2, c^2 |p|^2,
//     max(|p|, MIN_NORM), bias) in registers and walking the rows, the
//     next row's x loaded before this one is computed;
//   * the chain up to |diff|^2 rounds as the plain version's separate
//     operations do (see distance()): near the ball's boundary den and
//     1 - c|diff|^2 cancel, and any other rounding there moves a result by
//     up to ~1e-3. Its two divisions share one reciprocal, corrected per
//     quotient to the IEEE quotient (Markstein);
//   * after it, the arsinh's argument takes an approximate reciprocal and
//     arsinh(r) = sign(r) log(|r| + sqrt(r^2 + 1)) the hardware's rsqrt and
//     lg2 approximations, which the tolerances (1e-5 abs against the plain
//     version in the interior; near the boundary, no worse than twice the
//     plain version's error against float64) leave room for.
//
// What bounds it now is instruction issue (~50 instructions an output, most
// of them the plain version's rounding sequence), not bytes: see PERF.md.
//
// The flagship's shape (D = 2, P a multiple of 4 up to 4 kMaxGroupsD2) takes
// that path. Any other (P, D), or an x or out that is not aligned for the
// vector accesses, takes the runtime path: one thread per (row, group of 4
// planes) by a linear index, the points and |p|^2 in shared memory as the
// first design laid them out (so any P the wrapper admits fits), the other
// constants computed per output, and scalar stores.
//
// The build passes -fmad=false, so nothing is fused that the source does not
// write as fmaf: <x, p> (as cuBLAS computes the plain version's product),
// the corrections and the arsinh's r^2 + 1.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMinNorm = 1e-15f;
constexpr int kThreads = 256;
constexpr int kGroup = 4;           // planes a thread: one 16-byte store
constexpr int kMaxGroupsD2 = 16;    // the D = 2 path: P <= 64

struct Consts {
  float c;               // c
  float two_c;           // 2 c
  float c_sq;            // c^2
  float ln2_inv_sqrt_c;  // ln(2) / sqrt(c)
  float two_sqrt_c;      // 2 sqrt(c)
  float max_d2;          // (1 - 1e-4)^2 / c
};

// The hardware's approximations, subnormals flushed (every argument they
// get here is a normal number): rcp.approx and rsqrt.approx within 1 ulp,
// lg2.approx within 2^-22 absolute. (CUDA's __fdividef, rsqrtf and __logf
// are the same instructions behind a rescaling of subnormal inputs.)
__device__ __forceinline__ float rcp_approx(float a) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}

__device__ __forceinline__ float sqrt_approx(float a) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
  return a * r;
}

__device__ __forceinline__ float log2_approx(float a) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}

// a / b rounded as IEEE division rounds it, given y = RN(1 / b): the
// quotient a y corrected once by its fused residual (Markstein). One
// reciprocal then serves alpha and beta.
__device__ __forceinline__ float div_rn(float a, float b, float y) {
  const float q = a * y;
  return fmaf(fmaf(-b, q, a), y, q);
}

// One output from the row's x2 = |x|^2, cx2 = c|x|^2 and <x, p> = xp, and
// the plane's p2 = |p|^2, omc = 1 - c p2, c2p2 = c^2 p2, pn = max(|p|, MIN_NORM).
// Up to |diff|^2 the operations are the plain version's, in its order and
// rounded as it rounds them (-fmad=false; the IEEE quotients): near the
// ball's boundary den and 1 - c|diff|^2 cancel, and a reordering, or a
// reciprocal of den multiplied in uncorrected, moves the result by up to
// ~1e-3 (PERF.md). After that the approximations add below ~1e-6.
__device__ __forceinline__ float distance(float xp, float x2, float cx2, float p2,
                                          float omc, float c2p2, float pn,
                                          const Consts& k, int is_signed) {
  const float one_m = 1.0f - k.two_c * xp;
  const float den = fmaxf(one_m + c2p2 * x2, kMinNorm);
  const float y0 = rcp_approx(den);
  const float y = fmaf(fmaf(-den, y0, 1.0f), y0, y0);  // RN(1 / den)
  const float alpha = div_rn(one_m + cx2, den, y);
  const float beta = div_rn(omc, den, y);
  float sc = -alpha * p2 + beta * xp;
  // alpha^2 p2 - 2 alpha beta xp + beta^2 x2: 2 (alpha beta xp) is the
  // plain version's (2 alpha) beta xp exactly (scaling by 2 is exact), so
  // its subtraction fuses without a change of rounding
  float d2 = fmaf(-2.0f, alpha * beta * xp, alpha * alpha * p2) + beta * beta * x2;
  d2 = fminf(fmaxf(d2, kMinNorm), k.max_d2);
  if (!is_signed) sc = fabsf(sc);
  const float denom = fmaxf((1.0f - k.c * d2) * pn, kMinNorm);
  const float r = k.two_sqrt_c * sc * rcp_approx(denom);
  const float a = fabsf(r);
  // log(2|r|) past |r| = 1e18, where r^2 would overflow
  const float l2 = log2_approx(a > 1e18f ? a + a : a + sqrt_approx(fmaf(a, a, 1.0f)));
  return copysignf(l2, r) * k.ln2_inv_sqrt_c;
}

// D = 2, P = 4 G planes (G <= kMaxGroupsD2); x 8-byte and out 16-byte
// aligned. Block (G, 256 / G): thread (g, r) keeps planes 4 g .. 4 g + 3's
// constants in registers and walks rows blockIdx.x * (256 / G) + r, then
// every gridDim.x * (256 / G) rows, loading the next row's x before it
// computes this one's.
__global__ void __launch_bounds__(kThreads)
gyroplane_d2_kernel(const float2* __restrict__ x, const float* __restrict__ points,
                    const float* __restrict__ bias, float4* __restrict__ out, int B,
                    Consts k, int is_signed) {
  const int G = blockDim.x;
  const int g = threadIdx.x;
  float px[kGroup], py[kGroup], p2[kGroup], omc[kGroup], c2p2[kGroup], pn[kGroup], b[kGroup];
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    const int j = kGroup * g + i;
    px[i] = __ldg(points + 2 * j);
    py[i] = __ldg(points + 2 * j + 1);
    b[i] = bias != nullptr ? __ldg(bias + j) : 0.0f;
    p2[i] = px[i] * px[i] + py[i] * py[i];
    omc[i] = 1.0f - k.c * p2[i];
    c2p2[i] = k.c_sq * p2[i];
    pn[i] = sqrtf(fmaxf(p2[i], kMinNorm * kMinNorm));
  }
  const long long stride = (long long)gridDim.x * blockDim.y;
  long long row = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  float2 xv = row < B ? x[row] : make_float2(0.0f, 0.0f);
  for (; row < B; row += stride) {
    const float2 xn = row + stride < B ? x[row + stride] : xv;
    const float x2 = xv.x * xv.x + xv.y * xv.y;
    const float cx2 = k.c * x2;
    float o[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i)
      o[i] = distance(fmaf(xv.y, py[i], xv.x * px[i]), x2, cx2, p2[i], omc[i], c2p2[i], pn[i],
                      k, is_signed) + b[i];
    out[row * G + g] = make_float4(o[0], o[1], o[2], o[3]);
    xv = xn;
  }
}

// Any P and D, any alignment: the points and |p|^2 in dynamic shared
// memory, (P D + P) floats; G = ceil(P / 4) groups a row, the last masked.
__global__ void __launch_bounds__(kThreads)
gyroplane_any_kernel(const float* __restrict__ x, const float* __restrict__ points,
                     const float* __restrict__ bias, float* __restrict__ out, int B,
                     int P, int d, int G, Consts k, int is_signed) {
  extern __shared__ float smem[];
  float* sp = smem;           // (P, d) points
  float* sp2 = smem + P * d;  // (P,) |p|^2
  for (int i = threadIdx.x; i < P * d; i += blockDim.x) sp[i] = points[i];
  __syncthreads();
  for (int j = threadIdx.x; j < P; j += blockDim.x) {
    float s = 0.0f;
    for (int t = 0; t < d; ++t) s += sp[j * d + t] * sp[j * d + t];
    sp2[j] = s;
  }
  __syncthreads();

  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long row = tid / G;
  if (row >= B) return;
  const int j0 = kGroup * (int)(tid - row * G);
  const float* xr = x + row * d;
  float x2 = 0.0f;
  for (int t = 0; t < d; ++t) x2 += xr[t] * xr[t];
  const float cx2 = k.c * x2;
  for (int j = j0; j < j0 + kGroup && j < P; ++j) {
    float xp = 0.0f;
    for (int t = 0; t < d; ++t) xp = fmaf(xr[t], sp[j * d + t], xp);
    const float p2 = sp2[j];
    float r = distance(xp, x2, cx2, p2, 1.0f - k.c * p2, k.c_sq * p2,
                       sqrtf(fmaxf(p2, kMinNorm * kMinNorm)), k, is_signed);
    if (bias != nullptr) r += bias[j];
    out[row * P + j] = r;
  }
}

struct Launch {
  bool d2;       // the D = 2 path
  unsigned blocks;
  dim3 block;
  size_t smem;   // dynamic shared memory (the runtime path's)
  int groups;    // G, groups a row
};

// Blocks of the D = 2 kernel the card holds at once (one wave): its grid
// is at most this, each thread walking several rows.
int d2_wave_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gyroplane_d2_kernel, kThreads, 0);
    blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  return blocks;
}

Launch plan(const void* x, const void* out, int B, int P, int D) {
  Launch l;
  l.groups = (P + kGroup - 1) / kGroup;
  l.d2 = D == 2 && P % kGroup == 0 && l.groups <= kMaxGroupsD2 &&
         reinterpret_cast<uintptr_t>(x) % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (l.d2) {
    const int rows = kThreads / l.groups;
    const long long need = ((long long)B + rows - 1) / rows;
    l.block = dim3(l.groups, rows);
    l.blocks = (unsigned)(need < d2_wave_blocks() ? need : d2_wave_blocks());
    l.smem = 0;
  } else {
    l.block = dim3(kThreads);
    l.blocks = (unsigned)(((long long)B * l.groups + kThreads - 1) / kThreads);
    l.smem = sizeof(float) * ((size_t)P * D + P);
  }
  return l;
}

// does nothing: the floor under the kernel's time (see below)
__global__ void empty_kernel() {}

}  // namespace

// An empty kernel launched with the grid, block and dynamic shared memory
// that gyroplane_distances_launch uses for (B, P, D) on aligned tensors:
// what one launch of that shape costs on the card with no work in it, the
// floor under K1's time. Returns the cudaError_t.
extern "C" int gyroplane_empty_launch(int B, int P, int D, void* stream) {
  if (B <= 0 || P <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  // any 16-byte aligned address plans as an aligned tensor would
  const Launch l = plan(reinterpret_cast<const void*>(256), reinterpret_cast<const void*>(256),
                        B, P, D);
  empty_kernel<<<l.blocks, l.block, l.smem, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

// x (B, D), points (P, D), bias (P,) or null, out (B, P): contiguous f32 on
// the current device. Returns the cudaError_t of the launch (0 = success).
extern "C" int gyroplane_distances_launch(const void* x, const void* points,
                                          const void* bias, void* out, int B,
                                          int P, int D, double c,
                                          int is_signed, void* stream) {
  if (B <= 0 || P <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  Consts k;
  k.c = (float)c;
  k.two_c = (float)(2.0 * c);
  k.c_sq = (float)(c * c);
  k.ln2_inv_sqrt_c = (float)(log(2.0) / sqrt(c));
  k.two_sqrt_c = (float)(2.0 * sqrt(c));
  k.max_d2 = (float)((1.0 - 1e-4) * (1.0 - 1e-4) / c);
  const float* bf = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Launch l = plan(x, out, B, P, D);
  if (l.d2) {
    gyroplane_d2_kernel<<<l.blocks, l.block, 0, s>>>(
        static_cast<const float2*>(x), static_cast<const float*>(points), bf,
        static_cast<float4*>(out), B, k, is_signed);
    return (int)cudaGetLastError();
  }
  if (l.smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gyroplane_any_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
    if (e != cudaSuccess) return (int)e;
  }
  gyroplane_any_kernel<<<l.blocks, l.block, l.smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(points), bf,
      static_cast<float*>(out), B, P, D, l.groups, k, is_signed);
  return (int)cudaGetLastError();
}
