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
// Three kernels; choose() picks one from (P, D) and the alignment of x and
// out:
//
//   * D = 2, P a multiple of 4 up to 4 kMaxGroupsD2 = 64 (the flagship's
//     16): gyroplane_d2_kernel, the design above;
//   * D = 2, P a multiple of 4 above 64 (UnifiedVAE's 100, RNASeqVAE's 256,
//     experiments 5's and 7's 512): gyroplane_wide_kernel, the same design
//     built for wide P. A block holds T groups of one tile of planes by
//     256 / T rows. A tile holds up to kMaxTileGroups = 256 groups, so up
//     to 1,024 planes take one tile; a wider P is cut into equal tiles
//     over the grid's second dimension. The grid's first dimension is one
//     wave of blocks (shared among the tiles), each walking the rows. The
//     points never pass through shared memory, nothing is divided per
//     output, the plane constants are computed once a thread. At P = 512
//     and B = 128,000 the op moves 263 MB (78.6 us at 3.35 TB/s), and its
//     loop issues 54 SASS instructions an output (48 of them distance()'s):
//     ~106 us of issue for the 65.5 M outputs at 1.98 GHz. Issue, not
//     bytes, bounds it (PERF.md);
//   * anything else (D != 2, P not a multiple of 4, an x or out not
//     aligned for the vector accesses): gyroplane_any_kernel, the first
//     design's layout: one thread per (row, group of 4 planes) by a linear
//     index, the points and |p|^2 in shared memory (so any P the wrapper
//     admits fits), the other constants computed per output, and scalar
//     stores. No model's shape takes it. Its launch is exported on its own
//     (gyroplane_distances_launch_any), and the wide kernel gives its bits
//     exactly: the same operations in the same order, <x, p> summed from 0
//     as its loop sums it, and the bias added as its r += bias[j] adds it
//     (a missing bias is -0, which leaves every value as it is, -0 too).
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
constexpr int kGroup = 4;            // planes a thread: one 16-byte store
constexpr int kMaxGroupsD2 = 16;     // the D = 2 path: P <= 64
constexpr int kMaxTileGroups = 256;  // the wide path: up to 1,024 planes a tile

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

// D = 2, P = 4 G planes (G > kMaxGroupsD2); x 8-byte and out 16-byte
// aligned. Block (T, 256 / T): thread (t, r) of tile blockIdx.y keeps
// group g = blockIdx.y T + t's constants in registers (a g past G, in the
// last tile, has nothing to do) and walks rows blockIdx.x (256 / T) + r,
// then every gridDim.x (256 / T) rows. Its first row's x is loaded before
// the constants are, and each next row's before this one is computed, so
// the loads wait behind arithmetic. Each output is rounded as
// gyroplane_any_kernel rounds it (see the header).
__global__ void __launch_bounds__(kThreads)
gyroplane_wide_kernel(const float2* __restrict__ x, const float* __restrict__ points,
                      const float* __restrict__ bias, float4* __restrict__ out, int B, int G,
                      Consts k, int is_signed) {
  const int g = blockIdx.y * blockDim.x + threadIdx.x;
  int row = blockIdx.x * blockDim.y + threadIdx.y;
  if (g >= G || row >= B) return;
  float2 xv = x[row];
  float px[kGroup], py[kGroup], p2[kGroup], omc[kGroup], c2p2[kGroup], pn[kGroup], b[kGroup];
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    const int j = kGroup * g + i;
    px[i] = __ldg(points + 2 * j);
    py[i] = __ldg(points + 2 * j + 1);
    b[i] = bias != nullptr ? __ldg(bias + j) : -0.0f;
    p2[i] = px[i] * px[i] + py[i] * py[i];
    omc[i] = 1.0f - k.c * p2[i];
    c2p2[i] = k.c_sq * p2[i];
    pn[i] = sqrtf(fmaxf(p2[i], kMinNorm * kMinNorm));
  }
  // 32-bit rows (B < 2^31) and pointers stepped a row at a time
  const int stride = gridDim.x * blockDim.y;
  const float2* xr = x + row;
  float4* o = out + (long long)row * G + g;
  for (;;) {
    const bool more = row < B - stride;
    const float2 xn = more ? xr[stride] : xv;
    const float x2 = xv.x * xv.x + xv.y * xv.y;
    const float cx2 = k.c * x2;
    float d[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i)
      d[i] = distance(fmaf(xv.y, py[i], fmaf(xv.x, px[i], 0.0f)), x2, cx2, p2[i], omc[i],
                      c2p2[i], pn[i], k, is_signed) + b[i];
    *o = make_float4(d[0], d[1], d[2], d[3]);
    if (!more) break;
    row += stride;
    xr += stride;
    o += (long long)stride * G;
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

enum Path { kPathD2 = 0, kPathWide = 1, kPathAny = 2 };

// The kernel for P planes of width D, x and out at these addresses.
Path choose(const void* x, const void* out, int P, int D) {
  const bool vec = D == 2 && P % kGroup == 0 && reinterpret_cast<uintptr_t>(x) % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (!vec) return kPathAny;
  return P / kGroup <= kMaxGroupsD2 ? kPathD2 : kPathWide;
}

struct Launch {
  Path path;
  dim3 grid;
  dim3 block;
  size_t smem;   // dynamic shared memory (the fallback's)
  int groups;    // G, groups a row
};

// Blocks of `kernel` at `threads` threads a block that the card holds at
// once (one wave), cached by block size in cache[threads].
template <typename Kernel>
int wave_blocks(Kernel kernel, int threads, int* cache) {
  if (cache[threads] == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    cache[threads] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return cache[threads];
}

int d2_cache[kThreads + 1];
int wide_cache[kThreads + 1];

Launch plan(const void* x, const void* out, int B, int P, int D) {
  Launch l;
  l.groups = (P + kGroup - 1) / kGroup;
  l.path = choose(x, out, P, D);
  l.smem = 0;
  if (l.path == kPathD2) {
    // one wave of blocks, each thread walking several rows
    const int rows = kThreads / l.groups;
    const long long need = ((long long)B + rows - 1) / rows;
    const int wave = wave_blocks(gyroplane_d2_kernel, kThreads, d2_cache);
    l.block = dim3(l.groups, rows);
    l.grid = dim3((unsigned)(need < wave ? need : wave));
  } else if (l.path == kPathWide) {
    // equal tiles of at most kMaxTileGroups groups; one wave shared among them
    const int tiles = (l.groups + kMaxTileGroups - 1) / kMaxTileGroups;
    const int t = (l.groups + tiles - 1) / tiles;
    const int rows = kThreads / t;
    const long long need = ((long long)B + rows - 1) / rows;
    const int wave = wave_blocks(gyroplane_wide_kernel, t * rows, wide_cache) / tiles;
    const long long per_tile = wave > 1 ? wave : 1;
    l.block = dim3(t, rows);
    l.grid = dim3((unsigned)(need < per_tile ? need : per_tile), tiles);
  } else {
    l.block = dim3(kThreads);
    l.grid = dim3((unsigned)(((long long)B * l.groups + kThreads - 1) / kThreads));
    l.smem = sizeof(float) * ((size_t)P * D + P);
  }
  return l;
}

Consts consts(double c) {
  Consts k;
  k.c = (float)c;
  k.two_c = (float)(2.0 * c);
  k.c_sq = (float)(c * c);
  k.ln2_inv_sqrt_c = (float)(log(2.0) / sqrt(c));
  k.two_sqrt_c = (float)(2.0 * sqrt(c));
  k.max_d2 = (float)((1.0 - 1e-4) * (1.0 - 1e-4) / c);
  return k;
}

// gyroplane_any_kernel at (B, P, D), whatever kernel plan() would pick.
int launch_any(const void* x, const void* points, const void* bias, void* out, int B, int P,
               int D, const Consts& k, int is_signed, cudaStream_t s) {
  const int groups = (P + kGroup - 1) / kGroup;
  const size_t smem = sizeof(float) * ((size_t)P * D + P);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gyroplane_any_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)(((long long)B * groups + kThreads - 1) / kThreads);
  gyroplane_any_kernel<<<blocks, kThreads, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(points),
      static_cast<const float*>(bias), static_cast<float*>(out), B, P, D, groups, k, is_signed);
  return (int)cudaGetLastError();
}

// does nothing: the floor under the kernel's time (see below)
__global__ void empty_kernel() {}

}  // namespace

// The kernel that gyroplane_distances_launch runs for (B, P, D) with x and
// out at these addresses: 0 the D = 2 kernel (P <= 64), 1 the wide D = 2
// kernel, 2 the fallback; -1 for an empty shape. Touches no device.
extern "C" int gyroplane_path(const void* x, const void* out, int B, int P, int D) {
  if (B <= 0 || P <= 0 || D <= 0) return -1;
  return (int)choose(x, out, P, D);
}

// An empty kernel launched with the grid, block and dynamic shared memory
// that gyroplane_distances_launch uses for (B, P, D) on aligned tensors:
// what one launch of that shape costs on the card with no work in it, the
// floor under K1's time. Returns the cudaError_t.
extern "C" int gyroplane_empty_launch(int B, int P, int D, void* stream) {
  if (B <= 0 || P <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  // any 16-byte aligned address plans as an aligned tensor would
  const Launch l = plan(reinterpret_cast<const void*>(256), reinterpret_cast<const void*>(256),
                        B, P, D);
  empty_kernel<<<l.grid, l.block, l.smem, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

// x (B, D), points (P, D), bias (P,) or null, out (B, P): contiguous f32 on
// the current device. Returns the cudaError_t of the launch (0 = success).
extern "C" int gyroplane_distances_launch(const void* x, const void* points,
                                          const void* bias, void* out, int B,
                                          int P, int D, double c,
                                          int is_signed, void* stream) {
  if (B <= 0 || P <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const Consts k = consts(c);
  const float* bf = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Launch l = plan(x, out, B, P, D);
  if (l.path == kPathD2) {
    gyroplane_d2_kernel<<<l.grid, l.block, 0, s>>>(
        static_cast<const float2*>(x), static_cast<const float*>(points), bf,
        static_cast<float4*>(out), B, k, is_signed);
    return (int)cudaGetLastError();
  }
  if (l.path == kPathWide) {
    gyroplane_wide_kernel<<<l.grid, l.block, 0, s>>>(
        static_cast<const float2*>(x), static_cast<const float*>(points), bf,
        static_cast<float4*>(out), B, l.groups, k, is_signed);
    return (int)cudaGetLastError();
  }
  return launch_any(x, points, bias, out, B, P, D, k, is_signed, s);
}

// The fallback kernel (gyroplane_any_kernel) at any (B, P, D), with
// gyroplane_distances_launch's arguments: what the other kernels are held
// to, bit for bit, on the card.
extern "C" int gyroplane_distances_launch_any(const void* x, const void* points,
                                              const void* bias, void* out, int B,
                                              int P, int D, double c,
                                              int is_signed, void* stream) {
  if (B <= 0 || P <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  return launch_any(x, points, bias, out, B, P, D, consts(c), is_signed,
                    static_cast<cudaStream_t>(stream));
}
