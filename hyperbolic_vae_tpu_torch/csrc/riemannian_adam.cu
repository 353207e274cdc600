// Riemannian Adam and the Trainer's finite guard over all of an optimizer's
// parameters, as two launches for Hopper (sm_90a).
//
// No Pallas kernel of the JAX package corresponds to this one: there XLA
// fuses the optax update of every leaf into the jitted step. In the port the
// same update ran as ~20 ATen elementwise launches a tensor plus ~3 a tensor
// for the guard's sum of squares (optim/riemannian_adam.py's op sequence,
// ~500 launches a step for the flagship's 14 tensors), each near the ~1.3 us
// floor a kernel has inside a CUDA graph, and over experiment 8's two
// 20,480 x 100 weights ~48 passes of 8.2 MB. It is bound by bytes: the update
// reads g, p, m, v and writes p, m, v (7 tensor-sizes), the guard reads g
// once more, ~130 MB a step at 20,480 genes, ~40 us at 3.35 TB/s.
//
// The work is a table built once when the optimizer is made
// (ops/riemannian_adam.py), in device memory: the segments (one a parameter:
// its data, exp_avg and exp_avg_sq pointers, size, row width for ball points,
// group), the groups (lr's device pointer, betas, eps, weight decay) and the
// tiles, a block each (a segment's elements [start, start + len): a long
// tensor takes many tiles of kTileElems elements, a short one a tile of its
// own, ball rows tiles of kRowTile rows), and scratch for the ball rows'
// point steps (kRowWork floats an element: rows of any width). A tile a
// block: packing a block with several short tensors ran their chains of
// dependent loads (tile, segment, group, lr) one after another, ~2 us each;
// on an H100 the flagship's pair took 25 us in a graph so, 10 us a tile a
// block. Parameters
// and moments keep their addresses, so the table stays true under CUDA graph
// capture; the gradients, fresh each backward, come by value with each
// launch, kMaxTensors a launch: a model with more tensors takes each kernel
// once a batch of kMaxTensors segments, the guard's last launch deciding.
//   1. adam_guard_kernel: each block sums g^2 over its tile in a fixed order
//      and writes its partial; the block that finishes last (a ticket picks
//      it, as in train_grad_kernel) sums the partials in index order and
//      decides ok = isfinite(loss) & isfinite(sum g^2) (or takes ok from the
//      caller, or true), advances count where ok, and writes each group's
//      bias corrections 1 - b^count in f32. With ok given it runs one block
//      and reads no gradient.
//   2. adam_update_kernel (programmatic dependent launch): returns at once
//      where not ok. Else Euclidean tiles run Adam on 4 consecutive elements
//      a 16-byte load, every load of a thread before any of its stores, in
//      place; ball rows take one thread a row through point_step
//      (point_step.cuh, as K3, its vectors in the table's scratch), the new
//      point added as p + (new - p).
// The Euclidean arithmetic is the op sequence's, op for op: built with
// -fmad=false each product and sum rounds on its own, so those tensors, both
// moments and count come out bit for bit as the op sequence's.

#include <stdint.h>

#include "point_step.cuh"

namespace {

using namespace flagship;

constexpr int kBlock = 256;                        // threads a block
constexpr int kRun = 4;                            // elements of one 16-byte load
constexpr int kRuns = 4;                           // runs a thread takes in a full tile
constexpr int kTileElems = kBlock * kRun * kRuns;  // elements of a tile at most
constexpr int kRowTile = kBlock;                   // ball rows of a tile (a thread a row)
constexpr int kMaxTensors = 256;                   // gradients a launch, passed by value
constexpr int kRowWork = kPointVecs + 1;           // scratch of a ball row, in row widths

struct Seg {
  float* p;
  float* m;
  float* v;
  long long n;  // elements
  int row;      // ball points: the row width L; 0 for a Euclidean tensor
  int group;
  long long work;  // ball points: the offset of their scratch in Table::work, in floats
};

struct Group {
  const float* lr;  // 0-d, in device memory: a controller writes it between steps
  float b1, omb1, b2, omb2, eps, wd;
};

struct Tile {
  int seg, len;
  long long start;
};

struct Table {
  const Seg* segs;
  const Group* groups;
  const Tile* tiles;  // launched a block a tile
  float* work;        // the ball rows' scratch
  int n_tiles, n_groups;
};

// one launch's share of the table: segments from seg0 (their gradients in
// Grads) and their tiles [tile0, tile_end); final: the guard's last launch
struct Batch {
  int seg0, tile0, tile_end;
  bool final;
};

struct Grads {
  const float* g[kMaxTensors];  // segment seg0 + i's; null where it has no gradient
};

static_assert(sizeof(Seg) == 48 && sizeof(Group) == 32 && sizeof(Tile) == 16, "table layout");

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// ---- 1. the guard --------------------------------------------------------------

// loss: the step's loss (the guard decides ok), or null: ok from ok_in, or
// true where ok_in is null too. scal: ok (1 or 0), then bc1, bc2 a group.
__global__ void __launch_bounds__(kBlock)
adam_guard_kernel(const __grid_constant__ Grads gr, Table t, Batch b, const float* __restrict__ loss,
                  const bool* __restrict__ ok_in, int* count, float* partials, unsigned* ticket,
                  float* scal, bool* ok_out) {
  __shared__ float red[kBlock / 32];
  __shared__ float st[kBlock];
  __shared__ bool last;
  __shared__ int cnt;
  const int tid = threadIdx.x;
  hopper::grid_dependency_wait();  // the backward's gradients and the loss
  float s = 0.0f;
  // a grid-stride loop over the tiles that runs once a block: the same body
  // without the loop ran the update ~50 % slower at 4 M elements on an H100
  for (int ti = b.tile0 + blockIdx.x; loss != nullptr && ti < b.tile_end; ti += gridDim.x) {
    const Tile tl = t.tiles[ti];
    const float* g = gr.g[tl.seg - b.seg0];
    if (g == nullptr) continue;
    g += tl.start;
    int e0 = 0;
    if (aligned16(g)) {
      const int runs = tl.len / kRun;
      for (int q = tid; q < runs; q += kBlock) {
        const float4 a = *reinterpret_cast<const float4*>(g + kRun * q);
        s += a.x * a.x;
        s += a.y * a.y;
        s += a.z * a.z;
        s += a.w * a.w;
      }
      e0 = runs * kRun;
    }
    for (int e = e0 + tid; e < tl.len; e += kBlock) s += g[e] * g[e];
  }
  s = warp_sum(s);
  if ((tid & 31) == 0) red[tid >> 5] = s;
  __syncthreads();
  if (tid == 0) {
    float bs = 0.0f;
    for (int w = 0; w < kBlock / 32; ++w) bs += red[w];
    if (b.tile0 + (int)blockIdx.x < b.tile_end) partials[b.tile0 + blockIdx.x] = bs;
    __threadfence();
    last = b.final && atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  hopper::launch_dependents();
  if (!last) return;

  // the last block: sum g^2 in index order (every launch's partials), the
  // guard, count, the corrections
  __threadfence();
  float gs = 0.0f;
  for (int i = tid; i < t.n_tiles; i += kBlock) gs += __ldcg(partials + i);
  st[tid] = gs;
  __syncthreads();
  for (int half = kBlock / 2; half > 0; half >>= 1) {
    if (tid < half) st[tid] += st[tid + half];
    __syncthreads();
  }
  if (tid == 0) {
    const bool ok = loss != nullptr ? (isfinite(*loss) && isfinite(st[0]))
                                    : (ok_in == nullptr || *ok_in);
    cnt = *count + 1;
    if (ok) *count = cnt;  // count advances only where ok, as the op sequence's
    scal[0] = ok ? 1.0f : 0.0f;
    *ok_out = ok;
    *ticket = 0u;
  }
  __syncthreads();
  const float cf = (float)cnt;
  for (int q = tid; q < t.n_groups; q += kBlock) {
    scal[1 + 2 * q] = 1.0f - powf(t.groups[q].b1, cf);
    scal[2 + 2 * q] = 1.0f - powf(t.groups[q].b2, cf);
  }
}

// ---- 2. the update, in place where ok ------------------------------------------

// Adam on one element, in the op sequence's order: (weight decay), the two
// moments, ((-lr) (m / bc1)) / (sqrt(v / bc2) + eps), and p plus that
__device__ __forceinline__ void adam(float& p, float g, float& m, float& v, const Group& gp,
                                     float lr, float bc1, float bc2) {
  if (gp.wd != 0.0f) g = g + gp.wd * p;
  m = gp.b1 * m + gp.omb1 * g;
  v = gp.b2 * v + gp.omb2 * g * g;
  p = p + ((-lr) * (m / bc1)) / (sqrtf(v / bc2) + gp.eps);
}

__device__ __forceinline__ void adam4(float4& p, const float4& g, float4& m, float4& v,
                                      const Group& gp, float lr, float bc1, float bc2) {
  adam(p.x, g.x, m.x, v.x, gp, lr, bc1, bc2);
  adam(p.y, g.y, m.y, v.y, gp, lr, bc1, bc2);
  adam(p.z, g.z, m.z, v.z, gp, lr, bc1, bc2);
  adam(p.w, g.w, m.w, v.w, gp, lr, bc1, bc2);
}

__device__ void euclidean_tile(float* p, const float* g, float* m, float* v, int len,
                               const Group& gp, float lr, float bc1, float bc2) {
  const int tid = threadIdx.x;
  int e0 = 0;
  if (aligned16(p) && aligned16(g) && aligned16(m) && aligned16(v)) {
    const int runs = len / kRun;  // at most kBlock * kRuns
    float4 P[kRuns], G[kRuns], M[kRuns], V[kRuns];
#pragma unroll
    for (int r = 0; r < kRuns; ++r) {  // every load before any store
      const int q = tid + r * kBlock;
      if (q < runs) {
        P[r] = reinterpret_cast<const float4*>(p)[q];
        G[r] = reinterpret_cast<const float4*>(g)[q];
        M[r] = reinterpret_cast<const float4*>(m)[q];
        V[r] = reinterpret_cast<const float4*>(v)[q];
      }
    }
#pragma unroll
    for (int r = 0; r < kRuns; ++r) {
      const int q = tid + r * kBlock;
      if (q < runs) {
        adam4(P[r], G[r], M[r], V[r], gp, lr, bc1, bc2);
        reinterpret_cast<float4*>(p)[q] = P[r];
        reinterpret_cast<float4*>(m)[q] = M[r];
        reinterpret_cast<float4*>(v)[q] = V[r];
      }
    }
    e0 = runs * kRun;
  }
  for (int e = e0 + tid; e < len; e += kBlock) {
    float pe = p[e], me = m[e], ve = v[e];
    adam(pe, g[e], me, ve, gp, lr, bc1, bc2);
    p[e] = pe;
    m[e] = me;
    v[e] = ve;
  }
}

// one thread a row of L (any width): K3's point step, its vectors and the
// weight-decayed gradient in the tile's scratch (kRowWork * L floats a row),
// then p + (new point - p) as the op sequence adds its update; exp_avg and
// exp_avg_sq written in place
__device__ void ball_rows_tile(float* p, const float* g, float* m, float* v, int len, int L,
                               float* work, const Group& gp, float lr, float bc1, float bc2,
                               const Consts& k) {
  const int r = threadIdx.x;
  if (r >= len / L) return;
  const int o = r * L;
  float* wr = work + (long long)r * kRowWork * L;
  float* gw = wr + kPointVecs * L;
  for (int l = 0; l < L; ++l) gw[l] = gp.wd != 0.0f ? g[o + l] + gp.wd * p[o + l] : g[o + l];
  const AdamScalars as{lr, gp.b1, gp.omb1, gp.b2, gp.omb2, gp.eps};
  PointRows w(wr, L);
  point_step(p + o, m + o, v + o, gw, L, as, bc1, bc2, k, w, w.np, m + o, v + o);
  for (int l = 0; l < L; ++l) p[o + l] = p[o + l] + (w.np[l] - p[o + l]);
}

__global__ void __launch_bounds__(kBlock)
adam_update_kernel(const __grid_constant__ Grads gr, Table t, Batch b,
                   const float* __restrict__ scal, Consts k) {
  hopper::grid_dependency_wait();  // the guard's scalars
  if (scal[0] == 0.0f) return;     // not ok: params and moments stay as they are
  for (int ti = b.tile0 + blockIdx.x; ti < b.tile_end; ti += gridDim.x) {  // once a block
    const Tile tl = t.tiles[ti];
    const float* g = gr.g[tl.seg - b.seg0];
    if (g == nullptr) continue;
    const Seg sg = t.segs[tl.seg];
    const Group gp = t.groups[sg.group];
    const float lr = *gp.lr, bc1 = scal[1 + 2 * sg.group], bc2 = scal[2 + 2 * sg.group];
    if (sg.row == 0)
      euclidean_tile(sg.p + tl.start, g + tl.start, sg.m + tl.start, sg.v + tl.start, tl.len,
                     gp, lr, bc1, bc2);
    else
      ball_rows_tile(sg.p + tl.start, g + tl.start, sg.m + tl.start, sg.v + tl.start, tl.len,
                     sg.row, t.work + sg.work + tl.start * kRowWork, gp, lr, bc1, bc2, k);
  }
}

}  // namespace

// the table's constants, for the wrapper to check its own against:
// (elements a block, ball rows a tile, gradients a launch, scratch floats a
// ball element)
extern "C" void riemannian_adam_limits(int* out) {
  out[0] = kTileElems;
  out[1] = kRowTile;
  out[2] = kMaxTensors;
  out[3] = kRowWork;
}

// One step over the table (segs, groups, tiles: device memory laid out as
// ops/riemannian_adam.py writes it; n_segs segments, n_groups groups,
// n_tiles tiles). seg_tiles: a host array of n_segs + 1 ints, the first tile
// of each segment and n_tiles. grads: a host array of n_segs device
// pointers, null where a parameter has no gradient. loss: a device f32 (the
// guard decides ok), or null, then ok_in (a device bool) or, null too, ok
// true. count: the device int32 step count. scratch: n_tiles partials, a
// ticket (zero before the first launch; the kernel leaves it at zero) and
// 1 + 2 n_groups scalars, as floats. work: the ball rows' scratch. ok_out:
// a device bool. c: the ball's curvature. Each kernel is launched once a
// batch of kMaxTensors segments (the guard once in all without the loss).
// Returns the cudaError_t of the launches (0 = success).
extern "C" int riemannian_adam_launch(const void* segs, const void* groups, const void* tiles,
                                      int n_segs, int n_groups, int n_tiles,
                                      const int* seg_tiles, const void* const* grads,
                                      const void* loss, const void* ok_in, void* count,
                                      void* scratch, void* work, void* ok_out, double c,
                                      void* stream) {
  if (n_segs <= 0 || n_tiles < 0 || n_groups <= 0 || seg_tiles[n_segs] != n_tiles)
    return (int)cudaErrorInvalidValue;
  Table t;
  t.segs = static_cast<const Seg*>(segs);
  t.groups = static_cast<const Group*>(groups);
  t.tiles = static_cast<const Tile*>(tiles);
  t.work = static_cast<float*>(work);
  t.n_tiles = n_tiles;
  t.n_groups = n_groups;
  float* partials = static_cast<float*>(scratch);
  unsigned* ticket = reinterpret_cast<unsigned*>(partials + n_tiles);
  float* scal = partials + n_tiles + 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Consts k = make_consts(c, 0.0, 1.0, 2, 1);
  Grads gr;
  for (int pass = 0; pass < 2; ++pass) {  // the guard's launches, then the update's
    for (int s0 = 0; s0 < n_segs; s0 += kMaxTensors) {
      const int s1 = s0 + kMaxTensors < n_segs ? s0 + kMaxTensors : n_segs;
      const Batch b{s0, seg_tiles[s0], seg_tiles[s1], s1 == n_segs};
      int blocks = b.tile_end - b.tile0;
      if (pass == 0) {
        if (loss == nullptr) blocks = 0;  // no sum: the last launch alone, one block
        if (b.final && blocks == 0) blocks = 1;
      }
      if (blocks == 0) continue;
      for (int i = 0; i < kMaxTensors; ++i)
        gr.g[i] = s0 + i < s1 ? static_cast<const float*>(grads[s0 + i]) : nullptr;
      const cudaError_t e =
          pass == 0
              ? hopper::launch(adam_guard_kernel, dim3(blocks), dim3(kBlock), 0, s, 1, gr, t, b,
                               static_cast<const float*>(loss), static_cast<const bool*>(ok_in),
                               static_cast<int*>(count), partials, ticket, scal,
                               static_cast<bool*>(ok_out))
              : hopper::launch(adam_update_kernel, dim3(blocks), dim3(kBlock), 0, s, 1, gr, t, b,
                               static_cast<const float*>(scal), k);
      if (e != cudaSuccess) return (int)e;
    }
  }
  return 0;
}
