// Hopper (sm_90a) primitives the flagship kernels use, each a line of PTX:
// the 1-D bulk asynchronous copy (global -> shared, completing on an
// mbarrier), the mbarrier itself, thread block clusters (rank, barrier,
// distributed shared memory), cp.async of 4 bytes, programmatic dependent
// launch, and a host helper that launches a kernel with cudaLaunchKernelEx.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace hopper {

// the kernel's dynamic shared memory
__device__ __forceinline__ unsigned char* dyn_smem() {
  extern __shared__ __align__(16) unsigned char dyn_smem_buf[];
  return dyn_smem_buf;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier and the 1-D bulk copy --------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one arrival that also expects `bytes` of bulk copies to complete
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16) from global src to shared dst (both 16-byte
// aligned); completion is counted on bar
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---- cp.async (4 bytes, any alignment) ------------------------------------

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// wait until at most n of this thread's groups are pending
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(n) : "memory");
}

// ---- clusters --------------------------------------------------------------

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// the address of *p in the shared memory of the cluster's CTA `rank`
template <typename T>
__device__ __forceinline__ T* cluster_map(T* p, uint32_t rank) {
  uint64_t out;
  asm("mapa.u64 %0, %1, %2;" : "=l"(out) : "l"(p), "r"(rank));
  return reinterpret_cast<T*>(out);
}

// ---- programmatic dependent launch ----------------------------------------

// wait until the grids this one depends on have finished and their writes
// are visible (a no-op for a launch without the attribute)
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
// let the next launch on the stream start its blocks
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// ---- host: one launch ------------------------------------------------------

// kern<<<grid, block, smem, stream>>>(args...) through cudaLaunchKernelEx,
// with programmatic stream serialization (the kernel may start while the
// previous launch on the stream finishes; it calls grid_dependency_wait()
// before reading what that launch wrote) and, for cluster > 1, clusters of
// `cluster` CTAs along x. Returns the launch's cudaError_t.
template <typename... P, typename... A>
cudaError_t launch(void (*kern)(P...), dim3 grid, dim3 block, size_t smem, cudaStream_t stream,
                   unsigned cluster, A&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute at[2];
  unsigned n = 0;
  at[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at[n].val.programmaticStreamSerializationAllowed = 1;
  ++n;
  if (cluster > 1) {
    at[n].id = cudaLaunchAttributeClusterDimension;
    at[n].val.clusterDim.x = cluster;
    at[n].val.clusterDim.y = 1;
    at[n].val.clusterDim.z = 1;
    ++n;
  }
  cfg.attrs = at;
  cfg.numAttrs = n;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, std::forward<A>(args)...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// kern may take `smem` bytes of dynamic shared memory on the current
// device: the attribute is set when the size grows past what was set there
// before, so a steady caller pays for it once. allowed[] holds, per device,
// what was set there (0 before the first call).
constexpr int kMaxDevices = 64;
template <typename... P>
cudaError_t allow_smem(void (*kern)(P...), size_t smem, size_t (&allowed)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && smem <= allowed[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && dev < kMaxDevices) allowed[dev] = smem;
  return e;
}

// how many clusters of `cluster` CTAs of kern (threads each, smem bytes of
// dynamic shared memory) the card holds at once; -1 on an error
template <typename... P>
int max_active_clusters(void (*kern)(P...), unsigned threads, size_t smem, unsigned cluster) {
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
      cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * 256);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute at;
  at.id = cudaLaunchAttributeClusterDimension;
  at.val.clusterDim.x = cluster;
  at.val.clusterDim.y = 1;
  at.val.clusterDim.z = 1;
  cfg.attrs = &at;
  cfg.numAttrs = 1;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, kern, &cfg) == cudaSuccess ? n : -1;
}

}  // namespace hopper
