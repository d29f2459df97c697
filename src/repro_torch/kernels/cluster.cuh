// Thread-block cluster launches shared by the port's CUDA sources
// (included by csrc/*.cu of interval_step and paged_attention).
//
// A kernel that spreads one unit of work (a lane, a row, a sequence and KV
// head) over a cluster of C CTAs launches on a grid of C x units with the
// cluster attribute; clusters of more than 8 CTAs need the non-portable
// opt-in.  best_cluster picks C from the device's cluster occupancy: the
// most CTAs at which every unit's cluster runs at once, since past that the
// clusters run in two waves and the time doubles.
#pragma once

#include <cuda_runtime.h>

// Cluster barrier, split: arrive (relaxed: orders nothing; release: this
// thread's writes, shared memory of other CTAs included, before the wait of
// every thread of the cluster) and wait (acquire).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A launch of `cluster` CTAs a unit over `units` units (grid cluster x
// units) of `threads` threads and `smem` bytes of dynamic shared memory.
// `slice` (what a CTA takes) and `mode` (a launcher's own switch: for
// top-k whether the slice stays in shared memory, for paged attention
// whether rows load in 16-byte words) are set by the kernel's launcher.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const void* kernel;
  int slice, mode;
};

template <typename Kernel>
static cudaError_t cluster_config(Kernel kernel, int units, int cluster,
                                  int threads, size_t smem,
                                  cudaStream_t stream, ClusterLaunch* L) {
  L->kernel = (const void*)kernel;
  cudaError_t err = cudaFuncSetAttribute(
      L->kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(
        L->kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  L->cfg = cudaLaunchConfig_t{};
  L->cfg.gridDim = dim3(cluster, units);
  L->cfg.blockDim = dim3(threads);
  L->cfg.dynamicSmemBytes = smem;
  L->cfg.stream = stream;
  L->attr[0].id = cudaLaunchAttributeClusterDimension;
  L->attr[0].val.clusterDim.x = cluster;
  L->attr[0].val.clusterDim.y = 1;
  L->attr[0].val.clusterDim.z = 1;
  L->cfg.attrs = L->attr;
  L->cfg.numAttrs = 1;
  return err;
}

// The CTAs a unit takes: the most, 2..max_c (at most 16), at which the
// device holds all `units` clusters (as `launch(c, &L)` configures them) at
// once; 1 where it holds none of those.  A size the launcher refuses does
// not fit; when it refuses one CTA a unit, so is the shape (its error).
template <typename Launch>
static int best_cluster(Launch launch, int units, int max_c, int* cluster) {
  ClusterLaunch L;
  cudaError_t err = launch(1, &L);
  if (err != cudaSuccess) return (int)err;
  *cluster = 1;
  for (int c = 2; c <= 16 && c <= max_c; ++c) {
    if (launch(c, &L) != cudaSuccess) continue;
    int active = 0;
    err = cudaOccupancyMaxActiveClusters(&active, L.kernel, &L.cfg);
    if (err != cudaSuccess) return (int)err;
    if (active >= units) *cluster = c;
  }
  return (int)cudaSuccess;
}

// The most CTAs a unit of n elements may take with slices of at least
// `min_slice` elements (1 when even two would be short).
static inline int max_cluster_for_slice(int n, int min_slice) {
  int c = 1;
  while (c < 16 && (n + c) / (c + 1) >= min_slice) ++c;
  return c;
}
