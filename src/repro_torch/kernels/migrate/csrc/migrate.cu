// Batched page migration, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/migrate/kernel.py
// (migrate_kernel): the data plane of the paper's §4.4 batched migration,
//
//   dst[dst_idx[i]] = src[src_idx[i]]   for every i < M with valid[i],
//
// one launch per batch, destination updated in place, over up to
// MAX_POOLS pools that share the index tables (the serving layer's K and
// V pools move together).  A row is one page: ``row_bytes`` contiguous
// bytes of any element type.  Build:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libmigrate.so migrate.cu
//
// Bound: bytes.  Each valid entry reads one row and writes one row and
// does no arithmetic.  Design: grid (chunk, entry, pool); each block copies
// one CHUNK_BYTES slice of one row with 16-byte loads and stores when the
// row and both base pointers are 16-byte aligned (else 4 or 1 bytes), so
// a batch of a few 512 KiB pages still spreads over every SM.  Invalid
// entries return before touching memory: unlike the TPU kernel they do
// not read slot 0 and write it back, so the caller may pass -1 there.  An
// entry whose source or destination row is out of range is skipped like
// an invalid one, so no index can reach memory outside the pools.
// Valid destination rows of one launch are unique and, when source and
// destination are the same tensor, disjoint from the source rows (the
// pool's invariants), so the blocks never race.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_POOLS 4
#define MIGRATE_THREADS 256
#define CHUNK_BYTES 32768

struct Pools {
  const char* src[MAX_POOLS];
  char* dst[MAX_POOLS];
};

template <typename V>
__device__ __forceinline__ void copy_words(const char* __restrict__ s,
                                           char* __restrict__ d,
                                           int64_t begin, int64_t end) {
  const V* sv = reinterpret_cast<const V*>(s);
  V* dv = reinterpret_cast<V*>(d);
  for (int64_t w = begin / (int64_t)sizeof(V) + threadIdx.x;
       w < end / (int64_t)sizeof(V); w += blockDim.x)
    dv[w] = sv[w];
}

__global__ void migrate_kernel(Pools pools, const int* __restrict__ src_idx,
                               const int* __restrict__ dst_idx,
                               const bool* __restrict__ valid,
                               int64_t row_bytes, int src_rows, int dst_rows,
                               int width) {
  const int i = blockIdx.y;
  const int si = src_idx[i], di = dst_idx[i];
  if (!valid[i] || si < 0 || si >= src_rows || di < 0 || di >= dst_rows)
    return;
  const int64_t begin = (int64_t)blockIdx.x * CHUNK_BYTES;
  if (begin >= row_bytes) return;
  const int64_t end =
      begin + CHUNK_BYTES < row_bytes ? begin + CHUNK_BYTES : row_bytes;
  const int p = blockIdx.z;
  const char* s = pools.src[p] + (int64_t)si * row_bytes;
  char* d = pools.dst[p] + (int64_t)di * row_bytes;
  if (width == 16)
    copy_words<uint4>(s, d, begin, end);
  else if (width == 4)
    copy_words<uint32_t>(s, d, begin, end);
  else
    copy_words<uint8_t>(s, d, begin, end);
}

extern "C" int arms_migrate(void* const* src, void* const* dst, int n_pools,
                            const int* src_idx, const int* dst_idx,
                            const bool* valid, int M, int64_t row_bytes,
                            int src_rows, int dst_rows, cudaStream_t stream) {
  if (n_pools < 1 || n_pools > MAX_POOLS || M < 0 || row_bytes < 0)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || row_bytes == 0) return (int)cudaGetLastError();
  Pools pools;
  uintptr_t align = (uintptr_t)row_bytes;
  for (int p = 0; p < MAX_POOLS; ++p) {
    pools.src[p] = p < n_pools ? (const char*)src[p] : nullptr;
    pools.dst[p] = p < n_pools ? (char*)dst[p] : nullptr;
    if (p < n_pools) align |= (uintptr_t)src[p] | (uintptr_t)dst[p];
  }
  const int width = (align % 16 == 0) ? 16 : (align % 4 == 0) ? 4 : 1;
  const int64_t chunks = (row_bytes + CHUNK_BYTES - 1) / CHUNK_BYTES;
  if (chunks > 2147483647LL || M > 65535) return (int)cudaErrorInvalidValue;
  migrate_kernel<<<dim3((unsigned)chunks, M, n_pools), MIGRATE_THREADS, 0,
                   stream>>>(pools, src_idx, dst_idx, valid, row_bytes,
                             src_rows, dst_rows, width);
  return (int)cudaGetLastError();
}
