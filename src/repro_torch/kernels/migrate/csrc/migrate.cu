// A migration fire in one launch, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/migrate/kernel.py
// (migrate_kernel): the data plane of the paper's §4.4 batched migration.
// One fire of the tiered pool moves, for every pool p (a buffer: the K or
// V pages, an expert weight) and every fast slot s < k,
//
//   home[p][out_row[s]] = fast[p][s]    (the demotions' copy-back), then
//   fast[p][s] = home[p][in_row[s]]     (the promotions),
//
// where an entry that is -1 or out of range moves nothing.  A pool is a
// fast base of k rows and a home base of home_rows rows with its own
// row_bytes (any element type): the fused [k + n, ...] tensor of the
// serving layer (home = fast + k rows), or a home in pinned host memory,
// which the kernel reads and writes over the host link through its mapped
// device address.  The pools of one fire may differ in row shape (an
// expert's wi and wo).  Build:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libmigrate.so migrate.cu
//
// Bound: bytes.  Each move reads one row and writes one row and does no
// arithmetic.  At the serving fold a fire is 4 MiB and the launch's fixed
// cost dominates, so the whole fire is one launch; at the expert slabs it
// is hundreds of MB and HBM's rate is the limit.
//
// Design.  A work item is (pool, slot, chunk of CHUNK bytes or less);
// blocks walk the item list with a grid stride (at most the blocks that fit
// on the card at once).  256 threads a block, each keeping UNROLL
// independent loads of 16 bytes (4 or 1 where a row or base is not 16-byte
// aligned) of each half in flight: a thread loads words w of fast slot s
// (the demotion) and of home row in_row[s] (the promotion), the block
// passes __syncthreads(), and the thread stores them to home row
// out_row[s] and to slot s.  Invariants that make one launch race-free:
//   * every word of slot s is read and then written by one thread, in that
//     order, so a promotion into a slot that a demotion of the same fire
//     vacates never overwrites bytes that are still to be copied out;
//   * one item a (pool, slot, chunk), so no other block touches those
//     bytes;
//   * the demotions write home rows of pages that were fast and the
//     promotions read home rows of pages that were slow: the pool keeps
//     these disjoint (the wrapper's contract), so the two halves never race
//     across blocks.
// The host halves the chunk (down to MIN_CHUNK) while the items still fit
// on the card in one wave, so a small fire spreads over every SM.  The
// launch is on the caller's stream; it allocates and synchronises nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_POOLS 8
#define FIRE_THREADS 256
#define FIRE_MIN_BLOCKS 4   // caps registers: 4 blocks of 256 on an SM
#define UNROLL 4
#define CHUNK 16384        // bytes an item moves each way, at most
#define MIN_CHUNK 4096     // ... and at least, where a row has that many
#define MAX_DEVICES 64

struct FirePool {
  char* fast;          // k rows
  char* home;          // home_rows rows (a device address)
  int64_t row_bytes;
  int64_t chunks;      // items a slot of this pool spans
  int64_t first;       // the pool's first item
  int home_rows;
  int width;           // bytes a load moves: 16, 4 or 1
};

struct FirePlan {
  FirePool pool[MAX_POOLS];
  int n_pools;
  int64_t items;
  int64_t chunk;
};

// One item, decoded: the bytes [begin, end) of slot s's row in pool p.
struct Item {
  const FirePool* q;
  int s, out, in;      // out / in: the home rows, -1 where none
  int64_t begin, end;
};

__device__ __forceinline__ bool decode(const FirePlan& plan, int64_t item,
                                       const int* out_row, const int* in_row,
                                       Item& it) {
  int p = 0;
  while (p + 1 < plan.n_pools && item >= plan.pool[p + 1].first) ++p;
  const FirePool& q = plan.pool[p];
  const int64_t local = item - q.first;
  const int s = (int)(local / q.chunks);
  const int o = out_row[s], i = in_row[s];
  it.q = &q;
  it.s = s;
  it.out = (o >= 0 && o < q.home_rows) ? o : -1;
  it.in = (i >= 0 && i < q.home_rows) ? i : -1;
  it.begin = (local - (int64_t)s * q.chunks) * plan.chunk;
  it.end = it.begin + plan.chunk < q.row_bytes ? it.begin + plan.chunk
                                               : q.row_bytes;
  return it.out >= 0 || it.in >= 0;
}

// Words [begin, end) of the slot's row: loads of both halves, a barrier,
// stores of both.  No __restrict__: the slot is read and then written.
template <typename V>
__device__ __forceinline__ void move_words(const Item& it) {
  const int64_t rb = it.q->row_bytes;
  V* slot = reinterpret_cast<V*>(it.q->fast + (int64_t)it.s * rb);
  V* out = it.out >= 0
               ? reinterpret_cast<V*>(it.q->home + (int64_t)it.out * rb)
               : nullptr;
  const V* in =
      it.in >= 0 ? reinterpret_cast<const V*>(it.q->home + (int64_t)it.in * rb)
                 : nullptr;
  const int64_t w1 = it.end / (int64_t)sizeof(V);
  for (int64_t base = it.begin / (int64_t)sizeof(V); base < w1;
       base += UNROLL * FIRE_THREADS) {
    V o[UNROLL], v[UNROLL];
#pragma unroll
    for (int r = 0; r < UNROLL; ++r) {
      const int64_t w = base + r * FIRE_THREADS + threadIdx.x;
      if (w < w1) {
        if (out) o[r] = slot[w];
        if (in) v[r] = in[w];
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < UNROLL; ++r) {
      const int64_t w = base + r * FIRE_THREADS + threadIdx.x;
      if (w < w1) {
        if (out) out[w] = o[r];
        if (in) slot[w] = v[r];
      }
    }
  }
}

__global__ void __launch_bounds__(FIRE_THREADS, FIRE_MIN_BLOCKS)
    migrate_fire_kernel(const __grid_constant__ FirePlan plan,
                        const int* __restrict__ out_row,
                        const int* __restrict__ in_row) {
  for (int64_t item = blockIdx.x; item < plan.items; item += gridDim.x) {
    Item it;
    if (!decode(plan, item, out_row, in_row, it)) continue;
    if (it.q->width == 16)
      move_words<uint4>(it);
    else if (it.q->width == 4)
      move_words<uint32_t>(it);
    else
      move_words<uint8_t>(it);
  }
}

// ------------------------------------------------------------------- host
// Device facts asked once per device: SMs, and the fire kernel's blocks
// that fit on an SM at once.
static int g_sms[MAX_DEVICES], g_fit[MAX_DEVICES];

static cudaError_t device_facts(int* sms, int* fit) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (g_sms[dev] == 0) {
    int n = 0, a = 0;
    if ((err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &a, migrate_fire_kernel, FIRE_THREADS, 0)) != cudaSuccess)
      return err;
    g_fit[dev] = a > 0 ? a : 1;
    g_sms[dev] = n > 0 ? n : 1;
  }
  *sms = g_sms[dev];
  *fit = g_fit[dev];
  return cudaSuccess;
}

static int64_t count_items(FirePlan& plan, int k, int64_t chunk) {
  int64_t items = 0;
  plan.chunk = chunk;
  for (int p = 0; p < plan.n_pools; ++p) {
    FirePool& q = plan.pool[p];
    q.chunks = (q.row_bytes + chunk - 1) / chunk;
    q.first = items;
    items += q.chunks * k;
  }
  plan.items = items;
  return items;
}

// One fire over n_pools pools (see the top of the file).  home_on_host[p]
// marks a home in pinned host memory, whose device address is looked up
// here.  *launched gets 1 where the fire launched, 0 where it had nothing
// to launch (k = 0 or rows of 0 bytes).
extern "C" int arms_migrate_fire(void* const* fasts, void* const* homes,
                                 const int* home_on_host,
                                 const int64_t* row_bytes,
                                 const int* home_rows, int n_pools,
                                 const int* out_row, const int* in_row, int k,
                                 int* launched, cudaStream_t stream) {
  *launched = 0;
  if (n_pools < 1 || n_pools > MAX_POOLS || k < 0)
    return (int)cudaErrorInvalidValue;
  FirePlan plan;
  plan.n_pools = n_pools;
  for (int p = 0; p < n_pools; ++p) {
    if (row_bytes[p] < 0 || home_rows[p] < 0)
      return (int)cudaErrorInvalidValue;
    FirePool& q = plan.pool[p];
    q.fast = (char*)fasts[p];
    q.home = (char*)homes[p];
    if (home_on_host[p]) {
      cudaPointerAttributes a;
      cudaError_t err = cudaPointerGetAttributes(&a, homes[p]);
      if (err != cudaSuccess) return (int)err;
      if (a.type != cudaMemoryTypeHost || a.devicePointer == nullptr)
        return (int)cudaErrorInvalidHostPointer;
      q.home = (char*)a.devicePointer;
    }
    q.row_bytes = row_bytes[p];
    q.home_rows = home_rows[p];
    const uintptr_t align =
        (uintptr_t)row_bytes[p] | (uintptr_t)q.fast | (uintptr_t)q.home;
    q.width = (align % 16 == 0) ? 16 : (align % 4 == 0) ? 4 : 1;
  }
  int sms = 0, fit = 0;
  cudaError_t err = device_facts(&sms, &fit);
  if (err != cudaSuccess) return (int)err;
  // the smallest chunk whose items still fit on the card in one wave
  const int64_t wave = (int64_t)sms * fit;
  int64_t chunk = CHUNK;
  int64_t items = count_items(plan, k, chunk);
  while (chunk > MIN_CHUNK && items > 0 && 2 * items <= wave)
    items = count_items(plan, k, chunk /= 2);
  if (items == 0) return (int)cudaGetLastError();
  const unsigned grid = (unsigned)(items < wave ? items : wave);
  migrate_fire_kernel<<<grid, FIRE_THREADS, 0, stream>>>(plan, out_row,
                                                         in_row);
  err = cudaGetLastError();
  if (err == cudaSuccess) *launched = 1;
  return (int)err;
}
