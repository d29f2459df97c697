// Interval-step kernels of the scan engine, hand-written for Hopper (sm_90a).
//
// Four kernels, each replacing one Pallas TPU kernel of
// src/repro/kernels/interval_step/kernel.py, with a plain C interface for
// ctypes (kernel.py).  Every entry point launches on the stream it is given
// and returns cudaGetLastError().  Build:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libinterval_step.so interval_step.cu
//
// -fmad=false is part of the contract: every f32 product and sum rounds
// exactly where the plain versions (ref.py) round it.  The only fused
// multiply-adds are the explicit __fmaf_rn of the EWMA, placed where the
// JAX engine's compiled code fuses them; the EWMA scores feed an exact
// ranking, so one rounding more or less could move a page across the
// top-k boundary.
//
// All four are bound by device memory on this card, not by arithmetic:
// each reads its [B, n] rows once or a few times and does a handful of
// operations per element.  What each design does about that is noted above
// the kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_TIERS 8
#define ACCOUNT_THREADS 512
#define MIGRATE_THREADS 512
#define TOPK_THREADS 1024

static const float kPageBytes = 2097152.0f;  // PAGE_BYTES
static const float kCacheline = 64.0f;       // CACHELINE

// Order key of lax.top_k's total order on f32: sign bit set -> ~u, else
// u | 0x80000000 (so +0.0 ranks strictly above -0.0).
__device__ __forceinline__ uint32_t order_key(float x) {
  uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// -------------------------------------------------------------------- ewma
// Replaces kernel.py:ewma_update_kernel (_ewma_body) and, with one lane,
// repro/kernels/score_update/kernel.py:score_update_kernel.  Bound: bytes,
// 3 rows read + 3 written.  Design: one elementwise pass, grid (x over
// pages, y over lanes) so each block reads its lane's 4 params once;
// consecutive threads touch consecutive words (16-byte loads were measured
// slower at the replay's 16 x 65,536).
__global__ void ewma_update_kernel(const float* __restrict__ params,
                                   const float* __restrict__ s,
                                   const float* __restrict__ l,
                                   const float* __restrict__ c,
                                   float* __restrict__ s_out,
                                   float* __restrict__ l_out,
                                   float* __restrict__ score_out, int n) {
  const int b = blockIdx.y;
  const float a_s = params[4 * b + 0], a_l = params[4 * b + 1];
  const float w_s = params[4 * b + 2], w_l = params[4 * b + 3];
  const float one_a_s = 1.0f - a_s, one_a_l = 1.0f - a_l;
  const int64_t base = (int64_t)b * n;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const float ci = c[base + i];
    const float sn = __fmaf_rn(a_s, ci, one_a_s * s[base + i]);
    const float ln = __fmaf_rn(a_l, ci, one_a_l * l[base + i]);
    s_out[base + i] = sn;
    l_out[base + i] = ln;
    score_out[base + i] = __fmaf_rn(w_s, sn, w_l * ln);
  }
}

extern "C" int arms_ewma_update(const float* params, const float* s,
                                const float* l, const float* c, float* s_out,
                                float* l_out, float* score_out, int B, int n,
                                cudaStream_t stream) {
  // a thread a page; past 16,384 blocks a lane the threads loop (a cap of
  // 512 left the single-row score update at 2^24 pages 16 % slower)
  int gx = (n + 255) / 256;
  if (gx > 16384) gx = 16384;
  ewma_update_kernel<<<dim3(gx, B), 256, 0, stream>>>(params, s, l, c, s_out,
                                                      l_out, score_out, n);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------- block helpers
__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the block; the result is valid in thread 0.  `scratch` holds
// one slot per warp; the call ends with a barrier so it can be reused.
template <typename T>
__device__ T block_sum(T v, T* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  T out = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) out += scratch[w];
  __syncthreads();
  return out;
}

// -------------------------------------------------------------- accounting
// Replaces kernel.py:interval_account_kernel (_account_body).  Bound:
// bytes — the true row (f32), the tier row (i32) and the oracle row (u8)
// read once per lane.  Design: one block per lane; each thread accumulates
// the R-1 masked sums and the total in f64 (the plain version's rounding:
// exact sums, one rounding to f32, so the result does not depend on the
// reduction order) and the recall count in int; block reductions; thread 0
// runs the scalar epilogue of the Pallas body in f32, op for op.  In trace
// mode `true` and `oracle` are one row shared by all lanes: their lane
// stride is 0 and the lanes' reads hit L2.
__global__ void interval_account_kernel(
    const float* __restrict__ lat, const float* __restrict__ br,
    const float* __restrict__ bw, const float* __restrict__ mlp,
    const float* __restrict__ true_, int64_t true_stride,
    const int* __restrict__ tier, const float* __restrict__ mig_up,
    const float* __restrict__ mig_down, const uint8_t* __restrict__ oracle,
    int64_t oracle_stride, float* __restrict__ out, int n, int R, int k) {
  __shared__ double s_d[32];
  __shared__ int s_i[32];
  const int b = blockIdx.x;
  const float* row = true_ + b * true_stride;
  const int* trow = tier + (int64_t)b * n;
  const uint8_t* orow = oracle + b * oracle_stride;

  double total = 0.0, acc[MAX_TIERS - 1];
#pragma unroll
  for (int r = 0; r < MAX_TIERS - 1; ++r) acc[r] = 0.0;
  int hits = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const double v = (double)row[i];
    const int t = trow[i];
    total += v;
#pragma unroll
    for (int r = 0; r < MAX_TIERS - 1; ++r)
      if (r < R - 1 && t == r) acc[r] += v;
    hits += (t == 0 && orow[i] != 0) ? 1 : 0;
  }
  total = block_sum(total, s_d);
#pragma unroll
  for (int r = 0; r < MAX_TIERS - 1; ++r)
    if (r < R - 1) acc[r] = block_sum(acc[r], s_d);
  hits = block_sum(hits, s_i);
  if (threadIdx.x != 0) return;

  const float* L = lat + b * R;
  const float* BR = br + b * R;
  const float* BW = bw + b * R;
  const float* up = mig_up + b * (R - 1);
  const float* down = mig_down + b * (R - 1);
  float accs[MAX_TIERS], times[MAX_TIERS];
  float rest = (float)total;
  for (int r = 0; r < R - 1; ++r) {
    accs[r] = (float)acc[r];
    rest = rest - accs[r];
  }
  accs[R - 1] = rest;

  float t_lat = accs[0] * L[0];
  for (int r = 1; r < R; ++r) t_lat = t_lat + accs[r] * L[r];
  t_lat = t_lat * 1e-9f / mlp[b];

  times[0] = (accs[0] * kCacheline + (up[0] + down[0]) * kPageBytes) / BR[0];
  for (int r = 1; r < R; ++r) {
    float rd = up[r - 1];
    if (r < R - 1) rd = rd + down[r];
    float wr = down[r - 1];
    if (r < R - 1) wr = wr + up[r];
    times[r] = (accs[r] * kCacheline + rd * kPageBytes) / BR[r] +
               wr * kPageBytes / BW[r];
  }
  float rest_max = times[1];
  for (int r = 2; r < R; ++r) rest_max = fmaxf(rest_max, times[r]);
  const float wall =
      fmaxf(fmaxf(t_lat, times[0]), fmaxf(rest_max, 1e-12f));
  float rest_acc = accs[1];
  for (int r = 2; r < R; ++r) rest_acc = rest_acc + accs[r];

  float* o = out + 6 * b;
  o[0] = accs[0];
  o[1] = rest_acc;
  o[2] = wall;
  o[3] = rest_acc / fmaxf(accs[0] + rest_acc, 1e-9f);
  o[4] = times[0] / fmaxf(t_lat, fmaxf(rest_max, 1e-12f));
  o[5] = (float)hits / (float)k;
}

extern "C" int arms_interval_account(
    const float* lat, const float* br, const float* bw, const float* mlp,
    const float* true_, int64_t true_stride, const int* tier,
    const float* mig_up, const float* mig_down, const uint8_t* oracle,
    int64_t oracle_stride, float* out, int B, int n, int R, int k,
    cudaStream_t stream) {
  interval_account_kernel<<<B, ACCOUNT_THREADS, 0, stream>>>(
      lat, br, bw, mlp, true_, true_stride, tier, mig_up, mig_down, oracle,
      oracle_stride, out, n, R, k);
  return (int)cudaGetLastError();
}

// -------------------------------------------------------------- migrations
// Replaces kernel.py:tier_migrate_kernel (_migrate_body).  Bound: bytes —
// the tier row read once and written once per lane; the plans (P, D <= a
// few dozen entries) are negligible.  Design: one block per lane.  All
// threads copy the row and count tier occupancy (block reduction); the
// plan's page gathers are done in parallel into shared memory; the
// order-dependent passes of the Pallas body (departures, landing, the
// promotion rank) run in one thread over shared memory, which is a few
// dozen steps; the scatters are parallel again (valid pages of one lane
// are unique: the padded-index contract).
__global__ void tier_migrate_kernel(const int* __restrict__ tier,
                                    const int* __restrict__ promote,
                                    const int* __restrict__ demote,
                                    const int* __restrict__ caps,
                                    int* __restrict__ tier_out,
                                    uint8_t* __restrict__ pexec,
                                    uint8_t* __restrict__ dexec,
                                    int* __restrict__ mig_up,
                                    int* __restrict__ mig_down, int n, int R,
                                    int P, int D) {
  extern __shared__ int smem[];
  int* s_dem = smem;          // [D] demote entries
  int* s_dsrc = s_dem + D;    // [D] their source tiers
  int* s_dest = s_dsrc + D;   // [D] landing tier, -1 if not executed
  int* s_prom = s_dest + D;   // [P] promote entries
  int* s_psrc = s_prom + P;   // [P] their source tiers after demotions
  int* s_pex = s_psrc + P;    // [P] executed flags
  __shared__ int s_occ[MAX_TIERS];
  __shared__ int s_warp[32];

  const int b = blockIdx.x;
  const int* row = tier + (int64_t)b * n;
  int* orow = tier_out + (int64_t)b * n;
  const int* prow = promote + (int64_t)b * P;
  const int* drow = demote + (int64_t)b * D;
  const int* cap = caps + b * R;

  int occ[MAX_TIERS];
#pragma unroll
  for (int r = 0; r < MAX_TIERS; ++r) occ[r] = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int t = row[i];
    orow[i] = t;
#pragma unroll
    for (int r = 0; r < MAX_TIERS; ++r) occ[r] += (r < R && t == r) ? 1 : 0;
  }
#pragma unroll
  for (int r = 0; r < MAX_TIERS; ++r) {
    if (r < R) {
      const int v = block_sum(occ[r], s_warp);
      if (threadIdx.x == 0) s_occ[r] = v;
    }
  }
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const int d = drow[i];
    s_dem[i] = d;
    s_dsrc[i] = row[d >= 0 ? d : 0];
  }
  for (int i = threadIdx.x; i < P; i += blockDim.x) s_prom[i] = prow[i];
  __syncthreads();

  // departures + landing tiers (sources from the ORIGINAL placement).
  if (threadIdx.x == 0) {
    int dep[MAX_TIERS], slack[MAX_TIERS], land[MAX_TIERS];
    for (int r = 0; r < R; ++r) dep[r] = land[r] = 0;
    for (int i = 0; i < D; ++i) {
      const int src = s_dsrc[i];
      if (s_dem[i] >= 0 && src < R - 1) dep[src] += 1;
    }
    for (int r = 1; r < R - 1; ++r) slack[r] = cap[r] - (s_occ[r] - dep[r]);
    int down[MAX_TIERS], occ0 = s_occ[0];
    for (int j = 0; j < R - 1; ++j) down[j] = 0;
    for (int i = 0; i < D; ++i) {
      const int src = s_dsrc[i];
      const bool dx = s_dem[i] >= 0 && src < R - 1;
      int dest = R - 1;
      for (int r = R - 2; r > 0; --r)  // lowest r > src with room wins
        if (src < r && slack[r] - land[r] > 0) dest = r;
      if (!dx) dest = R - 1;
      s_dest[i] = dx ? dest : -1;
      if (dx) {
        land[dest] += 1;
        if (src == 0) occ0 -= 1;
        for (int j = 0; j < R - 1; ++j)
          if (src <= j && dest > j) down[j] += 1;
      }
    }
    for (int j = 0; j < R - 1; ++j) mig_down[b * (R - 1) + j] = down[j];
    s_occ[0] = occ0;  // tier-0 occupancy after demotions
  }
  __syncthreads();
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const int dest = s_dest[i];
    dexec[(int64_t)b * D + i] = dest >= 0 ? 1 : 0;
    if (dest >= 0) orow[s_dem[i]] = dest;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const int p = s_prom[i];
    s_psrc[i] = orow[p >= 0 ? p : 0];
  }
  __syncthreads();

  // promotion rank: every valid request counts, executed ones fit the room.
  if (threadIdx.x == 0) {
    const int room0 = cap[0] - s_occ[0];
    int up[MAX_TIERS], cnt = 0;
    for (int j = 0; j < R - 1; ++j) up[j] = 0;
    for (int i = 0; i < P; ++i) {
      const int src = s_psrc[i];
      const bool ok = s_prom[i] >= 0 && src > 0;
      const bool ex = ok && cnt < room0;
      s_pex[i] = ex ? 1 : 0;
      if (ex)
        for (int j = 0; j < R - 1; ++j)
          if (src > j) up[j] += 1;
      cnt += ok ? 1 : 0;
    }
    for (int j = 0; j < R - 1; ++j) mig_up[b * (R - 1) + j] = up[j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    pexec[(int64_t)b * P + i] = (uint8_t)s_pex[i];
    if (s_pex[i]) orow[s_prom[i]] = 0;
  }
}

extern "C" int arms_tier_migrate(const int* tier, const int* promote,
                                 const int* demote, const int* caps,
                                 int* tier_out, uint8_t* pexec, uint8_t* dexec,
                                 int* mig_up, int* mig_down, int B, int n,
                                 int R, int P, int D, cudaStream_t stream) {
  const size_t smem = sizeof(int) * (3 * (size_t)D + 3 * (size_t)P);
  tier_migrate_kernel<<<B, MIGRATE_THREADS, smem, stream>>>(
      tier, promote, demote, caps, tier_out, pexec, dexec, mig_up, mig_down,
      n, R, P, D);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- top-k
// Replaces kernel.py:topk_mask_kernel (_topk_body).  Bound: bytes — one
// f32 row read and one bool row written per lane.  Design: radix select,
// one block per row.  A 65,536-wide row is 256 KiB, more than a block's
// shared memory, so the row stays in device memory (and L2) and is read
// 5 times: 4 passes of an 8-bit shared-memory histogram over the order
// key, each narrowing the prefix of the k-th largest key, then a pass in
// index order that writes the mask, ranking the keys equal to the
// threshold with a block-wide ballot scan so the lowest indices win ties.
__global__ void topk_mask_kernel(const float* __restrict__ x,
                                 uint8_t* __restrict__ mask, int n, int k) {
  __shared__ unsigned int hist[256];
  __shared__ uint32_t s_prefix;
  __shared__ int s_remaining;
  __shared__ int s_warp[32];

  const int b = blockIdx.x;
  const float* row = x + (int64_t)b * n;
  uint8_t* out = mask + (int64_t)b * n;

  uint32_t prefix = 0, prefix_mask = 0;
  int remaining = k;  // still to select among keys matching the prefix
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) hist[i] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const uint32_t key = order_key(row[i]);
      if ((key & prefix_mask) == prefix) atomicAdd(&hist[(key >> shift) & 255u], 1u);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int above = 0, d = 255;
      for (; d > 0; --d) {
        const int c = (int)hist[d];
        if (above + c >= remaining) break;
        above += c;
      }
      s_prefix = prefix | ((uint32_t)d << shift);
      s_remaining = remaining - above;
    }
    __syncthreads();
    prefix = s_prefix;
    remaining = s_remaining;
    prefix_mask |= 255u << shift;
    __syncthreads();
  }
  // prefix is now the k-th largest key; `remaining` of the keys equal to it
  // are selected, lowest index first.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int taken = 0;
  for (int start = 0; start < n; start += blockDim.x) {
    const int i = start + threadIdx.x;
    uint32_t key = 0;
    if (i < n) key = order_key(row[i]);
    const bool eq = i < n && key == prefix;
    const unsigned ballot = __ballot_sync(0xffffffffu, eq);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int before = taken + __popc(ballot & ((1u << lane) - 1u)), chunk = 0;
    for (int w = 0; w < nwarps; ++w) {
      if (w < warp) before += s_warp[w];
      chunk += s_warp[w];
    }
    if (i < n) out[i] = (key > prefix || (eq && before < remaining)) ? 1 : 0;
    taken += chunk;
    __syncthreads();
  }
}

extern "C" int arms_topk_mask(const float* x, uint8_t* mask, int B, int n,
                              int k, cudaStream_t stream) {
  topk_mask_kernel<<<B, TOPK_THREADS, 0, stream>>>(x, mask, n, k);
  return (int)cudaGetLastError();
}
