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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define MAX_TIERS 8
#define MIGRATE_THREADS 512

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
// read once per lane, 9 bytes a page; at the replay's 16 x 65,536 (one
// true and oracle row shared by the lanes) that is 1.35 us at the HBM
// rate, so the floor in practice is a launch and a few memory latencies.
// Design: each lane on a thread-block cluster of C CTAs, C the most (up to
// the non-portable 16, slices of at least ACCOUNT_MIN_SLICE pages) at which
// the device holds all B clusters at once (cudaOccupancyMaxActiveClusters,
// arms_account_cluster), so a lane's pages are read by up to 16 SMs and
// not one, even at B 1.  Each CTA takes a contiguous slice: 16-byte loads of
// the true and tier rows and one 4-byte word of four oracle bytes where
// the lane's rows allow them (a scalar ragged tail), ACCOUNT_ILP of a
// thread's loads in flight.  Each thread accumulates the R-1 masked sums
// and the total in f64, rounded once to f32 as the plain version rounds
// its f64 sums (the two sum in different orders, so the f64 sums are not
// exact and may differ; their error lies far below half an f32 ulp, so
// the f32 results agree unless a sum lands within it of a rounding
// boundary), and the recall count as an int; one warp-shuffle
// pass reduces them all, then one barrier and one pass over the warps;
// rank 0 sums the CTAs' partials through distributed shared memory in
// rank order and runs the scalar epilogue of the Pallas body in f32, op
// for op.  Every sum runs in a fixed order, with no atomics.  In trace mode
// `true` and `oracle` are one row shared by all lanes: their lane stride is
// 0 and the lanes' reads hit L2.
#define ACCOUNT_THREADS 256
#define ACCOUNT_ILP 4            // 16-byte words of a thread in flight
#define ACCOUNT_MIN_SLICE 1024   // fewest pages a CTA of a cluster takes

// One page into a thread's sums: acc[0] the total, acc[1 + r] tier r's.
__device__ __forceinline__ void account_page(double (&acc)[MAX_TIERS],
                                             int& hits, float x, int t,
                                             bool hot, int R) {
  const double v = (double)x;
  acc[0] += v;
#pragma unroll
  for (int r = 0; r < MAX_TIERS - 1; ++r)
    if (r < R - 1 && t == r) acc[1 + r] += v;
  hits += (t == 0 && hot) ? 1 : 0;
}

__global__ void __launch_bounds__(ACCOUNT_THREADS)
    interval_account_kernel(
        const float* __restrict__ lat, const float* __restrict__ br,
        const float* __restrict__ bw, const float* __restrict__ mlp,
        const float* __restrict__ true_, int64_t true_stride,
        const int* __restrict__ tier, const float* __restrict__ mig_up,
        const float* __restrict__ mig_down,
        const uint8_t* __restrict__ oracle, int64_t oracle_stride,
        float* __restrict__ out, int n, int R, int k, int slice) {
  __shared__ double s_warp[ACCOUNT_THREADS / 32][MAX_TIERS];
  __shared__ int s_whits[ACCOUNT_THREADS / 32];
  __shared__ double s_part[MAX_TIERS];   // this CTA's sums (read by rank 0)
  __shared__ int s_phits;
  __shared__ double s_tot[MAX_TIERS];    // the lane's (rank 0)
  __shared__ int s_thits;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const int64_t start = (int64_t)rank * slice;
  const int64_t left = (int64_t)n - start;
  const int len = left <= 0 ? 0 : (left < slice ? (int)left : slice);
  const float* row = true_ + b * true_stride + start;
  const int* trow = tier + (int64_t)b * n + start;
  const uint8_t* orow = oracle + b * oracle_stride + start;

  double acc[MAX_TIERS];
#pragma unroll
  for (int s = 0; s < MAX_TIERS; ++s) acc[s] = 0.0;
  int hits = 0, done = 0;
  if (((((uintptr_t)row | (uintptr_t)trow) & 15) |
       ((uintptr_t)orow & 3)) == 0) {
    const int nv = len / 4;
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const int4* t4 = reinterpret_cast<const int4*>(trow);
    const uint32_t* o4 = reinterpret_cast<const uint32_t*>(orow);
    for (int v0 = tid; v0 < nv; v0 += ACCOUNT_ILP * ACCOUNT_THREADS) {
      float4 x[ACCOUNT_ILP];
      int4 t[ACCOUNT_ILP];
      uint32_t o[ACCOUNT_ILP];
#pragma unroll
      for (int u = 0; u < ACCOUNT_ILP; ++u) {
        const int v = v0 + u * ACCOUNT_THREADS;
        if (v < nv) {
          x[u] = r4[v];
          t[u] = t4[v];
          o[u] = o4[v];
        }
      }
#pragma unroll
      for (int u = 0; u < ACCOUNT_ILP; ++u) {
        if (v0 + u * ACCOUNT_THREADS < nv) {
          account_page(acc, hits, x[u].x, t[u].x, (o[u] & 0xffu) != 0, R);
          account_page(acc, hits, x[u].y, t[u].y, (o[u] & 0xff00u) != 0, R);
          account_page(acc, hits, x[u].z, t[u].z, (o[u] & 0xff0000u) != 0,
                       R);
          account_page(acc, hits, x[u].w, t[u].w, (o[u] >> 24) != 0, R);
        }
      }
    }
    done = nv * 4;
  }
  for (int i = done + tid; i < len; i += ACCOUNT_THREADS)
    account_page(acc, hits, row[i], trow[i], orow[i] != 0, R);

  // the CTA's sums: one shuffle pass, one barrier, one pass over the warps
#pragma unroll
  for (int s = 0; s < MAX_TIERS; ++s)
    if (s < R) acc[s] = warp_sum(acc[s]);
  hits = warp_sum(hits);
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < MAX_TIERS; ++s)
      if (s < R) s_warp[warp][s] = acc[s];
    s_whits[warp] = hits;
  }
  __syncthreads();
  if (tid < R) {
    double v = 0.0;
    for (int w = 0; w < ACCOUNT_THREADS / 32; ++w) v += s_warp[w][tid];
    s_part[tid] = v;
  } else if (tid == 32) {
    int h = 0;
    for (int w = 0; w < ACCOUNT_THREADS / 32; ++w) h += s_whits[w];
    s_phits = h;
  }
  cluster.sync();
  if (rank == 0) {   // the lane's sums, rank by rank: every remote load at once
    if (tid < R) {
      double part[16];
#pragma unroll
      for (int r = 0; r < 16; ++r)
        part[r] = r < csize ? cluster.map_shared_rank(s_part, r)[tid] : 0.0;
      double v = 0.0;
#pragma unroll
      for (int r = 0; r < 16; ++r) v += part[r];
      s_tot[tid] = v;
    } else if (tid == 32) {
      int part[16];
#pragma unroll
      for (int r = 0; r < 16; ++r)
        part[r] = r < csize ? *cluster.map_shared_rank(&s_phits, r) : 0;
      int h = 0;
#pragma unroll
      for (int r = 0; r < 16; ++r) h += part[r];
      s_thits = h;
    }
    __syncthreads();
    if (tid == 0) {
      const float* L = lat + b * R;
      const float* BR = br + b * R;
      const float* BW = bw + b * R;
      const float* up = mig_up + b * (R - 1);
      const float* down = mig_down + b * (R - 1);
      float accs[MAX_TIERS], times[MAX_TIERS];
      float rest = (float)s_tot[0];
      for (int r = 0; r < R - 1; ++r) {
        accs[r] = (float)s_tot[1 + r];
        rest = rest - accs[r];
      }
      accs[R - 1] = rest;

      float t_lat = accs[0] * L[0];
      for (int r = 1; r < R; ++r) t_lat = t_lat + accs[r] * L[r];
      t_lat = t_lat * 1e-9f / mlp[b];

      times[0] =
          (accs[0] * kCacheline + (up[0] + down[0]) * kPageBytes) / BR[0];
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
      o[5] = (float)s_thits / (float)k;
    }
  }
  cluster.sync();   // no CTA leaves while rank 0 may still read its sums
}

// A launch of `cluster` CTAs a lane over B lanes (grid cluster x B) of
// `threads` threads and `smem` bytes of dynamic shared memory, with the
// cluster attributes its kernel needs; `slice` (and, for top-k, whether
// the slice is resident in shared memory) as the kernel's launcher sets it.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int slice, resident;
};

template <typename Kernel>
static cudaError_t cluster_config(Kernel kernel, int B, int cluster,
                                  int threads, size_t smem,
                                  cudaStream_t stream, ClusterLaunch* L) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  L->cfg = cudaLaunchConfig_t{};
  L->cfg.gridDim = dim3(cluster, B);
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

// The CTAs a lane takes: the most, up to 16 with slices of at least
// `min_slice` elements, at which the device holds all B clusters of
// `kernel` (as `launch` configures it) at once; 1 where it holds none of
// those.
template <typename Kernel, typename Launch>
static int best_cluster(Kernel kernel, Launch launch, int B, int n,
                        int min_slice, int* cluster) {
  *cluster = 1;
  for (int c = 2; c <= 16 && (n + c - 1) / c >= min_slice; ++c) {
    ClusterLaunch L;
    cudaError_t err = launch(B, n, c, 0, &L);
    int active = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&active, kernel, &L.cfg);
    if (err != cudaSuccess) return (int)err;
    if (active >= B) *cluster = c;
  }
  return (int)cudaSuccess;
}

static cudaError_t account_launch(int B, int n, int cluster,
                                  cudaStream_t stream, ClusterLaunch* L) {
  if (cluster < 1 || cluster > 16) return cudaErrorInvalidValue;
  // slices start on a 16-byte boundary of a lane's rows
  L->slice = ((n + cluster - 1) / cluster + 3) / 4 * 4;
  return cluster_config(interval_account_kernel, B, cluster, ACCOUNT_THREADS,
                        0, stream, L);
}

extern "C" int arms_account_cluster(int B, int n, int* cluster) {
  return best_cluster(interval_account_kernel, account_launch, B, n,
                      ACCOUNT_MIN_SLICE, cluster);
}

// `cluster` CTAs a lane (1..16); a cluster the device cannot schedule is
// refused here, and the caller raises.
extern "C" int arms_interval_account(
    const float* lat, const float* br, const float* bw, const float* mlp,
    const float* true_, int64_t true_stride, const int* tier,
    const float* mig_up, const float* mig_down, const uint8_t* oracle,
    int64_t oracle_stride, float* out, int B, int n, int R, int k,
    int cluster, cudaStream_t stream) {
  ClusterLaunch L;
  cudaError_t err = account_launch(B, n, cluster, stream, &L);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&L.cfg, interval_account_kernel, lat, br, bw, mlp,
                           true_, true_stride, tier, mig_up, mig_down, oracle,
                           oracle_stride, out, n, R, k, L.slice);
  if (err != cudaSuccess) return (int)err;
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
// Replaces kernel.py:topk_mask_kernel (_topk_body).  Bound: bytes, one f32
// row read and one bool row written per lane; in practice a fixed cost (a
// cluster launch and some 15 barriers) and the latency of each CTA's
// passes over its keys, so the design spreads a row over many SMs.
// Radix select over the order key, each row on a thread-block cluster of C
// CTAs of 1,024 threads (their registers fill an SM, so no two CTAs share
// one; a row of one CTA takes 16 keys a thread, 256 threads at least).
// C is the most CTAs, up to the non-portable 16 with slices of at least
// 4,096 keys, at which the device holds all B clusters at once
// (cudaOccupancyMaxActiveClusters): all rows in one wave.  A cluster sits
// in one GPC, so an H100 holds 16 clusters of 6 CTAs but not of 7; a
// single row takes 16.
//   * The row is read from device memory once (16-byte loads where the row
//     allows them): each CTA keeps its slice's order keys in shared memory
//     (up to TOPK_SMEM_KEYS keys, 160 KiB beside 34 KiB of histograms, so
//     rows up to 327,680 keys at C = 8 and 655,360 at C = 16) and runs
//     every pass there; a longer slice streams from device memory (L2)
//     each pass.
//   * Four passes of an 8-bit digit narrow the prefix of the k-th largest
//     key.  Hotness scores are heavily tied, so a warp merges equal digits
//     (eight ballots; __match_any_sync was slower) and adds each distinct
//     digit once to its own 256-bin histogram, so warps never contend for
//     a bin; a warp none of whose keys still match the prefix skips the
//     ballots.  A thread counts 4 keys an iteration, so their ballot chains
//     overlap.  8-bit digits, not 11-bit: the warp histograms fit shared
//     memory, and each CTA reads C x 256 remote bins a pass, not C x 2,048.
//   * The CTAs' histograms are summed through distributed shared memory in
//     rank order by every CTA (cluster.sync, map_shared_rank, all ranks'
//     loads in flight at once; no global atomics), and the digit is found
//     by a parallel suffix scan over the 256 bins, not a serial walk.  CTA
//     histograms are double-buffered: one cluster barrier a pass.
//   * Ties stay exact across CTAs: each CTA counts its keys equal to the
//     threshold, and the counts of the lower ranks (read through DSMEM) are
//     its offset; inside the CTA a block scan ranks the equal keys, 16
//     consecutive keys a thread, so the lowest indices win.  The mask goes
//     out in 16-byte stores where the row is 16-byte aligned.
#define TOPK_THREADS 1024
#define TOPK_RUN 16            // consecutive keys a thread writes the mask of
#define TOPK_ILP 4             // keys a thread counts an iteration
#define TOPK_SMEM_KEYS 40960   // slice keys a CTA keeps in shared memory
#define TOPK_MIN_SLICE 4096    // fewest keys a CTA takes

__device__ __forceinline__ uint32_t topk_key(const uint32_t* s_key,
                                             const float* xs, int i,
                                             bool resident) {
  return resident ? s_key[i] : order_key(xs[i]);
}

// The lanes of the warp whose (hit) digit equals this lane's: eight
// ballots, one a digit bit.
__device__ __forceinline__ unsigned int same_digit(unsigned int digit,
                                                   bool hit) {
  unsigned int peers = __ballot_sync(0xffffffffu, hit);
  if (peers == 0) return 0;   // no key of the warp matches the prefix
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const bool bit = (digit >> b) & 1u;
    const unsigned int v = __ballot_sync(0xffffffffu, bit);
    peers &= bit ? v : ~v;
  }
  return peers;
}

__global__ void __launch_bounds__(TOPK_THREADS, 1)
    topk_mask_kernel(const float* __restrict__ x, uint8_t* __restrict__ mask,
                     int n, int k, int slice, int resident) {
  extern __shared__ __align__(16) uint32_t s_key[];
  __shared__ unsigned int whist[TOPK_THREADS / 32][256];   // a warp's bins
  __shared__ unsigned int hist[2][256];
  __shared__ unsigned int s_scan[8];
  __shared__ unsigned int s_sel[2];   // chosen digit, keys still to take
  __shared__ int s_warp[TOPK_THREADS / 32];
  __shared__ int s_eq, s_off;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, nw = nt >> 5;   // 256..1,024 threads
  const int64_t start = (int64_t)rank * slice;
  const int64_t left = (int64_t)n - start;
  const int len = left <= 0 ? 0 : (left < slice ? (int)left : slice);
  const float* xs = x + (int64_t)blockIdx.y * n + start;
  uint8_t* out = mask + (int64_t)blockIdx.y * n + start;
  const bool res = resident != 0;

  if (res && (n & 3) == 0) {   // the slice starts on a 16-byte boundary
    const float4* x4 = reinterpret_cast<const float4*>(xs);
#pragma unroll 4
    for (int i = tid; i < len / 4; i += nt) {
      const float4 v = x4[i];
      *reinterpret_cast<uint4*>(s_key + 4 * i) = make_uint4(
          order_key(v.x), order_key(v.y), order_key(v.z), order_key(v.w));
    }
    for (int i = len / 4 * 4 + tid; i < len; i += nt)
      s_key[i] = order_key(xs[i]);
  } else if (res) {
    for (int i = tid; i < len; i += nt) s_key[i] = order_key(xs[i]);
  }
  for (int i = tid; i < nw * 256; i += nt) (&whist[0][0])[i] = 0;
  __syncthreads();

  uint32_t prefix = 0, pmask = 0;
  unsigned int remaining = (unsigned int)k;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    unsigned int* h = hist[pass & 1];
    // TOPK_ILP keys a thread an iteration: their ballot chains interleave
    for (int base = 0; base < len; base += TOPK_ILP * nt) {
      uint32_t key[TOPK_ILP];
      bool hit[TOPK_ILP];
#pragma unroll
      for (int j = 0; j < TOPK_ILP; ++j) {
        const int i = base + j * nt + tid;
        key[j] = i < len ? topk_key(s_key, xs, i, res) : 0u;
        hit[j] = i < len && (key[j] & pmask) == prefix;
      }
#pragma unroll
      for (int j = 0; j < TOPK_ILP; ++j) {
        const unsigned int digit = (key[j] >> shift) & 255u;
        const unsigned int peers = same_digit(digit, hit[j]);
        if (hit[j] && lane == __ffs(peers) - 1)
          atomicAdd(&whist[warp][digit], (unsigned int)__popc(peers));
      }
    }
    __syncthreads();
    // The CTA's histogram (its remote readers of two passes ago have all
    // passed the cluster barrier of the last pass); the warps' zeroed.
    if (tid < 256) {
      unsigned int sum = 0;
      for (int w0 = 0; w0 < nw; w0 += 16) {   // 16 loads in flight
        unsigned int part[16];
#pragma unroll
        for (int u = 0; u < 16; ++u)
          part[u] = w0 + u < nw ? whist[w0 + u][tid] : 0u;
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          sum += part[u];
          if (w0 + u < nw) whist[w0 + u][tid] = 0;
        }
      }
      h[tid] = sum;
    }
    cluster.sync();
    // Bins from 255 down: thread t < 256 holds bin 255 - t of the cluster's
    // histogram and the keys in bins above it.
    unsigned int cnt = 0, inc = 0;
    if (tid < 256) {
      const int d = 255 - tid;
      unsigned int part[16];   // every rank's bin read at once, then summed
#pragma unroll
      for (int r = 0; r < 16; ++r)
        part[r] = r < csize ? cluster.map_shared_rank(h, r)[d] : 0u;
#pragma unroll
      for (int r = 0; r < 16; ++r) cnt += part[r];
      inc = cnt;
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned int v = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += v;
      }
      if (lane == 31) s_scan[warp] = inc;
    }
    __syncthreads();
    if (tid < 256) {
      unsigned int above = inc - cnt;
      for (int w = 0; w < warp; ++w) above += s_scan[w];
      if (above < remaining && remaining <= above + cnt) {
        s_sel[0] = 255u - tid;
        s_sel[1] = remaining - above;
      }
    }
    __syncthreads();
    prefix |= s_sel[0] << shift;
    remaining = s_sel[1];
    pmask |= 255u << shift;
  }

  // prefix is the k-th largest key; `remaining` of the keys equal to it are
  // taken, lowest index (over the whole row) first.
  int eq = 0;
  for (int i = tid; i < len; i += nt)
    eq += topk_key(s_key, xs, i, res) == prefix ? 1 : 0;
  eq = warp_sum(eq);
  if (lane == 0) s_warp[warp] = eq;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < nw; ++w) total += s_warp[w];
    s_eq = total;
  }
  cluster.sync();
  if (warp == 0) {   // lane r < rank reads rank r's count
    int off = lane < rank ? *cluster.map_shared_rank(&s_eq, lane) : 0;
    off = warp_sum(off);
    if (lane == 0) s_off = off;
  }
  __syncthreads();
  unsigned int taken = (unsigned int)s_off;
  for (int base = 0; base < len; base += TOPK_RUN * nt) {
    const int i0 = base + TOPK_RUN * tid;
    uint32_t keys[TOPK_RUN];
    int ne = 0;
#pragma unroll
    for (int j = 0; j < TOPK_RUN; ++j) {
      keys[j] = i0 + j < len ? topk_key(s_key, xs, i0 + j, res) : 0u;
      ne += (i0 + j < len && keys[j] == prefix) ? 1 : 0;
    }
    int inc = ne;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += v;
    }
    if (lane == 31) s_warp[warp] = inc;
    __syncthreads();
    unsigned int before = taken + (unsigned int)(inc - ne), chunk = 0;
    for (int w = 0; w < nw; ++w) {
      if (w < warp) before += (unsigned int)s_warp[w];
      chunk += (unsigned int)s_warp[w];
    }
    __syncthreads();
    uint8_t m[TOPK_RUN];
#pragma unroll
    for (int j = 0; j < TOPK_RUN; ++j) {
      const bool is_eq = i0 + j < len && keys[j] == prefix;
      m[j] = (keys[j] > prefix || (is_eq && before < remaining)) ? 1 : 0;
      before += is_eq ? 1u : 0u;
    }
    if (i0 + TOPK_RUN <= len && ((uintptr_t)(out + i0) & 15) == 0) {
      uint4 v;
      uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        w[q] = (uint32_t)m[4 * q] | ((uint32_t)m[4 * q + 1] << 8) |
               ((uint32_t)m[4 * q + 2] << 16) | ((uint32_t)m[4 * q + 3] << 24);
      *reinterpret_cast<uint4*>(out + i0) = v;
    } else {
      for (int j = 0; j < TOPK_RUN; ++j)
        if (i0 + j < len) out[i0 + j] = m[j];
    }
    taken += chunk;
  }
  cluster.sync();   // no CTA leaves while another may still read its s_eq
}

// The launch of `cluster` CTAs a row over B rows of n keys: the slice a CTA
// takes, and whether it stays in shared memory.
static cudaError_t topk_launch(int B, int n, int cluster, cudaStream_t stream,
                               ClusterLaunch* L) {
  if (cluster < 1 || cluster > 16) return cudaErrorInvalidValue;
  L->slice = (n + cluster - 1) / cluster;
  L->slice = (L->slice + TOPK_RUN - 1) / TOPK_RUN * TOPK_RUN;
  L->resident = L->slice <= TOPK_SMEM_KEYS ? 1 : 0;
  const size_t smem = L->resident ? sizeof(uint32_t) * (size_t)L->slice : 0;
  // a row of one CTA takes 16 keys a thread, 256 threads at least (one a
  // bin); a cluster's CTAs take 1,024 threads, one CTA an SM
  int threads = TOPK_THREADS;
  if (cluster == 1) {
    threads = (L->slice / 16 + 31) / 32 * 32;
    threads = threads < 256 ? 256 : threads > TOPK_THREADS ? TOPK_THREADS
                                                          : threads;
  }
  return cluster_config(topk_mask_kernel, B, cluster, threads, smem, stream,
                        L);
}

extern "C" int arms_topk_cluster(int B, int n, int* cluster) {
  return best_cluster(topk_mask_kernel, topk_launch, B, n, TOPK_MIN_SLICE,
                      cluster);
}

// `cluster` CTAs a row (1..16); a cluster the device cannot schedule is
// refused here, and the caller raises.
extern "C" int arms_topk_mask(const float* x, uint8_t* mask, int B, int n,
                              int k, int cluster, cudaStream_t stream) {
  ClusterLaunch L;
  cudaError_t err = topk_launch(B, n, cluster, stream, &L);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&L.cfg, topk_mask_kernel, x, mask, n, k, L.slice,
                           L.resident);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
