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

#include "../../cluster.cuh"

namespace cg = cooperative_groups;

#define MAX_TIERS 8

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

// ----------------------------------------------------------- warp helpers
__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// -------------------------------------------------------------- accounting
// Replaces kernel.py:interval_account_kernel (_account_body).  Bound:
// bytes — the true row (f32), the tier row (i32) and the oracle row (u8)
// read once per lane, 9 bytes a page; at the replay's 16 x 65,536 (one
// true and oracle row shared by the lanes) that is 1.35 us at the HBM
// rate, so the floor in practice is a launch and a few memory latencies.
// Design: each lane on a thread-block cluster of C CTAs, C a divisor of 16
// (slices of at least ACCOUNT_MIN_SLICE pages), the most at which the
// device holds all B clusters at once (cudaOccupancyMaxActiveClusters,
// arms_account_cluster), so a lane's pages are read by up to 16 SMs and
// not one, even at B 1.  Sums in a fixed order, whatever C: a lane's row
// is cut into ACCOUNT_SUBS fixed sub-slices, and CTA r of the cluster sums
// sub-slices r, r + C, ..., each with the same thread-to-page mapping
// every time: thread t takes the 4-page words t, t + 256, ... of the
// sub-slice in ascending order (16-byte loads of the true and tier rows
// and one 4-byte word of four oracle bytes where the lane's rows allow
// them, ACCOUNT_ILP of a thread's loads in flight; the same pages in the
// same order one by one where they do not), then the ragged tail.  Each
// thread accumulates the R-1 masked sums and the total in f64, rounded
// once to f32 as the plain version rounds its f64 sums (the two sum in
// different orders, so the f64 sums are not exact and may differ; their
// error lies far below half an f32 ulp, so the f32 results agree unless a
// sum lands within it of a rounding boundary), and the recall count as an
// int.  One warp-shuffle pass a sub-slice, then one barrier and one pass
// over the warps (in warp order, all of a CTA's sub-slices at once) reduce
// each sub-slice to one f64 partial; rank 0 adds the ACCOUNT_SUBS partials
// in sub-slice order through distributed shared memory and runs the scalar
// epilogue of the Pallas body in f32, op for op.  So a lane's outputs are
// the same bits at every lane count and cluster size, with no atomics.
// In trace mode `true` and `oracle` are one row shared by all lanes: their
// lane stride is 0 and the lanes' reads hit L2.
#define ACCOUNT_THREADS 256
#define ACCOUNT_ILP 4            // 16-byte words of a thread in flight
#define ACCOUNT_MIN_SLICE 1024   // fewest pages a CTA of a cluster takes
#define ACCOUNT_SUBS 16          // fixed sub-slices of a lane's row

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
        float* __restrict__ out, int n, int R, int k, int sub) {
  // each warp's sums of this CTA's sub-slices (entry sl for sl = rank mod
  // C), then the CTA's sum of each (rank 0 reads them)
  __shared__ double s_warp[ACCOUNT_SUBS][ACCOUNT_THREADS / 32][MAX_TIERS];
  __shared__ int s_whits[ACCOUNT_THREADS / 32];
  __shared__ double s_part[ACCOUNT_SUBS][MAX_TIERS];
  __shared__ int s_phits;
  __shared__ double s_tot[MAX_TIERS];    // the lane's (rank 0)
  __shared__ int s_thits;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;

  int hits = 0;
  for (int sl = rank; sl < ACCOUNT_SUBS; sl += csize) {
    const int64_t start = (int64_t)sl * sub;
    const int64_t left = (int64_t)n - start;
    const int len = left <= 0 ? 0 : (left < sub ? (int)left : sub);
    const float* row = true_ + b * true_stride + start;
    const int* trow = tier + (int64_t)b * n + start;
    const uint8_t* orow = oracle + b * oracle_stride + start;
    const int nv = len / 4;

    double acc[MAX_TIERS];
#pragma unroll
    for (int s = 0; s < MAX_TIERS; ++s) acc[s] = 0.0;
    if (((((uintptr_t)row | (uintptr_t)trow) & 15) |
         ((uintptr_t)orow & 3)) == 0) {
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
            account_page(acc, hits, x[u].y, t[u].y, (o[u] & 0xff00u) != 0,
                         R);
            account_page(acc, hits, x[u].z, t[u].z, (o[u] & 0xff0000u) != 0,
                         R);
            account_page(acc, hits, x[u].w, t[u].w, (o[u] >> 24) != 0, R);
          }
        }
      }
    } else {   // the same pages in the same order, one by one
      for (int v = tid; v < nv; v += ACCOUNT_THREADS)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          account_page(acc, hits, row[4 * v + e], trow[4 * v + e],
                       orow[4 * v + e] != 0, R);
    }
    for (int i = nv * 4 + tid; i < len; i += ACCOUNT_THREADS)
      account_page(acc, hits, row[i], trow[i], orow[i] != 0, R);

    // the sub-slice's sums a warp: one shuffle pass, no barrier
#pragma unroll
    for (int s = 0; s < MAX_TIERS; ++s)
      if (s < R) acc[s] = warp_sum(acc[s]);
    if (lane == 0) {
#pragma unroll
      for (int s = 0; s < MAX_TIERS; ++s)
        if (s < R) s_warp[sl][warp][s] = acc[s];
    }
  }
  hits = warp_sum(hits);
  if (lane == 0) s_whits[warp] = hits;
  __syncthreads();
  // each of this CTA's sub-slice sums over the warps, in warp order
  for (int i = tid; i < ACCOUNT_SUBS * R; i += ACCOUNT_THREADS) {
    const int sl = i / R, r = i - sl * R;
    if (sl % csize != rank) continue;
    double v = 0.0;
    for (int w = 0; w < ACCOUNT_THREADS / 32; ++w) v += s_warp[sl][w][r];
    s_part[sl][r] = v;
  }
  if (tid == ACCOUNT_THREADS - 1) {
    int h = 0;
    for (int w = 0; w < ACCOUNT_THREADS / 32; ++w) h += s_whits[w];
    s_phits = h;
  }
  cluster.sync();
  if (rank == 0) {   // the lane's sums, sub-slice by sub-slice: every remote
                     // load at once
    if (tid < R) {
      double part[ACCOUNT_SUBS];
#pragma unroll
      for (int sl = 0; sl < ACCOUNT_SUBS; ++sl)
        part[sl] = cluster.map_shared_rank(&s_part[sl][tid], sl % csize)[0];
      double v = 0.0;
#pragma unroll
      for (int sl = 0; sl < ACCOUNT_SUBS; ++sl) v += part[sl];
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

static cudaError_t account_launch(int B, int n, int cluster,
                                  cudaStream_t stream, ClusterLaunch* L) {
  // a divisor of ACCOUNT_SUBS: every CTA takes as many sub-slices
  if (cluster < 1 || cluster > 16 || ACCOUNT_SUBS % cluster != 0)
    return cudaErrorInvalidValue;
  // sub-slices start on a 16-byte boundary of a lane's rows
  L->slice = ((n + ACCOUNT_SUBS - 1) / ACCOUNT_SUBS + 3) / 4 * 4;
  return cluster_config(interval_account_kernel, B, cluster, ACCOUNT_THREADS,
                        0, stream, L);
}

extern "C" int arms_account_cluster(int B, int n, int* cluster) {
  return best_cluster(
      [=](int c, ClusterLaunch* L) { return account_launch(B, n, c, 0, L); },
      B, max_cluster_for_slice(n, ACCOUNT_MIN_SLICE), cluster);
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
// Replaces kernel.py:tier_migrate_kernel (_migrate_body), which takes plans
// of any width.  Bound: bytes — the tier row read once and written once per
// lane, the plans read once and the executed masks written once.  At the
// sweep's 16 x 65,536 with ARMS's 64-entry plans that is 2.5 us at the HBM
// rate, so in practice the floor is a cluster launch, one load latency and
// the plan's few hundred instructions.
// Design: each lane on a thread-block cluster of C CTAs, C chosen as for the
// accounting kernel (best_cluster, slices of at least MIGRATE_MIN_SLICE
// pages), each CTA a contiguous slice of the row.  Plans of at most
// MIGRATE_STAGE entries each take the staged route (tier_migrate_kernel):
//   * Each CTA first stages the plans in shared memory and gathers every
//     entry's tier from the input row (read only, so no hazard), so those
//     loads are in flight with the slice's.
//   * The slice is copied to the output in 16-byte words (a scalar tail, and
//     a scalar route where a lane's rows are off a 16-byte boundary), each
//     thread counting its pages in tiers 0..R-2; one shuffle pass and one
//     pass over the warps give the CTA's counts, which it stores into every
//     CTA's shared memory (DSMEM).  After one cluster barrier (release /
//     acquire) each CTA holds every rank's counts and reads nothing remote
//     again, so no CTA waits for another before it leaves.
//   * Every CTA then runs the plan itself, in the parallel form of the plain
//     version (simjax.apply_tier_migrations): for each middle tier r in
//     ascending order the candidates are the executed demotions with source
//     < r that have not landed yet; one lands at r when its exclusive rank
//     among them, in plan order, is below r's slack.  A promotion's source is
//     its landing tier when the demote plan moved its page, else its tier in
//     the input row (no read-back of the output); it executes when its
//     exclusive rank among the valid requests is below tier 0's room.  Warp 0
//     ranks 32 entries at a time with a ballot and __popc, carrying the count
//     from one group of 32 to the next.  The ranks equal the Pallas body's
//     sequential walk (kernel.py:134-135: entry order within a tier matches
//     the cumsum rank).
//   * Each CTA writes the plan's pages that lie in its own slice, so every
//     page of the output has one writer, the CTA that copied it: demotions,
//     a block barrier, then promotions (a page in both plans ends in tier 0,
//     as apply_down then apply_up).  Rank 0 writes the executed masks and the
//     crossing counts.
// A wider plan (TPP's demotions and both of the oracle's are k wide) takes
// the streamed route (tier_migrate_wide_kernel), whose shared memory does
// not grow with the plan:
//   * The slice is copied and counted as above; each CTA also counts the
//     departures of its 1/C share of the demote plan, and both counts go
//     through DSMEM in the same cluster barrier.
//   * Every CTA streams the demote plan in tiles of MIGRATE_TILE entries in
//     plan order, MIGRATE_PER a thread: the same candidates and slacks, but
//     an entry's rank is a block-wide exclusive scan plus a per-tier carry
//     from the earlier tiles (a landing at tier r depends only on the entry
//     itself and on the candidates before it, so the tiles may go in
//     order).  Each CTA writes the landing tiers in its own slice.
//   * A cluster barrier (release / acquire) makes every slice's demotions
//     visible, so a promotion's source is read back from the output row; the
//     promote plan is streamed the same way against tier 0's room, and rank 0
//     writes the executed flags.  After a second cluster barrier each CTA
//     reads those flags back and writes the promotions in its own slice (no
//     CTA writes a promotion while another may still read its source).
#define MIGRATE_THREADS 256
#define MIGRATE_ILP 4             // 16-byte words of a thread in flight
#define MIGRATE_MIN_SLICE 1024    // fewest pages a CTA of a cluster takes
#define MIGRATE_STAGE 1024        // widest plan the staged route takes
#define MIGRATE_PER 8             // plan entries of a thread in a tile
#define MIGRATE_TILE (MIGRATE_PER * MIGRATE_THREADS)
#define MIGRATE_WARPS (MIGRATE_THREADS / 32)

// One page into a thread's counts of tiers 0..R-2 (the last is not needed).
__device__ __forceinline__ void count_tier(int (&occ)[MAX_TIERS - 1], int t,
                                           int R) {
#pragma unroll
  for (int r = 0; r < MAX_TIERS - 1; ++r)
    occ[r] += (r < R - 1 && t == r) ? 1 : 0;
}

// Ballot count of `pred` over the warp.
__device__ __forceinline__ int warp_count(bool pred) {
  return __popc(__ballot_sync(0xffffffffu, pred));
}

// Copies a CTA's slice of `len` pages from `src` to `dst`, in 16-byte words
// where both are on a 16-byte boundary (a scalar tail), MIGRATE_ILP words of
// a thread in flight; `occ` gets this thread's counts of its pages in tiers
// 0..R-2.
__device__ __forceinline__ void copy_count_slice(const int* src, int* dst,
                                                 int len, int R, int tid,
                                                 int (&occ)[MAX_TIERS - 1]) {
#pragma unroll
  for (int r = 0; r < MAX_TIERS - 1; ++r) occ[r] = 0;
  int done = 0;
  if ((((uintptr_t)src | (uintptr_t)dst) & 15) == 0) {
    const int nv = len / 4;
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (int v0 = tid; v0 < nv; v0 += MIGRATE_ILP * MIGRATE_THREADS) {
      int4 t[MIGRATE_ILP];
#pragma unroll
      for (int u = 0; u < MIGRATE_ILP; ++u)
        if (v0 + u * MIGRATE_THREADS < nv) t[u] = s4[v0 + u * MIGRATE_THREADS];
#pragma unroll
      for (int u = 0; u < MIGRATE_ILP; ++u) {
        if (v0 + u * MIGRATE_THREADS < nv) {
          d4[v0 + u * MIGRATE_THREADS] = t[u];
          count_tier(occ, t[u].x, R);
          count_tier(occ, t[u].y, R);
          count_tier(occ, t[u].z, R);
          count_tier(occ, t[u].w, R);
        }
      }
    }
    done = nv * 4;
  }
  for (int i = done + tid; i < len; i += MIGRATE_THREADS) {
    const int t = src[i];
    dst[i] = t;
    count_tier(occ, t, R);
  }
}

__global__ void __launch_bounds__(MIGRATE_THREADS)
    tier_migrate_kernel(const int* __restrict__ tier,
                        const int* __restrict__ promote,
                        const int* __restrict__ demote,
                        const int* __restrict__ caps,
                        int* __restrict__ tier_out,
                        uint8_t* __restrict__ pexec,
                        uint8_t* __restrict__ dexec,
                        int* __restrict__ mig_up, int* __restrict__ mig_down,
                        int n, int R, int P, int D, int slice) {
  extern __shared__ int smem[];
  int* s_dem = smem;          // [D] demote entries
  int* s_dsrc = s_dem + D;    // [D] their tiers in the input row
  int* s_dest = s_dsrc + D;   // [D] landing tier; 0 not landed yet, -1 not
                              //     executed
  int* s_prom = s_dest + D;   // [P] promote entries
  int* s_psrc = s_prom + P;   // [P] their tiers after the demotions
  int* s_pex = s_psrc + P;    // [P] executed flags
  __shared__ int s_warp[MIGRATE_THREADS / 32][MAX_TIERS - 1];
  __shared__ int s_cnt[16][MAX_TIERS - 1];   // rank q's counts, pushed by q
  __shared__ int s_room;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  cluster_arrive_relaxed();   // once it completes, every CTA has started
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned int below = (1u << lane) - 1u;   // lanes under this one
  const int b = blockIdx.y;
  const int* row = tier + (int64_t)b * n;
  int* orow = tier_out + (int64_t)b * n;
  const int* cap = caps + b * R;
  const int64_t start = (int64_t)rank * slice;
  const int64_t left = (int64_t)n - start;
  const int len = left <= 0 ? 0 : (left < slice ? (int)left : slice);

  for (int i = tid; i < D; i += MIGRATE_THREADS) {
    const int d = demote[(int64_t)b * D + i];
    s_dem[i] = d;
    s_dsrc[i] = d >= 0 ? row[d] : R - 1;
  }
  for (int j = tid; j < P; j += MIGRATE_THREADS) {
    const int p = promote[(int64_t)b * P + j];
    s_prom[j] = p;
    s_psrc[j] = p >= 0 ? row[p] : 0;
  }

  // the slice: copied, and counted by tier
  int occ[MAX_TIERS - 1];
  copy_count_slice(row + start, orow + start, len, R, tid, occ);
#pragma unroll
  for (int r = 0; r < MAX_TIERS - 1; ++r)
    if (r < R - 1) occ[r] = warp_sum(occ[r]);
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < MAX_TIERS - 1; ++r)
      if (r < R - 1) s_warp[warp][r] = occ[r];
  }
  __syncthreads();
  cluster_wait();   // every CTA has started: its shared memory may be written
  if (tid < R - 1) {
    int v = 0;
    for (int w = 0; w < MIGRATE_THREADS / 32; ++w) v += s_warp[w][tid];
    for (int q = 0; q < csize; ++q)
      cluster.map_shared_rank(&s_cnt[rank][tid], q)[0] = v;
  }
  cluster_arrive_release();
  cluster_wait();   // every rank's counts are here; nothing remote after this

  // departures and landing tiers (warp 0; every lane holds the lane's counts)
  if (warp == 0) {
    int occ_l[MAX_TIERS - 1], dep[MAX_TIERS - 1], down[MAX_TIERS - 1];
#pragma unroll
    for (int r = 0; r < MAX_TIERS - 1; ++r) {
      occ_l[r] = dep[r] = down[r] = 0;
      if (r < R - 1)
        for (int q = 0; q < csize; ++q) occ_l[r] += s_cnt[q][r];
    }
    for (int base = 0; base < D; base += 32) {
      const int i = base + lane;
      const int sr = i < D ? s_dsrc[i] : R - 1;
      const bool dx = i < D && s_dem[i] >= 0 && sr < R - 1;
#pragma unroll
      for (int r = 0; r < MAX_TIERS - 1; ++r)
        if (r < R - 1) dep[r] += warp_count(dx && sr == r);
      if (i < D) s_dest[i] = dx ? 0 : -1;
    }
    for (int r = 1; r < R - 1; ++r) {   // middle tiers, lowest first
      int slack = 0;
#pragma unroll
      for (int x = 1; x < MAX_TIERS - 1; ++x)
        if (x == r) slack = cap[r] - (occ_l[x] - dep[x]);
      int carry = 0;
      for (int base = 0; base < D; base += 32) {
        const int i = base + lane;
        const bool cand = i < D && s_dest[i] == 0 && s_dsrc[i] < r;
        const unsigned int m = __ballot_sync(0xffffffffu, cand);
        if (cand && carry + __popc(m & below) < slack) s_dest[i] = r;
        carry += __popc(m);
      }
    }
    for (int base = 0; base < D; base += 32) {
      const int i = base + lane;
      int dest = i < D ? s_dest[i] : -1;
      if (dest == 0) {   // no middle tier had room: the bottom tier
        dest = R - 1;
        s_dest[i] = dest;
      }
      const int sr = i < D ? s_dsrc[i] : 0;
#pragma unroll
      for (int j = 0; j < MAX_TIERS - 1; ++j)
        if (j < R - 1) down[j] += warp_count(dest > 0 && sr <= j && dest > j);
      if (rank == 0 && i < D) dexec[(int64_t)b * D + i] = dest > 0 ? 1 : 0;
    }
#pragma unroll
    for (int j = 0; j < MAX_TIERS - 1; ++j)
      if (rank == 0 && j < R - 1 && lane == j)
        mig_down[b * (R - 1) + j] = down[j];
    if (lane == 0) s_room = cap[0] - (occ_l[0] - dep[0]);
  }
  __syncthreads();

  // promotion sources after the demotions: the landing tier of a page the
  // demote plan moved (valid entries are unique: at most one match)
  for (int j = tid; j < P; j += MIGRATE_THREADS) {
    const int p = s_prom[j];
    if (p < 0) continue;
    for (int i = 0; i < D; ++i) {
      if (s_dem[i] == p) {
        if (s_dest[i] > 0) s_psrc[j] = s_dest[i];
        break;
      }
    }
  }
  __syncthreads();

  // promotion ranks: every valid request counts, the executed fit the room
  if (warp == 0) {
    const int room = s_room;
    int carry = 0, up[MAX_TIERS - 1];
#pragma unroll
    for (int j = 0; j < MAX_TIERS - 1; ++j) up[j] = 0;
    for (int base = 0; base < P; base += 32) {
      const int j = base + lane;
      const int sr = j < P ? s_psrc[j] : 0;
      const bool ok = j < P && s_prom[j] >= 0 && sr > 0;
      const unsigned int m = __ballot_sync(0xffffffffu, ok);
      const bool ex = ok && carry + __popc(m & below) < room;
      carry += __popc(m);
      if (j < P) s_pex[j] = ex ? 1 : 0;
      if (rank == 0 && j < P) pexec[(int64_t)b * P + j] = ex ? 1 : 0;
#pragma unroll
      for (int x = 0; x < MAX_TIERS - 1; ++x)
        if (x < R - 1) up[x] += warp_count(ex && sr > x);
    }
#pragma unroll
    for (int x = 0; x < MAX_TIERS - 1; ++x)
      if (rank == 0 && x < R - 1 && lane == x) mig_up[b * (R - 1) + x] = up[x];
  }
  __syncthreads();

  // the plan's pages in this CTA's slice: demotions, then promotions
  for (int i = tid; i < D; i += MIGRATE_THREADS) {
    const int d = s_dem[i];
    if (s_dest[i] > 0 && d >= start && d < start + len) orow[d] = s_dest[i];
  }
  __syncthreads();
  for (int j = tid; j < P; j += MIGRATE_THREADS) {
    const int p = s_prom[j];
    if (s_pex[j] && p >= start && p < start + len) orow[p] = 0;
  }
}

// Exclusive prefix of `v` over the CTA's threads in thread order, and in
// `total` the CTA's sum; every thread of the CTA calls it (it holds two block
// barriers).  `s_scan` holds MIGRATE_WARPS ints.
__device__ __forceinline__ int block_exclusive(int v, int* s_scan,
                                               int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();   // the previous call's readers are done with s_scan
  if (lane == 31) s_scan[warp] = x;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < MIGRATE_WARPS; ++w) {
    const int t = s_scan[w];
    before += w < warp ? t : 0;
    total += t;
  }
  return before + x - v;
}

// Sums each thread's counts of the R-1 adjacent pairs over the CTA; thread
// j < R-1 returns pair j's sum (the others 0).
__device__ __forceinline__ int block_pair_sum(int (&c)[MAX_TIERS - 1], int R,
                                              int (*s_red)[MAX_TIERS - 1]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int j = 0; j < MAX_TIERS - 1; ++j)
    if (j < R - 1) c[j] = warp_sum(c[j]);
  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < MAX_TIERS - 1; ++j)
      if (j < R - 1) s_red[warp][j] = c[j];
  }
  __syncthreads();
  int v = 0;
  if (tid < R - 1)
    for (int w = 0; w < MIGRATE_WARPS; ++w) v += s_red[w][tid];
  return v;
}

__global__ void __launch_bounds__(MIGRATE_THREADS)
    tier_migrate_wide_kernel(const int* __restrict__ tier,
                             const int* __restrict__ promote,
                             const int* __restrict__ demote,
                             const int* __restrict__ caps,
                             int* __restrict__ tier_out,
                             uint8_t* __restrict__ pexec,
                             uint8_t* __restrict__ dexec,
                             int* __restrict__ mig_up,
                             int* __restrict__ mig_down, int n, int R, int P,
                             int D, int slice) {
  __shared__ int s_red[MIGRATE_WARPS][MAX_TIERS - 1];
  __shared__ int s_dep[MIGRATE_WARPS][MAX_TIERS - 1];
  // rank q's counts, pushed by q: tiers 0..R-2, then departures from them
  __shared__ int s_cnt[16][2 * (MAX_TIERS - 1)];
  __shared__ int s_scan[MIGRATE_WARPS];
  __shared__ int s_room[MAX_TIERS - 1];   // tier 0's room, middle slacks

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  cluster_arrive_relaxed();   // once it completes, every CTA has started
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const int* row = tier + (int64_t)b * n;
  int* orow = tier_out + (int64_t)b * n;
  const int* cap = caps + b * R;
  const int* dem = demote + (int64_t)b * D;
  const int* prom = promote + (int64_t)b * P;
  const int64_t start = (int64_t)rank * slice;
  const int64_t left = (int64_t)n - start;
  const int len = left <= 0 ? 0 : (left < slice ? (int)left : slice);

  // the slice, copied and counted; this CTA's share of the departures
  int occ[MAX_TIERS - 1], dep[MAX_TIERS - 1];
  copy_count_slice(row + start, orow + start, len, R, tid, occ);
#pragma unroll
  for (int r = 0; r < MAX_TIERS - 1; ++r) dep[r] = 0;
  const int share = (D + csize - 1) / csize;
  const int lo = min(D, rank * share), hi = min(D, lo + share);
  for (int i = lo + tid; i < hi; i += MIGRATE_THREADS) {
    const int d = dem[i];
    if (d >= 0) count_tier(dep, row[d], R);
  }
#pragma unroll
  for (int r = 0; r < MAX_TIERS - 1; ++r) {
    if (r < R - 1) {
      occ[r] = warp_sum(occ[r]);
      dep[r] = warp_sum(dep[r]);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < MAX_TIERS - 1; ++r) {
      if (r < R - 1) {
        s_red[warp][r] = occ[r];
        s_dep[warp][r] = dep[r];
      }
    }
  }
  __syncthreads();
  cluster_wait();   // every CTA has started: its shared memory may be written
  if (tid < 2 * (R - 1)) {
    const bool is_occ = tid < R - 1;
    const int r = is_occ ? tid : tid - (R - 1);
    int v = 0;
    for (int w = 0; w < MIGRATE_WARPS; ++w)
      v += is_occ ? s_red[w][r] : s_dep[w][r];
    const int at = is_occ ? r : MAX_TIERS - 1 + r;
    for (int q = 0; q < csize; ++q)
      cluster.map_shared_rank(&s_cnt[rank][at], q)[0] = v;
  }
  cluster_arrive_release();
  cluster_wait();   // every rank's counts are here; nothing remote after this
  if (tid < R - 1) {   // room after the departures: tier 0's, the middles'
    int o = 0, d = 0;
    for (int q = 0; q < csize; ++q) {
      o += s_cnt[q][tid];
      d += s_cnt[q][MAX_TIERS - 1 + tid];
    }
    s_room[tid] = cap[tid] - (o - d);
  }
  __syncthreads();

  // demotions, streamed in plan order: landing tiers and crossings
  int carry[MAX_TIERS - 1], down[MAX_TIERS - 1];
#pragma unroll
  for (int r = 0; r < MAX_TIERS - 1; ++r) carry[r] = down[r] = 0;
  for (int base = 0; base < D; base += MIGRATE_TILE) {
    const int i0 = base + tid * MIGRATE_PER;
    int pg[MIGRATE_PER], sr[MIGRATE_PER], dest[MIGRATE_PER];
#pragma unroll
    for (int u = 0; u < MIGRATE_PER; ++u) {
      pg[u] = i0 + u < D ? dem[i0 + u] : -1;
      sr[u] = pg[u] >= 0 ? row[pg[u]] : R - 1;
      dest[u] = pg[u] >= 0 && sr[u] < R - 1 ? 0 : -1;   // 0: not landed
    }
#pragma unroll
    for (int r = 1; r < MAX_TIERS - 1; ++r) {   // middle tiers, lowest first
      if (r < R - 1) {
        int c = 0;
#pragma unroll
        for (int u = 0; u < MIGRATE_PER; ++u) c += dest[u] == 0 && sr[u] < r;
        int total;
        int at = carry[r] + block_exclusive(c, s_scan, total);
        const int slack = s_room[r];
#pragma unroll
        for (int u = 0; u < MIGRATE_PER; ++u) {
          if (dest[u] == 0 && sr[u] < r) {
            if (at < slack) dest[u] = r;
            ++at;
          }
        }
        carry[r] += total;
      }
    }
#pragma unroll
    for (int u = 0; u < MIGRATE_PER; ++u) {
      if (dest[u] == 0) dest[u] = R - 1;   // no middle tier had room
#pragma unroll
      for (int j = 0; j < MAX_TIERS - 1; ++j)
        down[j] += (j < R - 1 && dest[u] > 0 && sr[u] <= j && dest[u] > j);
      if (rank == 0 && i0 + u < D)
        dexec[(int64_t)b * D + i0 + u] = dest[u] > 0 ? 1 : 0;
      if (dest[u] > 0 && pg[u] >= start && pg[u] < start + len)
        orow[pg[u]] = dest[u];
    }
  }
  const int dsum = block_pair_sum(down, R, s_red);
  if (rank == 0 && tid < R - 1) mig_down[b * (R - 1) + tid] = dsum;
  cluster_arrive_release();
  cluster_wait();   // every slice's demotions are in the output row

  // promotions, streamed: sources read back, ranks against tier 0's room
  const int room = s_room[0];
  int pcarry = 0, up[MAX_TIERS - 1];
#pragma unroll
  for (int j = 0; j < MAX_TIERS - 1; ++j) up[j] = 0;
  for (int base = 0; base < P; base += MIGRATE_TILE) {
    const int j0 = base + tid * MIGRATE_PER;
    int sr[MIGRATE_PER];
    bool ok[MIGRATE_PER];
    int c = 0;
#pragma unroll
    for (int u = 0; u < MIGRATE_PER; ++u) {
      const int p = j0 + u < P ? prom[j0 + u] : -1;
      sr[u] = p >= 0 ? orow[p] : 0;
      ok[u] = p >= 0 && sr[u] > 0;
      c += ok[u];
    }
    int total;
    int at = pcarry + block_exclusive(c, s_scan, total);
#pragma unroll
    for (int u = 0; u < MIGRATE_PER; ++u) {
      const bool ex = ok[u] && at < room;
      at += ok[u];
#pragma unroll
      for (int x = 0; x < MAX_TIERS - 1; ++x)
        up[x] += (x < R - 1 && ex && sr[u] > x);
      if (rank == 0 && j0 + u < P) pexec[(int64_t)b * P + j0 + u] = ex;
    }
    pcarry += total;
  }
  const int usum = block_pair_sum(up, R, s_red);
  if (rank == 0 && tid < R - 1) mig_up[b * (R - 1) + tid] = usum;
  cluster_arrive_release();
  cluster_wait();   // rank 0's flags are out; every source has been read

  for (int j = tid; j < P; j += MIGRATE_THREADS) {
    const int p = prom[j];
    if (p >= start && p < start + len && pexec[(int64_t)b * P + j])
      orow[p] = 0;
  }
}

// The staged route for plans of at most MIGRATE_STAGE entries (mode 0), the
// streamed one for wider plans (mode 1).
static cudaError_t migrate_launch(int B, int n, int cluster, int P, int D,
                                  cudaStream_t stream, ClusterLaunch* L) {
  if (cluster < 1 || cluster > 16 || P < 0 || D < 0)
    return cudaErrorInvalidValue;
  // slices start on a 16-byte boundary of a lane's rows
  L->slice = ((n + cluster - 1) / cluster + 3) / 4 * 4;
  L->mode = P > MIGRATE_STAGE || D > MIGRATE_STAGE;
  if (L->mode)
    return cluster_config(tier_migrate_wide_kernel, B, cluster,
                          MIGRATE_THREADS, 0, stream, L);
  return cluster_config(tier_migrate_kernel, B, cluster, MIGRATE_THREADS,
                        sizeof(int) * 3 * ((size_t)P + (size_t)D), stream, L);
}

extern "C" int arms_migrate_cluster(int B, int n, int* cluster) {
  // sized for the staged route's widest plans, so the choice holds for any
  // plan that route takes
  return best_cluster(
      [=](int c, ClusterLaunch* L) {
        return migrate_launch(B, n, c, MIGRATE_STAGE, MIGRATE_STAGE, 0, L);
      },
      B, max_cluster_for_slice(n, MIGRATE_MIN_SLICE), cluster);
}

// `cluster` CTAs a lane (1..16); a cluster the device cannot schedule is
// refused here, and the caller raises.
extern "C" int arms_tier_migrate(const int* tier, const int* promote,
                                 const int* demote, const int* caps,
                                 int* tier_out, uint8_t* pexec, uint8_t* dexec,
                                 int* mig_up, int* mig_down, int B, int n,
                                 int R, int P, int D, int cluster,
                                 cudaStream_t stream) {
  ClusterLaunch L;
  cudaError_t err = migrate_launch(B, n, cluster, P, D, stream, &L);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(
      &L.cfg, L.mode ? tier_migrate_wide_kernel : tier_migrate_kernel, tier,
      promote, demote, caps, tier_out, pexec, dexec, mig_up, mig_down, n, R, P,
      D, L.slice);
  if (err != cudaSuccess) return (int)err;
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
// takes, and whether it stays in shared memory (`mode`).
static cudaError_t topk_launch(int B, int n, int cluster, cudaStream_t stream,
                               ClusterLaunch* L) {
  if (cluster < 1 || cluster > 16) return cudaErrorInvalidValue;
  L->slice = (n + cluster - 1) / cluster;
  L->slice = (L->slice + TOPK_RUN - 1) / TOPK_RUN * TOPK_RUN;
  L->mode = L->slice <= TOPK_SMEM_KEYS ? 1 : 0;
  const size_t smem = L->mode ? sizeof(uint32_t) * (size_t)L->slice : 0;
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
  return best_cluster(
      [=](int c, ClusterLaunch* L) { return topk_launch(B, n, c, 0, L); }, B,
      max_cluster_for_slice(n, TOPK_MIN_SLICE), cluster);
}

// `cluster` CTAs a row (1..16); a cluster the device cannot schedule is
// refused here, and the caller raises.
extern "C" int arms_topk_mask(const float* x, uint8_t* mask, int B, int n,
                              int k, int cluster, cudaStream_t stream) {
  ClusterLaunch L;
  cudaError_t err = topk_launch(B, n, cluster, stream, &L);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&L.cfg, topk_mask_kernel, x, mask, n, k, L.slice,
                           L.mode);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
