// Paged decode attention, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention/kernel.py
// (paged_attention_kernel): one query token per sequence attends, GQA, over
// the KV pages its block table names, with tokens at or past seq_lens[b]
// masked (score -1e30), an f32 softmax and the max(L, 1e-30) guard; the
// output has q's dtype (f32 or bf16).  The serving layer also needs each
// page's attention mass, the sum of the softmax probabilities of its tokens
// over heads, which the TPU kernel's online softmax never writes out.  Build:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libpaged_attention.so paged_attention.cu
//
// Bound: bytes.  Decode reads every valid K and V page once and does about
// 4 flops per element read, far below the card's 295 flops a byte, so the
// tensor cores are not needed.  The TPU kernel walks a sequence's pages in
// order on one core with the online softmax carried in VMEM; on Hopper that
// walk would leave most SMs idle, and a split over blocks that meet again
// through device memory costs launches and a round trip of partial sums.
// What is left is latency: every serial step of a CTA (a load round, a
// cluster barrier) costs about a microsecond, as much as a tenth of the
// bytes.  Design, two launches a call:
//
//   1. pa_decode: each (sequence, KV head) on a thread-block cluster of C
//      CTAs (arms_paged_cluster: the most, up to 16, at which the device
//      holds every cluster at once; past that the clusters run in two
//      waves and the time doubles).  The table entries that hold a valid
//      token (all of them when none does) are split evenly over the CTAs,
//      a contiguous run each, so a long table with a short sequence still
//      spreads its few pages; the entries past seq_lens[b] are not walked,
//      only their mass is zeroed.  A CTA walks its entries in tiles of
//      whole pages (at most PA_TILE_TOK tokens and PA_TILE_FLOATS scores),
//      so its shared memory does not grow with the table.  It reads its
//      pages' K and V once and serves all rep query rows of the head from
//      that one read:
//        * K rows come in 16-byte words, a warp a token (lanes over a
//          column block of head_dim; the blocks' partial sums add up in
//          registers), PA_TOK tokens of a warp in flight; each lane forms
//          its partial dot products of PA_TOK tokens x PA_ROWS rows (q in
//          registers) and one transposing butterfly (31 shuffles) leaves
//          one score a lane;
//        * the CTA's own online softmax over its tiles: a warp a row takes
//          the tile's maximum, the running maximum m_c, p = exp(s - m_c),
//          each page's sum of p in token order (written with m_c to the
//          two planes of the per-head mass scratch), alpha = exp(m_old -
//          m_c) and l = l alpha + the tile's sum; the running sums of p v
//          (V read as K was, warp by warp in token order) are kept in
//          shared memory, acc = acc alpha + the warps' sums in warp order;
//        * the CTAs meet once: each stores its m_c and l into every CTA's
//          shared memory (DSMEM) and its p v sums into the CTA that
//          combines them (output element x to rank x % C); after one
//          cluster barrier every CTA takes M = the max of the m_c, rank k's
//          weight w_k = exp(m_k - M) and L = sum of l_k w_k in rank order
//          (the same bits everywhere), combines its share of the output in
//          rank order (= table order), sum of w_k acc_k over L, and turns
//          its own pages' sums into the heads' mass, l_page exp(m_page -
//          M) / L.  Nothing is read from another CTA after that barrier, so
//          no CTA waits to leave, and no sum of p v goes to device memory.
//   2. pa_mass (only when the page mass is asked for), a programmatic
//      dependent launch that starts while pa_decode runs: a warp a
//      (sequence, table entry) sums the heads' mass in f64, lanes in head
//      order, then a butterfly; rounded once.
//
// A table entry out of the pool's range is clamped into it (the
// reference's gather clamps too), so no entry reads outside the pools.
// With any valid token, every CTA with an entry to walk holds one, so a
// masked token's p = exp(-1e30 - m) is exactly 0 (and a CTA with nothing
// to walk weighs 0): it is neither read nor added, and a page with no
// valid token has exactly 0 mass.  When no token is valid, M = -1e30 and
// every p and weight is 1: the output is the mean of V, as in the
// reference.  Every sum runs in a fixed
// order and nothing is atomic, so two runs give the same bits: the mass
// feeds an exact ranking (ARMS's EWMA and top-k).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../cluster.cuh"

namespace cg = cooperative_groups;

#define PA_THREADS 128                  // four warps a CTA
#define PA_WARPS (PA_THREADS / 32)
#define PA_TOK 8                        // tokens a warp has in flight
#define PA_ROWS 4                       // query rows a pass serves at once
#define PA_MAX_CHUNKS 2                 // 16-byte words a lane holds of a
                                        //   column block
#define PA_TILE_TOK 256                 // tokens of a tile, at most ...
#define PA_TILE_FLOATS 8192             // ... and rep x tokens (at least a
                                        //   page)
#define PA_SMEM_LIMIT 232448            // shared memory a block may use
#define PA_MIN_BLOCKS 5                 // resident CTAs an SM (f32, one word)
#define NEG_INF_SCORE -1e30f

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t word(const uint4& w, int k) {
  return k == 0 ? w.x : k == 1 ? w.y : k == 2 ? w.z : w.w;
}

// Element j of a 16-byte word of T elements, as f32 (exact).
template <typename T> struct Words;
template <> struct Words<float> {
  static constexpr int kVec = 4;
  __device__ static float get(const uint4& w, int j) {
    return __uint_as_float(word(w, j));
  }
  __device__ static uint32_t bits(float x, int) { return __float_as_uint(x); }
};
template <> struct Words<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static float get(const uint4& w, int j) {
    const uint32_t u = word(w, j >> 1);
    return __uint_as_float((j & 1) ? (u & 0xffff0000u) : (u << 16));
  }
  __device__ static uint32_t bits(__nv_bfloat16 x, int j) {
    return (uint32_t)__bfloat16_as_ushort(x) << (16 * (j & 1));
  }
};

// The 16-byte word of `row` from element e0 (zero past dh): one load where
// rows are 16-byte aligned (`vec`), else element by element.
template <typename T>
__device__ __forceinline__ uint4 row_word(const T* row, int e0, int dh,
                                          bool vec) {
  constexpr int V = Words<T>::kVec;
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  if (e0 >= dh) return w;
  if (vec) return *reinterpret_cast<const uint4*>(row + e0);
  uint32_t u[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (e0 + j < dh) u[j * 4 / V] |= Words<T>::bits(row[e0 + j], j);
  return make_uint4(u[0], u[1], u[2], u[3]);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
// One step of warp_transpose_sum: lanes O apart swap halves of their first
// 2 O values and add, keeping O.
template <int O>
__device__ __forceinline__ void transpose_step(float (&v)[32], int lane) {
  const bool hi = (lane & O) != 0;
#pragma unroll
  for (int k = 0; k < O; ++k) {
    const float send = hi ? v[k] : v[k + O];
    const float keep = hi ? v[k + O] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// Lane i gets the sum over the warp of every lane's v[i] (32 sums for 31
// shuffles), in a fixed order; v is consumed.
__device__ __forceinline__ float warp_transpose_sum(float (&v)[32]) {
  const int lane = threadIdx.x & 31;
  transpose_step<16>(v, lane);
  transpose_step<8>(v, lane);
  transpose_step<4>(v, lane);
  transpose_step<2>(v, lane);
  transpose_step<1>(v, lane);
  return v[0];
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Table entries a tile of a CTA takes: whole pages, at most PA_TILE_TOK
// tokens and PA_TILE_FLOATS scores, at least one page, at most the slice.
__host__ __device__ __forceinline__ int pa_tile_pages(int rep, int page,
                                                      int slice) {
  int tok = PA_TILE_FLOATS / rep;
  tok = tok < PA_TILE_TOK ? tok : PA_TILE_TOK;
  int tp = tok / page;
  tp = tp < 1 ? 1 : tp;
  return tp < slice ? tp : slice;
}

// Shared memory of a pa_decode CTA, in 4-byte words from the start: the
// layout the launcher sizes and the kernel cuts.  None of it grows with
// the table: `tp` entries a tile, `cb` head_dim elements a column block.
struct PaLayout {
  int qs, acc, sc, red, mall, lall, ms, ls, al, accp, rows, words;
  __host__ __device__ PaLayout(int rep, int dh, int tp, int page, int cb,
                               int C) {
    const int per = (rep * dh + C - 1) / C;
    qs = 0;                            // [rep][dh] query rows, f32
    acc = qs + rep * dh;               // [rep][dh] running sums of p v
    sc = acc + rep * dh;               // [rep][tp * page] scores, then p
    red = sc + rep * tp * page;        // [PA_WARPS][PA_ROWS][cb] warp sums
    mall = red + PA_WARPS * PA_ROWS * cb;   // [C][rep] every rank's max,
                                            //   then its weight
    lall = mall + C * rep;             // [C][rep] every rank's sum of p
    ms = lall + C * rep;               // [rep] running max, then M
    ls = ms + rep;                     // [rep] running sum of p, then
                                       //   max(L, 1e-30)
    al = ls + rep;                     // [rep] the tile's alpha
    accp = al + rep;                   // [C][per] every rank's p v sums of
                                       //   this rank's output elements
    rows = accp + C * per;             // [tp] i32 pool rows of a tile
    words = rows + tp;
  }
};

// Resident CTAs an SM a variant asks for.  The f32 variant of one 16-byte
// word a lane, the serving path's, asks for PA_MIN_BLOCKS: at 5 nvcc 12.8
// keeps it in 96 registers without a spill, and an H100 then holds the
// serving fold's 64 clusters of 8 CTAs at once (of 7 at its own 128
// registers).  The others would spill under that cap.
template <typename T, int NCH, bool WIDE> struct PaMinBlocks {
  static constexpr int value =
      sizeof(T) == 4 && NCH == 1 && !WIDE ? PA_MIN_BLOCKS : 1;
};

// mass_h: two planes of [B, n_pp, H] f32 (each page's sum of p, and the
// running max it is relative to), or null; the first becomes the heads'
// mass.  WIDE: head_dim spans more than one column block (else the block
// loops compile away, and with them the registers they hold).
template <typename T, int NCH, bool WIDE>
__global__ void __launch_bounds__(PA_THREADS,
                                  (PaMinBlocks<T, NCH, WIDE>::value))
    pa_decode(const T* __restrict__ q, const T* __restrict__ kp,
              const T* __restrict__ vp, const int* __restrict__ tables,
              const int* __restrict__ lens, T* __restrict__ out,
              float* __restrict__ mass_h, int P, int H, int KV, int page,
              int dh, int n_pp, int slice, int vec, float scale) {
  constexpr int V = Words<T>::kVec;
  constexpr int CB = 32 * V * NCH;   // elements of a column block
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int C = (int)cluster.num_blocks();
  cluster_arrive_relaxed();   // once it completes, every CTA has started
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y / KV, kv = blockIdx.y % KV;
  const int rep = H / KV, h0 = kv * rep;
  const int len = lens[b];
  // entries walked: those with a valid token, or all when none is valid,
  // split evenly over the cluster (the launcher's `slice` splits the whole
  // table: it sizes the tiles, and says which masked entries a CTA zeroes)
  const int live = len <= 0 ? n_pp : min(n_pp, (len + page - 1) / page);
  const int walk = (live + C - 1) / C;
  const int i0 = rank * walk;                         // first table entry
  const int npg = max(0, min(walk, live - i0));       // entries of this CTA
  const int t0 = i0 * page;
  const int per = (rep * dh + C - 1) / C;
  const int ncb = WIDE ? (dh + CB - 1) / CB : 1;   // column blocks
  const int tp = pa_tile_pages(rep, page, slice), TT = tp * page;
  const int ntiles = (npg + tp - 1) / tp;
  const int64_t plane = (int64_t)(gridDim.y / KV) * n_pp * H;
  const PaLayout lay(rep, dh, tp, page, CB, C);
  float* qs = sm + lay.qs;
  float* acc = sm + lay.acc;
  float* sc = sm + lay.sc;
  float* red = sm + lay.red;
  float* mall = sm + lay.mall;
  float* lall = sm + lay.lall;
  float* ms = sm + lay.ms;
  float* ls = sm + lay.ls;
  float* al = sm + lay.al;
  float* accp = sm + lay.accp;
  int* prow = reinterpret_cast<int*>(sm + lay.rows);
  const int* tab = tables + (int64_t)b * n_pp + i0;
  // element offset of a tile's token tl in a pool (table entries clamped)
  auto row_off = [&](int tl) -> int64_t {
    const int64_t r = prow[tl / page];
    return ((r * page + tl % page) * KV + kv) * (int64_t)dh;
  };
  // index of table entry i, query row r in a plane of mass_h
  auto mass_at = [&](int i, int r) -> int64_t {
    return ((int64_t)b * n_pp + i) * H + h0 + r;
  };

  for (int x = tid; x < rep * dh; x += PA_THREADS) {
    qs[x] = to_f(q[((int64_t)b * H + h0) * dh + x]);
    acc[x] = 0.0f;
  }
  for (int r = tid; r < rep; r += PA_THREADS) {
    ms[r] = -INFINITY;
    ls[r] = 0.0f;
  }

  for (int tile = 0; tile < ntiles; ++tile) {
    const int p0 = tile * tp, tpg = min(tp, npg - p0);
    const int c0 = t0 + p0 * page;   // the tile's first token
    const int ttok = tpg * page;
    // tokens whose V is read: the valid ones, or all when none is valid
    auto need_v = [&](int tl) { return c0 + tl < len || len <= 0; };
    for (int ii = tid; ii < tpg; ii += PA_THREADS)
      prow[ii] = min(max(tab[p0 + ii], 0), P - 1);
    __syncthreads();

    // scores, PA_ROWS query rows at a time (held in registers a column
    // block at a time), a warp PA_TOK tokens at a time: each lane's partial
    // dot products of the 32 (token, row) pairs over the column blocks,
    // then one transposing butterfly leaves lane i the score of token
    // i / PA_ROWS and row i % PA_ROWS.  A batch with no valid token is
    // neither read nor summed.
    static_assert(PA_TOK * PA_ROWS == 32, "one score a lane");
    for (int r0 = 0; r0 < rep; r0 += PA_ROWS) {
      float qr[PA_ROWS][NCH][V];
      auto load_q = [&](int cb) {
#pragma unroll
        for (int rr = 0; rr < PA_ROWS; ++rr)
#pragma unroll
          for (int c = 0; c < NCH; ++c)
#pragma unroll
            for (int j = 0; j < V; ++j) {
              const int e = cb * CB + (c * 32 + lane) * V + j;
              qr[rr][c][j] = (r0 + rr < rep && e < dh)
                                 ? qs[(r0 + rr) * dh + e] : 0.0f;
            }
      };
      load_q(0);
      for (int base = warp * PA_TOK; base < ttok;
           base += PA_WARPS * PA_TOK) {
        const int tl = base + lane / PA_ROWS, r = r0 + lane % PA_ROWS;
        const bool mine = tl < ttok && r < rep;
        if (c0 + base >= len) {   // no valid token: nothing to read
          if (mine) sc[r * TT + tl] = NEG_INF_SCORE;
          continue;
        }
        float part[32];
#pragma unroll
        for (int k = 0; k < 32; ++k) part[k] = 0.0f;
        for (int cb = 0; cb < ncb; ++cb) {
          if (ncb > 1) load_q(cb);
          uint4 kw[PA_TOK][NCH];
#pragma unroll
          for (int u = 0; u < PA_TOK; ++u) {
            const bool live = base + u < ttok && c0 + base + u < len;
            const T* kr = kp + (live ? row_off(base + u) : 0);
#pragma unroll
            for (int c = 0; c < NCH; ++c)
              kw[u][c] = live ? row_word(kr, cb * CB + (c * 32 + lane) * V,
                                         dh, vec != 0)
                              : make_uint4(0u, 0u, 0u, 0u);
          }
#pragma unroll
          for (int u = 0; u < PA_TOK; ++u)
#pragma unroll
            for (int rr = 0; rr < PA_ROWS; ++rr) {
              float d = part[u * PA_ROWS + rr];
#pragma unroll
              for (int c = 0; c < NCH; ++c)
#pragma unroll
                for (int j = 0; j < V; ++j)
                  d += qr[rr][c][j] * Words<T>::get(kw[u][c], j);
              part[u * PA_ROWS + rr] = d;
            }
        }
        const float s = warp_transpose_sum(part);
        if (mine) sc[r * TT + tl] = c0 + tl < len ? s * scale : NEG_INF_SCORE;
      }
    }
    __syncthreads();

    // the online softmax, a warp a row: the running max m, p = exp(s - m),
    // each page's sum of p in token order (to the mass planes, with m),
    // the tile's sum over its pages (lanes in page order, then a
    // butterfly), alpha = exp(m_old - m) and l = l alpha + that sum
    for (int r = warp; r < rep; r += PA_WARPS) {
      float m = -INFINITY;
      for (int tl = lane; tl < ttok; tl += 32) m = fmaxf(m, sc[r * TT + tl]);
      m = fmaxf(ms[r], warp_max(m));
      for (int tl = lane; tl < ttok; tl += 32)
        sc[r * TT + tl] = expf(sc[r * TT + tl] - m);
      __syncwarp();
      float lt = 0.0f;
      for (int ii = lane; ii < tpg; ii += 32) {
        float l = 0.0f;
        for (int j = 0; j < page; ++j) l += sc[r * TT + ii * page + j];
        if (mass_h != nullptr) {
          mass_h[mass_at(i0 + p0 + ii, r)] = l;
          mass_h[plane + mass_at(i0 + p0 + ii, r)] = m;
        }
        lt += l;
      }
      lt = warp_sum(lt);
      if (lane == 0) {
        const float a = expf(ms[r] - m);
        al[r] = a;
        ls[r] = ls[r] * a + lt;
        ms[r] = m;
      }
    }
    __syncthreads();

    // sums of p v over the tile's tokens, PA_ROWS query rows and a column
    // block at a time, in registers, then acc = acc alpha + the warps' sums
    for (int r0 = 0; r0 < rep; r0 += PA_ROWS) {
      const int nr = min(PA_ROWS, rep - r0);
      for (int cb = 0; cb < ncb; ++cb) {
        float pv[PA_ROWS][NCH][V];
#pragma unroll
        for (int rr = 0; rr < PA_ROWS; ++rr)
#pragma unroll
          for (int c = 0; c < NCH; ++c)
#pragma unroll
            for (int j = 0; j < V; ++j) pv[rr][c][j] = 0.0f;
        for (int base = warp * PA_TOK; base < ttok;
             base += PA_WARPS * PA_TOK) {
          if (!need_v(base)) continue;   // nor any later token of the batch
          uint4 vw[PA_TOK][NCH];
#pragma unroll
          for (int u = 0; u < PA_TOK; ++u) {
            const int tl = base + u;
            const bool live = tl < ttok && need_v(tl);
            const T* vr = vp + (live ? row_off(tl) : 0);
#pragma unroll
            for (int c = 0; c < NCH; ++c)
              vw[u][c] = live ? row_word(vr, cb * CB + (c * 32 + lane) * V,
                                         dh, vec != 0)
                              : make_uint4(0u, 0u, 0u, 0u);
          }
#pragma unroll
          for (int u = 0; u < PA_TOK; ++u) {
            const int tl = base + u;
            if (tl >= ttok || !need_v(tl)) continue;
#pragma unroll
            for (int rr = 0; rr < PA_ROWS; ++rr) {
              if (rr >= nr) break;
              const float p = sc[(r0 + rr) * TT + tl];
#pragma unroll
              for (int c = 0; c < NCH; ++c)
#pragma unroll
                for (int j = 0; j < V; ++j)
                  pv[rr][c][j] = pv[rr][c][j] + p * Words<T>::get(vw[u][c], j);
            }
          }
        }
#pragma unroll
        for (int rr = 0; rr < PA_ROWS; ++rr)
#pragma unroll
          for (int c = 0; c < NCH; ++c)
#pragma unroll
            for (int j = 0; j < V; ++j) {
              const int el = (c * 32 + lane) * V + j;
              if (rr < nr && cb * CB + el < dh)
                red[(warp * PA_ROWS + rr) * CB + el] = pv[rr][c][j];
            }
        __syncthreads();
        for (int x = tid; x < nr * CB; x += PA_THREADS) {
          const int rr = x / CB, el = x % CB, e = cb * CB + el;
          if (e >= dh) continue;
          float a = 0.0f;
          for (int w = 0; w < PA_WARPS; ++w)
            a += red[(w * PA_ROWS + rr) * CB + el];
          float* dst = acc + (r0 + rr) * dh + e;
          *dst = *dst * al[r0 + rr] + a;
        }
        __syncthreads();   // `red` serves the next block
      }
    }
  }

  cluster_wait();   // every CTA has started: its shared memory may be written
  for (int r = tid; r < rep; r += PA_THREADS)
    for (int k = 0; k < C; ++k) {
      cluster.map_shared_rank(mall, k)[rank * rep + r] = ms[r];
      cluster.map_shared_rank(lall, k)[rank * rep + r] = ls[r];
    }
  for (int x = tid; x < rep * dh; x += PA_THREADS)
    cluster.map_shared_rank(accp, x % C)[rank * per + x / C] = acc[x];
  cluster_arrive_release();
  cluster_wait();   // every rank's sums are here; nothing remote after this

  // the table's M = max of the ranks' maxima; rank k's weight exp(m_k - M)
  // (in place of its maximum) and L = sum of its l weighted, in rank order
  for (int r = tid; r < rep; r += PA_THREADS) {
    float M = -INFINITY;
    for (int k = 0; k < C; ++k) M = fmaxf(M, mall[k * rep + r]);
    float L = 0.0f;
    for (int k = 0; k < C; ++k) {
      const float w = expf(mall[k * rep + r] - M);
      mall[k * rep + r] = w;
      L += lall[k * rep + r] * w;
    }
    ms[r] = M;
    ls[r] = fmaxf(L, 1e-30f);
  }
  __syncthreads();
  for (int k = tid; k < per; k += PA_THREADS) {
    const int xo = k * C + rank;
    if (xo >= rep * dh) break;
    const int r = xo / dh, e = xo % dh;
    float a = 0.0f;
    for (int s = 0; s < C; ++s) a += accp[s * per + k] * mall[s * rep + r];
    out[((int64_t)b * H + h0 + r) * dh + e] = from_f<T>(a / ls[r]);
  }
  if (mass_h != nullptr) {
    for (int x = tid; x < rep * npg; x += PA_THREADS) {
      const int r = x / npg;
      const int64_t at = mass_at(i0 + x % npg, r);
      mass_h[at] = mass_h[at] * expf(mass_h[plane + at] - ms[r]) / ls[r];
    }
    // entries with no valid token, of this CTA's share of the table
    const int z0 = max(live, rank * slice);
    const int nz = max(0, min(n_pp, (rank + 1) * slice) - z0);
    for (int x = tid; x < rep * nz; x += PA_THREADS)
      mass_h[mass_at(z0 + x % nz, x / nz)] = 0.0f;
  }
}

// mass [B, n_pp] from the first plane of mass_h: a warp an entry, f64,
// rounded once
__global__ void pa_mass(const float* __restrict__ mass_h,
                        float* __restrict__ mass, int rows, int H) {
  const int w = (int)((blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  // launched early (programmatic dependent launch): wait for pa_decode
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (w >= rows) return;
  double s = 0.0;
  for (int h = lane; h < H; h += 32) s += (double)mass_h[(int64_t)w * H + h];
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) mass[w] = (float)s;
}

// 16-byte words a lane holds of a column block: 1 where one block of 32
// words covers head_dim, else 2 (column blocks of 64 words); and whether
// head_dim spans more than one block.
static int pa_chunks(int dh, int dtype) {
  const int V = dtype == 0 ? 4 : 8;
  return dh <= 32 * V ? 1 : PA_MAX_CHUNKS;
}
static bool pa_wide(int dh, int dtype) {
  return dh > 32 * (dtype == 0 ? 4 : 8) * PA_MAX_CHUNKS;
}

template <typename T>
static const void* decode_kernel(int nch, bool wide) {
  return wide ? (const void*)pa_decode<T, 2, true>
              : nch == 1 ? (const void*)pa_decode<T, 1, false>
                         : (const void*)pa_decode<T, 2, false>;
}

// The launch of pa_decode on `cluster` CTAs a (sequence, KV head); `mode`
// is whether K and V rows load in 16-byte words.
static cudaError_t pa_launch(int B, int H, int KV, int page, int dh,
                             int n_pp, int dtype, int cluster,
                             uintptr_t align, cudaStream_t stream,
                             ClusterLaunch* L) {
  if (B < 1 || KV < 1 || H % KV != 0 || page < 1 || dh < 1 || n_pp < 1 ||
      (int64_t)B * KV > 65535 || (dtype != 0 && dtype != 1) || cluster < 1 ||
      cluster > 16)
    return cudaErrorInvalidValue;
  const int V = dtype == 0 ? 4 : 8, nch = pa_chunks(dh, dtype);
  const int rep = H / KV, slice = (n_pp + cluster - 1) / cluster;
  const PaLayout lay(rep, dh, pa_tile_pages(rep, page, slice), page,
                     32 * V * nch, cluster);
  const size_t smem = 4 * (size_t)lay.words;
  if (smem > PA_SMEM_LIMIT) return cudaErrorInvalidValue;
  const cudaError_t err = cluster_config(
      dtype == 0 ? decode_kernel<float>(nch, pa_wide(dh, dtype))
                 : decode_kernel<__nv_bfloat16>(nch, pa_wide(dh, dtype)),
      B * KV, cluster, PA_THREADS, smem, stream, L);
  L->slice = slice;
  L->mode = (dh % V == 0 && (align & 15) == 0) ? 1 : 0;
  return err;
}

// The CTAs a (sequence, KV head) takes: the most, up to 16 and at most one
// a table entry, at which the device holds all B x KV clusters at once; 1
// where it holds none of those.  A shape whose CTA does not fit is refused.
extern "C" int arms_paged_cluster(int B, int H, int KV, int page, int dh,
                                  int n_pp, int dtype, int* cluster) {
  return best_cluster(
      [=](int c, ClusterLaunch* L) {
        return pa_launch(B, H, KV, page, dh, n_pp, dtype, c, 0, 0, L);
      },
      B * KV, n_pp, cluster);
}

template <typename T, int NCH, bool WIDE>
static cudaError_t launch_variant(const ClusterLaunch& L, int dh,
                                  const void* q, const void* kp,
                                  const void* vp, const int* tables,
                                  const int* lens, void* out, float* mass_h,
                                  int P, int H, int KV, int page, int n_pp,
                                  float scale) {
  return cudaLaunchKernelEx(&L.cfg, pa_decode<T, NCH, WIDE>, (const T*)q,
                            (const T*)kp, (const T*)vp, tables, lens, (T*)out,
                            mass_h, P, H, KV, page, dh, n_pp, L.slice, L.mode,
                            scale);
}

template <typename T>
static cudaError_t launch_decode(const ClusterLaunch& L, int dh,
                                 const void* q, const void* kp,
                                 const void* vp, const int* tables,
                                 const int* lens, void* out, float* mass_h,
                                 int P, int H, int KV, int page, int n_pp,
                                 float scale) {
  const int dtype = sizeof(T) == 4 ? 0 : 1;
  auto* launch = pa_wide(dh, dtype) ? launch_variant<T, 2, true>
                 : pa_chunks(dh, dtype) == 1 ? launch_variant<T, 1, false>
                                             : launch_variant<T, 2, false>;
  return launch(L, dh, q, kp, vp, tables, lens, out, mass_h, P, H, KV, page,
                n_pp, scale);
}

// dtype: 0 = f32, 1 = bf16.  mass_h [2, B, n_pp, H] f32 scratch and mass
// [B, n_pp] f32, or both null.  `cluster` CTAs a (sequence, KV head), 1..16
// (CTAs past the table's end take no entry); a cluster the device cannot
// schedule is refused here, and the caller raises.
extern "C" int arms_paged_attention(const void* q, const void* kp,
                                    const void* vp, const int* tables,
                                    const int* lens, void* out,
                                    float* mass_h, float* mass, int P, int B,
                                    int H, int KV, int page, int dh,
                                    int n_pp, float scale, int dtype,
                                    int cluster, cudaStream_t stream) {
  if (P < 1 || (mass == nullptr) != (mass_h == nullptr))
    return (int)cudaErrorInvalidValue;
  ClusterLaunch L;
  cudaError_t err = pa_launch(B, H, KV, page, dh, n_pp, dtype, cluster,
                              (uintptr_t)kp | (uintptr_t)vp, stream, &L);
  if (err != cudaSuccess) return (int)err;
  err = dtype == 0 ? launch_decode<float>(L, dh, q, kp, vp, tables, lens,
                                          out, mass_h, P, H, KV, page, n_pp,
                                          scale)
                   : launch_decode<__nv_bfloat16>(L, dh, q, kp, vp, tables,
                                                  lens, out, mass_h, P, H, KV,
                                                  page, n_pp, scale);
  if (err != cudaSuccess) return (int)err;
  if (mass != nullptr) {   // may start while pa_decode runs, then waits
    const int rows = B * n_pp;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    cfg.gridDim = dim3((rows + 3) / 4);
    cfg.blockDim = dim3(128);
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, pa_mass, (const float*)mass_h, mass, rows,
                             H);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
