// Tiled causal GQA flash attention, forward and backward, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_kernel): q [B, S, H, DQ], k [B, S, KV, DQ], v [B, S, KV,
// DV] with H = KV * rep, query head h reading KV head h / rep; scores scaled
// by DQ^-0.5, masked (kj <= qi when causal, kj > qi - window when window >
// 0) at -1e30, an online softmax in f32, and the output [B, S, H, DV]
// acc / max(l, 1e-30) in q's dtype (f32 or bf16).  The widths come in the
// pairs (DQ, DV) = (16, 16), (64, 64), (128, 128), (32, 16) and (192, 128):
// the last two are MLA's (q and k of width nope + rope, v of width v_head,
// reduced and at deepseek-v2's published widths), where the TPU kernel
// takes v as wide as q.  Unlike the TPU kernel it takes any S >= 1 (a
// ragged last tile is masked) and also computes the gradient, which the JAX
// package only gets by differentiating its XLA path.  Build:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu
//
// Bound: operations.  At the training shape (S = 4,096, DQ = DV = 64) a
// causal forward does about S / 2 multiply-adds per element it reads, far
// above the card's 295 flops a byte.  Two routes, by dtype:
//
//   * bf16 (the training path): every product on the tensor cores, as
//     wgmma with bf16 operands and f32 accumulators, tiles brought in by
//     TMA into a two-stage ring guarded by mbarriers (the design is noted
//     above the kernels, below).  P and dS are rounded to bf16 before the
//     products that take them (P V; P^T dO, dS^T Q, dS K), as
//     FlashAttention does: the output is not exact to f32 rounding.  The
//     TPU kernel's f32 dots at default precision are themselves bf16
//     passes on the MXU; the bf16 card rows are held to the plain version
//     in f32 within 2e-2.
//   * f32: the products in f32 on the CUDA cores from f32 tiles in shared
//     memory, exact to f32 rounding, as the TPU kernel casts q, k and v to
//     f32 before both products.  The card-vs-CPU train checks and the f32
//     card tests hold this route to 1e-5 against the CPU's f32 products,
//     which a bf16 pass could not meet, so it keeps the CUDA cores.  Every
//     tile is 64 rows; a block of 256 threads is a 16 x 16 grid, thread
//     (ty, tx) owning rows ty + 16 i and columns tx + 16 j (i, j < 4) of a
//     score tile.  Shared-memory rows are width + 1 floats long (odd), so
//     the 16 column threads of a half-warp read 16 distinct banks.  The
//     multiply-adds are explicit fmaf (the library builds with
//     -fmad=false).  At (192, 128) a block's tiles take 145-194 KiB of
//     shared memory (one block an SM).
//
// Both routes run the same four steps, with S = Q K^T over DQ and P V, dV,
// dP = dO V^T and Delta over DV; dK and dQ are DQ wide:
//
//   1. forward: one block per (query tile, sequence x query head), the
//      longest causal rows scheduled first.  It walks the key tiles that
//      hold a valid key (tiles wholly above the diagonal or wholly left of
//      the window are skipped, as pl.when(run) skips them), keeps the
//      running max m, sum l and the output rows in registers, and writes
//      out = acc / max(l, 1e-30) and the row log-sum-exp lse = m + log(l)
//      [B, H, S] f32 for the backward.
//   2. fa_delta: Delta = rowsum(dO * O) [B, H, S] f32, one warp per row.
//   3. dK/dV: one block per (key tile, sequence x KV head).  It loops over
//      the rep query heads of the group and the query tiles that see the
//      tile, recomputes P = exp(s - lse) and dP = dO V^T, forms
//      dS = P (dP - Delta), and sums dV += P^T dO, dK += dS^T Q in
//      registers.
//   4. dQ: one block per (query tile, sequence x query head); it walks the
//      same key tiles as the forward and sums dQ += dS K.
//
// Every output element has one writer and every sum runs in a fixed order:
// no atomics, so two runs give the same bits.

#include <cuda.h>   // CUtensorMap and its enums only: the encoder is looked
                     // up at run time (tensor_map, below), so no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FA_TILE 64
#define FA_THREADS 256
#define FA_NEG -1e30f
#define FA_PLD (FA_TILE + 1)   // row length of the [64, 64] P / dS tiles

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// max / sum over the 16 lanes of a half-warp (one score row's threads)
__device__ __forceinline__ float row_max(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ bool fa_valid(int qi, int kj, int S, int causal,
                                         int window) {
  return qi < S && kj < S && (!causal || kj <= qi) &&
         (window <= 0 || kj > qi - window);
}

// Key tiles [lo, hi] holding a valid key for some query of the tile at q0.
__device__ __forceinline__ void key_tiles(int q0, int S, int causal,
                                          int window, int& lo, int& hi) {
  const int last = causal ? min(S - 1, q0 + FA_TILE - 1) : S - 1;
  const int first = window > 0 ? max(0, q0 - window + 1) : 0;
  lo = first / FA_TILE;
  hi = last / FA_TILE;
}

// Query tiles [lo, hi] holding a query that sees some key of the tile at k0.
__device__ __forceinline__ void query_tiles(int k0, int S, int causal,
                                            int window, int& lo, int& hi) {
  const int first = causal ? k0 : 0;
  const int last = window > 0 ? min(S - 1, k0 + FA_TILE - 2 + window) : S - 1;
  lo = first / FA_TILE;
  hi = last / FA_TILE;
}

// Rows [s0, s0 + 64) of head h of x [B, S, NH, DH] into sm [64][DH + 1] as
// f32; rows at or past S are zero.
template <int DH>
__device__ __forceinline__ void load_tile(float* sm,
                                          const float* __restrict__ x,
                                          int b, int s0, int h, int S,
                                          int NH) {
  for (int e = threadIdx.x; e < FA_TILE * DH; e += blockDim.x) {
    const int r = e / DH, d = e % DH, s = s0 + r;
    sm[r * (DH + 1) + d] =
        s < S ? x[(((int64_t)b * S + s) * NH + h) * DH + d] : 0.0f;
  }
}

// acc[i][j] = sum_d A[ty + 16 i][d] * Bm[tx + 16 j][d] over [64][DH + 1]
// tiles, d in increasing order.
template <int DH>
__device__ __forceinline__ void tile_dot(const float* A, const float* Bm,
                                         int ty, int tx, float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * (DH + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bm[(tx + 16 * j) * (DH + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// ========================================== f32: CUDA cores, exact products

// ------------------------------------------------------------------ forward
template <int DQ, int DV>
__global__ void __launch_bounds__(FA_THREADS)
    fa_fwd(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o,
           float* __restrict__ lse, int S, int H, int KV, int causal,
           int window, float scale) {
  constexpr int LQ = DQ + 1, LV = DV + 1, NC = DV / 16;
  extern __shared__ float sm[];
  float* Qs = sm;
  float* Ks = Qs + FA_TILE * LQ;
  float* Vs = Ks + FA_TILE * LQ;
  float* Ps = Vs + FA_TILE * LV;   // [64][65] probabilities
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FA_TILE;
  const int b = blockIdx.y / H, h = blockIdx.y % H, g = h / (H / KV);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<DQ>(Qs, q, b, q0, h, S, H);
  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = FA_NEG;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }
  int lo, hi;
  key_tiles(q0, S, causal, window, lo, hi);
  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * FA_TILE;
    __syncthreads();   // the previous tile's readers are done
    load_tile<DQ>(Ks, k, b, k0, g, S, KV);
    load_tile<DV>(Vs, v, b, k0, g, S, KV);
    __syncthreads();
    float s[4][4];
    tile_dot<DQ>(Qs, Ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = FA_NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fa_valid(qi, k0 + tx + 16 * j, S, causal, window)
                      ? s[i][j] * scale
                      : FA_NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float ps = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p =
            fa_valid(qi, k0 + tx + 16 * j, S, causal, window)
                ? expf(s[i][j] - m_new)
                : 0.0f;
        Ps[(ty + 16 * i) * FA_PLD + tx + 16 * j] = p;
        ps += p;
      }
      l[i] = alpha * l[i] + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    for (int kk = 0; kk < FA_TILE; ++kk) {
      float p[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * FA_PLD + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = Vs[kk * LV + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    const float L = fmaxf(l[i], 1e-30f);
    float* row = o + (((int64_t)b * S + qi) * H + h) * DV;
#pragma unroll
    for (int c = 0; c < NC; ++c) row[tx + 16 * c] = acc[i][c] / L;
    if (tx == 0) lse[((int64_t)b * H + h) * S + qi] = m[i] + logf(l[i]);
  }
}

// ----------------------------------------------------------------- backward
template <typename T, int DV>
__global__ void fa_delta(const T* __restrict__ o, const T* __restrict__ dout,
                         float* __restrict__ delta, int S, int H,
                         int64_t rows) {
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x >> 5) +
                      (threadIdx.x >> 5);   // (b * S + s) * H + h
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  float acc = 0.0f;
  for (int d = lane; d < DV; d += 32)
    acc = fmaf(to_f(dout[row * DV + d]), to_f(o[row * DV + d]), acc);
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int64_t h = row % H, bs = row / H, s = bs % S, b = bs / S;
    delta[(b * H + h) * S + s] = acc;
  }
}

// P and dS of one (query tile, key tile) pair from s = Q K^T, dp = dO V^T;
// rows ty + 16 i are queries, columns tx + 16 j keys.
__device__ __forceinline__ void probs_and_dscores(
    float s[4][4], float dp[4][4], const float* lse_s, const float* dl_s,
    int q0, int k0, int ty, int tx, int S, int causal, int window,
    float scale) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = fa_valid(q0 + r, k0 + tx + 16 * j, S, causal, window)
                          ? expf(s[i][j] * scale - lse_s[r])
                          : 0.0f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - dl_s[r]);
    }
  }
}

__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int64_t base, int s0, int S) {
  for (int t = threadIdx.x; t < FA_TILE; t += blockDim.x)
    dst[t] = s0 + t < S ? src[base + s0 + t] : 0.0f;
}

template <int DQ, int DV>
__global__ void __launch_bounds__(FA_THREADS)
    fa_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, int S, int H, int KV, int causal,
                int window, float scale) {
  constexpr int LQ = DQ + 1, LV = DV + 1, NQ = DQ / 16, NV = DV / 16;
  extern __shared__ float sm[];
  float* Ks = sm;
  float* Vs = Ks + FA_TILE * LQ;
  float* Qs = Vs + FA_TILE * LV;
  float* dOs = Qs + FA_TILE * LQ;
  float* Ps = dOs + FA_TILE * LV;   // [64 queries][65]
  float* dSs = Ps + FA_TILE * FA_PLD;
  float* lse_s = dSs + FA_TILE * FA_PLD;
  float* dl_s = lse_s + FA_TILE;
  const int k0 = blockIdx.x * FA_TILE;
  const int b = blockIdx.y / KV, g = blockIdx.y % KV, rep = H / KV;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<DQ>(Ks, k, b, k0, g, S, KV);
  load_tile<DV>(Vs, v, b, k0, g, S, KV);
  float dk_acc[4][NQ], dv_acc[4][NV];   // keys ty + 16 i, dims tx + 16 c
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < NQ; ++c) dk_acc[i][c] = 0.0f;
#pragma unroll
    for (int c = 0; c < NV; ++c) dv_acc[i][c] = 0.0f;
  }
  int lo, hi;
  query_tiles(k0, S, causal, window, lo, hi);
  for (int r = 0; r < rep; ++r) {
    const int h = g * rep + r;
    const int64_t row_base = ((int64_t)b * H + h) * S;
    for (int qt = lo; qt <= hi; ++qt) {
      const int q0 = qt * FA_TILE;
      __syncthreads();
      load_tile<DQ>(Qs, q, b, q0, h, S, H);
      load_tile<DV>(dOs, dout, b, q0, h, S, H);
      load_rows(lse_s, lse, row_base, q0, S);
      load_rows(dl_s, delta, row_base, q0, S);
      __syncthreads();
      float s[4][4], dp[4][4];
      tile_dot<DQ>(Qs, Ks, ty, tx, s);
      tile_dot<DV>(dOs, Vs, ty, tx, dp);
      probs_and_dscores(s, dp, lse_s, dl_s, q0, k0, ty, tx, S, causal,
                        window, scale);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          Ps[(ty + 16 * i) * FA_PLD + tx + 16 * j] = s[i][j];
          dSs[(ty + 16 * i) * FA_PLD + tx + 16 * j] = dp[i][j];
        }
      __syncthreads();
      for (int qq = 0; qq < FA_TILE; ++qq) {
        float p[4], ds[4], dov[NV], qv[NQ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = Ps[qq * FA_PLD + ty + 16 * i];
          ds[i] = dSs[qq * FA_PLD + ty + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < NV; ++c) dov[c] = dOs[qq * LV + tx + 16 * c];
#pragma unroll
        for (int c = 0; c < NQ; ++c) qv[c] = Qs[qq * LQ + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int c = 0; c < NV; ++c)
            dv_acc[i][c] = fmaf(p[i], dov[c], dv_acc[i][c]);
#pragma unroll
          for (int c = 0; c < NQ; ++c)
            dk_acc[i][c] = fmaf(ds[i], qv[c], dk_acc[i][c]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= S) continue;
    const int64_t at = ((int64_t)b * S + kj) * KV + g;
#pragma unroll
    for (int c = 0; c < NQ; ++c)
      dk[at * DQ + tx + 16 * c] = dk_acc[i][c] * scale;
#pragma unroll
    for (int c = 0; c < NV; ++c) dv[at * DV + tx + 16 * c] = dv_acc[i][c];
  }
}

template <int DQ, int DV>
__global__ void __launch_bounds__(FA_THREADS)
    fa_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int S, int H, int KV, int causal,
              int window, float scale) {
  constexpr int LQ = DQ + 1, LV = DV + 1, NC = DQ / 16;
  extern __shared__ float sm[];
  float* Qs = sm;
  float* dOs = Qs + FA_TILE * LQ;
  float* Ks = dOs + FA_TILE * LV;
  float* Vs = Ks + FA_TILE * LQ;
  float* dSs = Vs + FA_TILE * LV;   // [64 queries][65]
  float* lse_s = dSs + FA_TILE * FA_PLD;
  float* dl_s = lse_s + FA_TILE;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FA_TILE;
  const int b = blockIdx.y / H, h = blockIdx.y % H, g = h / (H / KV);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t row_base = ((int64_t)b * H + h) * S;

  load_tile<DQ>(Qs, q, b, q0, h, S, H);
  load_tile<DV>(dOs, dout, b, q0, h, S, H);
  load_rows(lse_s, lse, row_base, q0, S);
  load_rows(dl_s, delta, row_base, q0, S);
  float dq_acc[4][NC];   // queries ty + 16 i, dims tx + 16 c
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq_acc[i][c] = 0.0f;
  int lo, hi;
  key_tiles(q0, S, causal, window, lo, hi);
  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * FA_TILE;
    __syncthreads();
    load_tile<DQ>(Ks, k, b, k0, g, S, KV);
    load_tile<DV>(Vs, v, b, k0, g, S, KV);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<DQ>(Qs, Ks, ty, tx, s);
    tile_dot<DV>(dOs, Vs, ty, tx, dp);
    probs_and_dscores(s, dp, lse_s, dl_s, q0, k0, ty, tx, S, causal, window,
                      scale);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dSs[(ty + 16 * i) * FA_PLD + tx + 16 * j] = dp[i][j];
    __syncthreads();
    for (int kk = 0; kk < FA_TILE; ++kk) {
      float ds[4], kv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty + 16 * i) * FA_PLD + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = Ks[kk * LQ + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          dq_acc[i][c] = fmaf(ds[i], kv[c], dq_acc[i][c]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    float* row = dq + (((int64_t)b * S + qi) * H + h) * DQ;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      row[tx + 16 * c] = dq_acc[i][c] * scale;
  }
}

// ===================================================== bf16: tensor cores
//
// Shapes: a block is one warpgroup (128 threads); its products are
// wgmma.m64nNk16 with f32 accumulators, 64 rows a product (BM = 64 query
// or key rows), key and query tiles of BN = 64.  Every tile of q, k, v or
// dO is 64 rows x its width (DQ for q and k, DV for v and dO) of bf16,
// brought into shared memory by TMA from a 4-d tensor map over [B, S,
// heads, width] (a ragged last tile is zero-filled by the hardware) in the
// swizzled layout wgmma reads: 128-byte swizzle in regions of 64 columns
// where the width is a multiple of 64 (64: one region, 128: two, 192:
// three), else 32-byte swizzle in regions of 16 columns (16: one, 32: two).
// The q and k maps share a width, the v and dO maps another; each tensor
// has its own map.  The same tile is a K-major operand (rows x width, for
// S = Q K^T and dP = dO V^T) or, read through an MN-major descriptor
// (trans-b), the B operand [rows, width] of P V, P^T dO, dS^T Q and dS K.
// P and dS never leave registers: a 64 x 64 f32 accumulator of wgmma is,
// pair by pair, the A fragment of the next wgmma, so each is rounded to
// bf16 in registers and fed as the register A operand.  At (192, 128) the
// dK/dV block holds dK (96 floats a thread) and dV (64) in registers beside
// the P^T and dP^T tiles; -Xptxas -v reports what spills.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Waits for the phase after `parity` to complete.  A wait that outlasts
// about ten seconds traps (the launch fails) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > 20000000000LL) __trap();
  }
}

// One TMA box (cols x 1 x 64 x 1) of a [B, S, heads, dh] map into dst.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int head,
                                         int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"((uint64_t)map), "r"(c0), "r"(head), "r"(row), "r"(b), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// After wg_wait: later reads of an accumulator or A fragment depend on this
// (ordered) statement, so none is hoisted above the wait.
template <int N>
__device__ __forceinline__ void keep(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
template <int N>
__device__ __forceinline__ void keep(uint32_t (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(x[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float bf16_half(uint32_t x, int hi) {
  return __uint_as_float(hi ? (x & 0xffff0000u) : (x << 16));
}

// d[64 x 64] (+)= A[64 x 16] B[64 x 16]^T, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A in registers (four bf16 pairs a
// thread), B MN-major in shared memory (trans-b).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 16] += A[64 x 16] B[16 x 16], A in registers (four bf16 pairs a
// thread), B MN-major in shared memory (trans-b).
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                              const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t* a,
                                         uint64_t db) {
  if constexpr (N == 64)
    wgmma_rs_n64(d, a, db);
  else
    wgmma_rs_n16(d, a, db);
}

namespace tc {
constexpr int BM = 64, BN = 64, THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

template <int DH>
struct Tile {
  static constexpr int SW = DH % 64 ? 32 : 128;   // bytes of a region row
  static constexpr int COLS = SW / 2;              // bf16 columns a region
  static constexpr int NREG = DH / COLS;           // regions a tile
  static constexpr int RB = BM * SW;               // bytes a region
  static constexpr int TB = NREG * RB;             // bytes a tile
  static constexpr int NACC = COLS / 2;            // floats of a 64 x COLS acc
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : 3;  // B128 / B32
};

// wgmma shared-memory descriptor of the operand at addr: 8-row groups
// 8 * SW bytes apart (the stride byte offset; the leading byte offset, which
// no operand here uses, is set alike), swizzle of the tile's regions.
template <int DH>
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  using T = Tile<DH>;
  constexpr uint64_t stride = (8 * T::SW) >> 4;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (stride << 16) | (stride << 32) |
         (T::LAYOUT << 62);
}
// K-major operand: all 64 rows, columns [16 kk, 16 kk + 16) of the tile.
template <int DH>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  using T = Tile<DH>;
  return desc<DH>(tile + (16 * kk / T::COLS) * T::RB + (16 * kk % T::COLS) * 2);
}
// MN-major (trans-b) operand: rows [16 kk, 16 kk + 16), region r's columns.
template <int DH>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int r, int kk) {
  using T = Tile<DH>;
  return desc<DH>(tile + r * T::RB + kk * 16 * T::SW);
}

// Rows [row, row + 64) of head `head` of sequence b, every region.
template <int DH>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int head, int row,
                                          int b) {
  using T = Tile<DH>;
#pragma unroll
  for (int r = 0; r < T::NREG; ++r)
    tma_load(dst + r * T::RB, map, bar, r * T::COLS, head, row, b);
}

// Accumulator element j of a 64 x N wgmma product: its row (0 or 8 past the
// thread's first) and column.
__device__ __forceinline__ int acc_row8(int j) { return ((j >> 1) & 1) * 8; }
__device__ __forceinline__ int acc_col(int j, int lane) {
  return 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
}

// The 64 x 64 (query tile at q0, key tile at k0) block needs no mask.
__device__ __forceinline__ bool unmasked(int q0, int k0, int S, int causal,
                                         int window) {
  return k0 + BN <= S && q0 + BM <= S && (!causal || k0 + BN - 1 <= q0) &&
         (window <= 0 || k0 > q0 + BM - 1 - window);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
}  // namespace tc

// ------------------------------------------------------- forward (wgmma)
// One block per (query tile, sequence x query head), longest causal rows
// first.  Q arrives once; K and V tiles through a two-stage ring: thread 0
// starts tile t + 1's TMA into the other stage (freed by the block barrier
// at the top of each step) before the block waits on tile t's mbarrier.
// S = Q K^T, the masked online softmax in f32 in the log2 domain (scores
// times DQ^-0.5 log2 e), P rounded to bf16 in registers, O += P V.
template <int DQ, int DV>
__global__ void __launch_bounds__(tc::THREADS)
    fa_fwd_tc(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int S,
              int H, int KV, int causal, int window, float scale_log2) {
  using TQ = tc::Tile<DQ>;
  using TV = tc::Tile<DV>;
  constexpr uint32_t KV_BYTES = TQ::TB + TV::TB;   // one K and one V tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[3];   // K/V stages 0 and 1, Q
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + TQ::TB, sV = base + 3 * TQ::TB;
  const uint32_t bar0 = smem_u32(&bars[0]), bar_q = smem_u32(&bars[2]);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * tc::BM;
  const int b = blockIdx.y / H, h = blockIdx.y % H, g = h / (H / KV);
  int lo, hi;
  key_tiles(q0, S, causal, window, lo, hi);
  if (tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    mbar_init(bar_q, 1);
    mbar_fence_init();
    mbar_expect_tx(bar_q, TQ::TB);
    tc::load_tile<DQ>(sQ, &tq, bar_q, h, q0, b);
    mbar_expect_tx(bar0, KV_BYTES);
    tc::load_tile<DQ>(sK, &tk, bar0, g, lo * tc::BN, b);
    tc::load_tile<DV>(sV, &tv, bar0, g, lo * tc::BN, b);
  }
  const int row0 = 16 * warp + (lane >> 2);   // and row0 + 8
  float acc[TV::NREG][TV::NACC];
#pragma unroll
  for (int r = 0; r < TV::NREG; ++r)
#pragma unroll
    for (int j = 0; j < TV::NACC; ++j) acc[r][j] = 0.0f;
  float m[2] = {FA_NEG, FA_NEG}, l[2] = {0.0f, 0.0f};   // l: this thread's
  __syncthreads();                                      // columns only
  mbar_wait(bar_q, 0);
  for (int kt = lo; kt <= hi; ++kt) {
    const int it = kt - lo, st = it & 1, k0 = kt * tc::BN;
    __syncthreads();   // every thread is done with stage st ^ 1
    if (tid == 0 && kt < hi) {
      const uint32_t bar = bar0 + 8 * (st ^ 1);
      mbar_expect_tx(bar, KV_BYTES);
      tc::load_tile<DQ>(sK + (st ^ 1) * TQ::TB, &tk, bar, g, k0 + tc::BN, b);
      tc::load_tile<DV>(sV + (st ^ 1) * TV::TB, &tv, bar, g, k0 + tc::BN, b);
    }
    mbar_wait(bar0 + 8 * st, (it >> 1) & 1);
    const uint32_t kst = sK + st * TQ::TB, vst = sV + st * TV::TB;
    float s[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DQ / 16; ++kk)
      wgmma_ss_n64(s, tc::kmajor<DQ>(sQ, kk), tc::kmajor<DQ>(kst, kk), kk);
    wg_commit();
    wg_wait();
    keep(s);
    const bool full = tc::unmasked(q0, k0, S, causal, window);
    float mx[2] = {FA_NEG, FA_NEG};
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      float x = s[j] * scale_log2;
      if (!full && !fa_valid(q0 + row0 + tc::acc_row8(j),
                             k0 + tc::acc_col(j, lane), S, causal, window))
        x = __uint_as_float(0xff800000u);   // -inf
      s[j] = x;
      mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], x);
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], tc::quad_max(mx[i]));
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
    uint32_t pa[16];
#pragma unroll
    for (int j = 0; j < 32; j += 2) {
      const int i = (j >> 1) & 1;
      const float p0 = exp2f(s[j] - m[i]), p1 = exp2f(s[j + 1] - m[i]);
      l[i] += p0 + p1;
      pa[j >> 1] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int r = 0; r < TV::NREG; ++r)
#pragma unroll
      for (int j = 0; j < TV::NACC; ++j) acc[r][j] *= alpha[(j >> 1) & 1];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < tc::BN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < TV::NREG; ++r)
        wgmma_rs<TV::COLS>(acc[r], &pa[4 * kk], tc::mnmajor<DV>(vst, r, kk));
    wg_commit();
    wg_wait();
#pragma unroll
    for (int r = 0; r < TV::NREG; ++r) keep(acc[r]);
    keep(pa);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + row0 + 8 * i;
    const float L = tc::quad_sum(l[i]);
    if (qi >= S) continue;
    const float inv = 1.0f / fmaxf(L, 1e-30f);
    __nv_bfloat16* row = o + (((int64_t)b * S + qi) * H + h) * DV;
#pragma unroll
    for (int r = 0; r < TV::NREG; ++r)
#pragma unroll
      for (int j = 2 * i; j < TV::NACC; j += 4)
        *reinterpret_cast<__nv_bfloat162*>(
            row + r * TV::COLS + tc::acc_col(j, lane)) =
            __floats2bfloat162_rn(acc[r][j] * inv, acc[r][j + 1] * inv);
    if ((lane & 3) == 0)
      lse[((int64_t)b * H + h) * S + qi] = m[i] * tc::LN2 + logf(L);
  }
}

// ---------------------------------------------------- backward (wgmma)
// One step's operands of a dK/dV block: the Q (DQ wide) and dO (DV wide)
// tiles of query head h at row q0 by TMA (thread 0), and the rows' lse
// (times log2 e) and Delta into shared memory (threads below 64; rows past
// S read 0).
template <int DQ, int DV>
__device__ __forceinline__ void dkdv_fetch(
    int h, int q0, int b, int S, int H, uint32_t q_dst, uint32_t do_dst,
    uint32_t bar, const CUtensorMap* tq, const CUtensorMap* tdo,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* lse_row, float* dl_row) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_expect_tx(bar, tc::Tile<DQ>::TB + tc::Tile<DV>::TB);
    tc::load_tile<DQ>(q_dst, tq, bar, h, q0, b);
    tc::load_tile<DV>(do_dst, tdo, bar, h, q0, b);
  }
  if (tid < tc::BM) {
    const int64_t at = ((int64_t)b * H + h) * S + q0 + tid;
    const bool in = q0 + tid < S;
    lse_row[tid] = in ? lse[at] * tc::LOG2E : 0.0f;
    dl_row[tid] = in ? delta[at] : 0.0f;
  }
}

// dK, dV: one block per (key tile, sequence x KV head), the longest causal
// columns first (block x = key tile).  K and V arrive once; (Q, dO) tiles
// of the rep query heads x the query tiles that see this key tile stream
// through a two-stage ring, and rows' lse (times log2 e) and Delta through
// two shared rows written one step ahead.  A step computes the transposed
// scores S^T = K Q^T (keys are the 64 rows), P^T = exp2(S^T scale log2 e -
// lse log2 e) rounded to bf16, then dV += P^T dO together with
// dP^T = V dO^T, then dS^T = P^T (dP^T - Delta) in bf16 and dK += dS^T Q.
template <int DQ, int DV>
__global__ void __launch_bounds__(tc::THREADS)
    fa_bwd_dkdv_tc(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, int S, int H, int KV,
                   int causal, int window, float scale, float scale_log2) {
  using TQ = tc::Tile<DQ>;
  using TV = tc::Tile<DV>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[3];   // Q/dO stages 0 and 1, K/V
  __shared__ float lse_s[2][tc::BM], dl_s[2][tc::BM];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = base, sV = base + TQ::TB, sQ = sV + TV::TB,
                 sdO = sQ + 2 * TQ::TB;
  const uint32_t bar0 = smem_u32(&bars[0]), bar_kv = smem_u32(&bars[2]);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * tc::BN;
  const int b = blockIdx.y / KV, g = blockIdx.y % KV, rep = H / KV;
  int lo, hi;
  query_tiles(k0, S, causal, window, lo, hi);
  const int nq = hi - lo + 1, steps = rep * nq;
  // step i: query head g * rep + i / nq, query tile lo + i % nq, stage i & 1
#define DKDV_FETCH(i)                                                        \
  dkdv_fetch<DQ, DV>(g * rep + (i) / nq, (lo + (i) % nq) * tc::BM, b, S, H, \
                     sQ + ((i) & 1) * TQ::TB, sdO + ((i) & 1) * TV::TB,    \
                     bar0 + 8 * ((i) & 1), &tq, &tdo, lse, delta,          \
                     lse_s[(i) & 1], dl_s[(i) & 1])
  if (tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    mbar_init(bar_kv, 1);
    mbar_fence_init();
    mbar_expect_tx(bar_kv, TQ::TB + TV::TB);
    tc::load_tile<DQ>(sK, &tk, bar_kv, g, k0, b);
    tc::load_tile<DV>(sV, &tv, bar_kv, g, k0, b);
  }
  DKDV_FETCH(0);
  const int row0 = 16 * warp + (lane >> 2);   // keys row0 and row0 + 8
  float dk_acc[TQ::NREG][TQ::NACC], dv_acc[TV::NREG][TV::NACC];
#pragma unroll
  for (int r = 0; r < TQ::NREG; ++r)
#pragma unroll
    for (int j = 0; j < TQ::NACC; ++j) dk_acc[r][j] = 0.0f;
#pragma unroll
  for (int r = 0; r < TV::NREG; ++r)
#pragma unroll
    for (int j = 0; j < TV::NACC; ++j) dv_acc[r][j] = 0.0f;
  __syncthreads();
  mbar_wait(bar_kv, 0);
  for (int i = 0; i < steps; ++i) {
    const int st = i & 1, q0 = (lo + i % nq) * tc::BM;
    __syncthreads();   // stage st ^ 1 is free; stage st's rows are written
    if (i + 1 < steps) DKDV_FETCH(i + 1);
    mbar_wait(bar0 + 8 * st, (i >> 1) & 1);
    const uint32_t qst = sQ + st * TQ::TB, dost = sdO + st * TV::TB;
    float s[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DQ / 16; ++kk)
      wgmma_ss_n64(s, tc::kmajor<DQ>(sK, kk), tc::kmajor<DQ>(qst, kk), kk);
    wg_commit();
    wg_wait();
    keep(s);
    const bool full = tc::unmasked(q0, k0, S, causal, window);
    uint32_t pt[16];
#pragma unroll
    for (int j = 0; j < 32; j += 2) {
      float p[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = tc::acc_col(j + e, lane);
        p[e] = full || fa_valid(q0 + qc, k0 + row0 + tc::acc_row8(j), S,
                                causal, window)
                   ? exp2f(s[j + e] * scale_log2 - lse_s[st][qc])
                   : 0.0f;
      }
      pt[j >> 1] = pack_bf16(p[0], p[1]);
    }
    float dp[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < tc::BM / 16; ++kk)
#pragma unroll
      for (int r = 0; r < TV::NREG; ++r)
        wgmma_rs<TV::COLS>(dv_acc[r], &pt[4 * kk],
                           tc::mnmajor<DV>(dost, r, kk));
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk)
      wgmma_ss_n64(dp, tc::kmajor<DV>(sV, kk), tc::kmajor<DV>(dost, kk), kk);
    wg_commit();
    wg_wait();
#pragma unroll
    for (int r = 0; r < TV::NREG; ++r) keep(dv_acc[r]);
    keep(dp);
    keep(pt);
    uint32_t dst[16];
#pragma unroll
    for (int j = 0; j < 32; j += 2) {
      float ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        ds[e] = bf16_half(pt[j >> 1], e) *
                (dp[j + e] - dl_s[st][tc::acc_col(j + e, lane)]);
      dst[j >> 1] = pack_bf16(ds[0], ds[1]);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < tc::BM / 16; ++kk)
#pragma unroll
      for (int r = 0; r < TQ::NREG; ++r)
        wgmma_rs<TQ::COLS>(dk_acc[r], &dst[4 * kk],
                           tc::mnmajor<DQ>(qst, r, kk));
    wg_commit();
    wg_wait();
#pragma unroll
    for (int r = 0; r < TQ::NREG; ++r) keep(dk_acc[r]);
    keep(dst);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kj = k0 + row0 + 8 * i;
    if (kj >= S) continue;
    const int64_t at = ((int64_t)b * S + kj) * KV + g;
#pragma unroll
    for (int r = 0; r < TQ::NREG; ++r)
#pragma unroll
      for (int j = 2 * i; j < TQ::NACC; j += 4)
        *reinterpret_cast<__nv_bfloat162*>(
            dk + at * DQ + r * TQ::COLS + tc::acc_col(j, lane)) =
            __floats2bfloat162_rn(dk_acc[r][j] * scale,
                                  dk_acc[r][j + 1] * scale);
#pragma unroll
    for (int r = 0; r < TV::NREG; ++r)
#pragma unroll
      for (int j = 2 * i; j < TV::NACC; j += 4)
        *reinterpret_cast<__nv_bfloat162*>(
            dv + at * DV + r * TV::COLS + tc::acc_col(j, lane)) =
            __floats2bfloat162_rn(dv_acc[r][j], dv_acc[r][j + 1]);
  }
}

#undef DKDV_FETCH

// dQ: one block per (query tile, sequence x query head), longest causal
// rows first.  Q and dO arrive once, K and V tiles through a two-stage ring
// as in the forward.  S = Q K^T and dP = dO V^T, dS = P (dP - Delta) with P
// in f32, rounded to bf16 in registers, dQ += dS K.
template <int DQ, int DV>
__global__ void __launch_bounds__(tc::THREADS)
    fa_bwd_dq_tc(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dq, int S, int H, int KV,
                 int causal, int window, float scale, float scale_log2) {
  using TQ = tc::Tile<DQ>;
  using TV = tc::Tile<DV>;
  constexpr uint32_t BYTES = TQ::TB + TV::TB;   // Q + dO, or K + V
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[3];   // K/V stages 0 and 1, Q/dO
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sdO = base + TQ::TB, sK = sdO + TV::TB,
                 sV = sK + 2 * TQ::TB;
  const uint32_t bar0 = smem_u32(&bars[0]), bar_q = smem_u32(&bars[2]);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * tc::BM;
  const int b = blockIdx.y / H, h = blockIdx.y % H, g = h / (H / KV);
  int lo, hi;
  key_tiles(q0, S, causal, window, lo, hi);
  if (tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    mbar_init(bar_q, 1);
    mbar_fence_init();
    mbar_expect_tx(bar_q, BYTES);
    tc::load_tile<DQ>(sQ, &tq, bar_q, h, q0, b);
    tc::load_tile<DV>(sdO, &tdo, bar_q, h, q0, b);
    mbar_expect_tx(bar0, BYTES);
    tc::load_tile<DQ>(sK, &tk, bar0, g, lo * tc::BN, b);
    tc::load_tile<DV>(sV, &tv, bar0, g, lo * tc::BN, b);
  }
  const int row0 = 16 * warp + (lane >> 2);
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + row0 + 8 * i;
    const int64_t at = ((int64_t)b * H + h) * S + qi;
    lse2[i] = qi < S ? lse[at] * tc::LOG2E : 0.0f;
    dl[i] = qi < S ? delta[at] : 0.0f;
  }
  float acc[TQ::NREG][TQ::NACC];
#pragma unroll
  for (int r = 0; r < TQ::NREG; ++r)
#pragma unroll
    for (int j = 0; j < TQ::NACC; ++j) acc[r][j] = 0.0f;
  __syncthreads();
  mbar_wait(bar_q, 0);
  for (int kt = lo; kt <= hi; ++kt) {
    const int it = kt - lo, st = it & 1, k0 = kt * tc::BN;
    __syncthreads();
    if (tid == 0 && kt < hi) {
      const uint32_t bar = bar0 + 8 * (st ^ 1);
      mbar_expect_tx(bar, BYTES);
      tc::load_tile<DQ>(sK + (st ^ 1) * TQ::TB, &tk, bar, g, k0 + tc::BN, b);
      tc::load_tile<DV>(sV + (st ^ 1) * TV::TB, &tv, bar, g, k0 + tc::BN, b);
    }
    mbar_wait(bar0 + 8 * st, (it >> 1) & 1);
    const uint32_t kst = sK + st * TQ::TB, vst = sV + st * TV::TB;
    float s[32], dp[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DQ / 16; ++kk)
      wgmma_ss_n64(s, tc::kmajor<DQ>(sQ, kk), tc::kmajor<DQ>(kst, kk), kk);
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk)
      wgmma_ss_n64(dp, tc::kmajor<DV>(sdO, kk), tc::kmajor<DV>(vst, kk), kk);
    wg_commit();
    wg_wait();
    keep(s);
    keep(dp);
    const bool full = tc::unmasked(q0, k0, S, causal, window);
    uint32_t dsf[16];
#pragma unroll
    for (int j = 0; j < 32; j += 2) {
      const int i = (j >> 1) & 1;
      float ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p =
            full || fa_valid(q0 + row0 + 8 * i, k0 + tc::acc_col(j + e, lane),
                             S, causal, window)
                ? exp2f(s[j + e] * scale_log2 - lse2[i])
                : 0.0f;
        ds[e] = p * (dp[j + e] - dl[i]);
      }
      dsf[j >> 1] = pack_bf16(ds[0], ds[1]);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < tc::BN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < TQ::NREG; ++r)
        wgmma_rs<TQ::COLS>(acc[r], &dsf[4 * kk], tc::mnmajor<DQ>(kst, r, kk));
    wg_commit();
    wg_wait();
#pragma unroll
    for (int r = 0; r < TQ::NREG; ++r) keep(acc[r]);
    keep(dsf);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + row0 + 8 * i;
    if (qi >= S) continue;
    __nv_bfloat16* row = dq + (((int64_t)b * S + qi) * H + h) * DQ;
#pragma unroll
    for (int r = 0; r < TQ::NREG; ++r)
#pragma unroll
      for (int j = 2 * i; j < TQ::NACC; j += 4)
        *reinterpret_cast<__nv_bfloat162*>(
            row + r * TQ::COLS + tc::acc_col(j, lane)) =
            __floats2bfloat162_rn(acc[r][j] * scale, acc[r][j + 1] * scale);
  }
}

// ------------------------------------------------------------------ launch
template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Bytes of the f32 kernels' shared memory: n_q tiles [64][DQ + 1], n_v
// tiles [64][DV + 1], n_p tiles [64][65] and n_rows rows of 64 floats.
static size_t tiles_smem(int dq, int dv, int n_q, int n_v, int n_p,
                         int n_rows) {
  return sizeof(float) * FA_TILE *
         ((size_t)n_q * (dq + 1) + (size_t)n_v * (dv + 1) +
          (size_t)n_p * FA_PLD + (size_t)n_rows);
}

template <int DQ, int DV>
static int fwd_f32(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int S, int H, int KV, int causal,
                   int window, float scale, cudaStream_t stream) {
  const size_t smem = tiles_smem(DQ, DV, 2, 1, 1, 0);
  cudaError_t err = allow_smem(fa_fwd<DQ, DV>, smem);
  if (err != cudaSuccess) return (int)err;
  fa_fwd<DQ, DV><<<dim3((S + FA_TILE - 1) / FA_TILE, B * H), FA_THREADS,
                   smem, stream>>>((const float*)q, (const float*)k,
                                   (const float*)v, (float*)o, lse, S, H, KV,
                                   causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DV>
static int launch_delta(const void* o, const void* dout, float* dl, int B,
                        int S, int H, cudaStream_t stream) {
  const int64_t rows = (int64_t)B * S * H;
  fa_delta<T, DV><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      (const T*)o, (const T*)dout, dl, S, H, rows);
  return (int)cudaGetLastError();
}

template <int DQ, int DV>
static int bwd_f32(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* dl, void* dq,
                   void* dk, void* dv, int B, int S, int H, int KV,
                   int causal, int window, float scale,
                   cudaStream_t stream) {
  using T = float;
  int e = launch_delta<T, DV>(o, dout, dl, B, S, H, stream);
  if (e != 0) return e;
  const int n_tiles = (S + FA_TILE - 1) / FA_TILE;
  const size_t smem_kv = tiles_smem(DQ, DV, 2, 2, 2, 2);
  cudaError_t err = allow_smem(fa_bwd_dkdv<DQ, DV>, smem_kv);
  if (err != cudaSuccess) return (int)err;
  fa_bwd_dkdv<DQ, DV><<<dim3(n_tiles, B * KV), FA_THREADS, smem_kv,
                        stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dl,
      (T*)dk, (T*)dv, S, H, KV, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem_q = tiles_smem(DQ, DV, 2, 2, 1, 2);
  err = allow_smem(fa_bwd_dq<DQ, DV>, smem_q);
  if (err != cudaSuccess) return (int)err;
  fa_bwd_dq<DQ, DV><<<dim3(n_tiles, B * H), FA_THREADS, smem_q, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dl,
      (T*)dq, S, H, KV, causal, window, scale);
  return (int)cudaGetLastError();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &got);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &got);
#endif
    if (err == cudaSuccess && got == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

// x [B, S, NH, DH] bf16 as TMA boxes of (COLS x 1 x 64 x 1): 64 rows of one
// head, one region's columns, swizzled as wgmma reads them.
template <int DH>
static int tensor_map(CUtensorMap* map, const void* x, int B, int S, int NH) {
  using T = tc::Tile<DH>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  if ((uintptr_t)x & 15) return (int)cudaErrorMisalignedAddress;
  const cuuint64_t dims[4] = {(cuuint64_t)DH, (cuuint64_t)NH, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)DH * 2, (cuuint64_t)NH * DH * 2,
                                 (cuuint64_t)S * NH * DH * 2};
  const cuuint32_t box[4] = {(cuuint32_t)T::COLS, 1, (cuuint32_t)tc::BM, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      T::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int DQ, int DV>
static int fwd_bf16(const void* q, const void* k, const void* v, void* o,
                    float* lse, int B, int S, int H, int KV, int causal,
                    int window, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int e;
  if ((e = tensor_map<DQ>(&mq, q, B, S, H)) ||
      (e = tensor_map<DQ>(&mk, k, B, S, KV)) ||
      (e = tensor_map<DV>(&mv, v, B, S, KV)))
    return e;
  // Q, two K stages, two V stages, and the 1024-byte alignment's slack
  const size_t smem = 3 * tc::Tile<DQ>::TB + 2 * tc::Tile<DV>::TB + 1024;
  const cudaError_t err = allow_smem(fa_fwd_tc<DQ, DV>, smem);
  if (err != cudaSuccess) return (int)err;
  fa_fwd_tc<DQ, DV><<<dim3((S + tc::BM - 1) / tc::BM, B * H), tc::THREADS,
                      smem, stream>>>(mq, mk, mv, (__nv_bfloat16*)o, lse, S,
                                      H, KV, causal, window,
                                      scale * tc::LOG2E);
  return (int)cudaGetLastError();
}

template <int DQ, int DV>
static int bwd_bf16(const void* q, const void* k, const void* v,
                    const void* o, const void* dout, const float* lse,
                    float* dl, void* dq, void* dk, void* dv, int B, int S,
                    int H, int KV, int causal, int window, float scale,
                    cudaStream_t stream) {
  int e = launch_delta<__nv_bfloat16, DV>(o, dout, dl, B, S, H, stream);
  if (e != 0) return e;
  CUtensorMap mq, mk, mv, mdo;
  if ((e = tensor_map<DQ>(&mq, q, B, S, H)) ||
      (e = tensor_map<DQ>(&mk, k, B, S, KV)) ||
      (e = tensor_map<DV>(&mv, v, B, S, KV)) ||
      (e = tensor_map<DV>(&mdo, dout, B, S, H)))
    return e;
  const int n_tiles = (S + tc::BM - 1) / tc::BM;
  // three DQ-wide tiles (K or Q, and a two-stage ring of the other) and
  // three DV-wide ones (V or dO, and the ring of the other), each kernel
  const size_t smem = 3 * tc::Tile<DQ>::TB + 3 * tc::Tile<DV>::TB + 1024;
  cudaError_t err = allow_smem(fa_bwd_dkdv_tc<DQ, DV>, smem);
  if (err != cudaSuccess) return (int)err;
  fa_bwd_dkdv_tc<DQ, DV><<<dim3(n_tiles, B * KV), tc::THREADS, smem,
                           stream>>>(
      mq, mk, mv, mdo, lse, dl, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, S, H,
      KV, causal, window, scale, scale * tc::LOG2E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(fa_bwd_dq_tc<DQ, DV>, smem);
  if (err != cudaSuccess) return (int)err;
  fa_bwd_dq_tc<DQ, DV><<<dim3(n_tiles, B * H), tc::THREADS, smem, stream>>>(
      mq, mk, mv, mdo, lse, dl, (__nv_bfloat16*)dq, S, H, KV, causal, window,
      scale, scale * tc::LOG2E);
  return (int)cudaGetLastError();
}

static bool shape_ok(int B, int S, int H, int KV) {
  return B >= 1 && S >= 1 && KV >= 1 && H % KV == 0 && (int64_t)B * H <= 65535;
}

// The (dq, dv) pairs and dtypes instantiated; any other is refused.
#define FA_PAIR(F32, BF16, Q, V)                  \
  if (dq == Q && dv == V) return dtype == 0 ? F32(Q, V) : BF16(Q, V);
#define FA_DISPATCH(F32, BF16)                    \
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue; \
  FA_PAIR(F32, BF16, 16, 16)                      \
  FA_PAIR(F32, BF16, 64, 64)                      \
  FA_PAIR(F32, BF16, 128, 128)                    \
  FA_PAIR(F32, BF16, 32, 16)                      \
  FA_PAIR(F32, BF16, 192, 128)                    \
  return (int)cudaErrorInvalidValue;

// dtype: 0 = f32, 1 = bf16; (dq, dv) one of the pairs above.  q [B, S, H,
// dq], k [B, S, KV, dq], v [B, S, KV, dv], o [B, S, H, dv], lse [B, H, S]
// f32, all contiguous (bf16: 16-byte aligned, for TMA).
extern "C" int arms_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, void* o, float* lse,
                                        int B, int S, int H, int KV, int dq,
                                        int dv, int causal, int window,
                                        float scale, int dtype,
                                        cudaStream_t stream) {
  if (!shape_ok(B, S, H, KV)) return (int)cudaErrorInvalidValue;
#define FA_ARGS q, k, v, o, lse, B, S, H, KV, causal, window, scale, stream
#define FA_F32(Q, V) fwd_f32<Q, V>(FA_ARGS)
#define FA_BF16(Q, V) fwd_bf16<Q, V>(FA_ARGS)
  FA_DISPATCH(FA_F32, FA_BF16)
#undef FA_F32
#undef FA_BF16
#undef FA_ARGS
}

// dout like o; delta [B, H, S] f32 scratch; dq like q, dk like k, dv like v.
extern "C" int arms_flash_attention_bwd(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const void* dout, const float* lse,
                                        float* delta, void* dq_, void* dk,
                                        void* dv_, int B, int S, int H,
                                        int KV, int dq, int dv, int causal,
                                        int window, float scale, int dtype,
                                        cudaStream_t stream) {
  if (!shape_ok(B, S, H, KV)) return (int)cudaErrorInvalidValue;
#define FA_ARGS                                                              \
  q, k, v, o, dout, lse, delta, dq_, dk, dv_, B, S, H, KV, causal, window, \
      scale, stream
#define FA_F32(Q, V) bwd_f32<Q, V>(FA_ARGS)
#define FA_BF16(Q, V) bwd_bf16<Q, V>(FA_ARGS)
  FA_DISPATCH(FA_F32, FA_BF16)
#undef FA_F32
#undef FA_BF16
#undef FA_ARGS
}
