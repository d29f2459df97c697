// Tiled causal GQA flash attention, forward and backward, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_kernel): q [B, S, H, dh], k/v [B, S, KV, dh] with
// H = KV * rep, query head h reading KV head h / rep; scores scaled by
// dh^-0.5, masked (kj <= qi when causal, kj > qi - window when window > 0)
// at -1e30, an online softmax in f32, and the output acc / max(l, 1e-30) in
// q's dtype (f32 or bf16).  Unlike the TPU kernel it takes any S >= 1 (a
// ragged last tile is masked) and also computes the gradient, which the JAX
// package only gets by differentiating its XLA path.  Build:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu
//
// Bound: operations.  At the training shape (S = 4,096, dh = 64) a causal
// forward does about S / 2 multiply-adds per element it reads, far above
// the card's 295 flops a byte.  This first version runs the products in
// f32 on the CUDA cores from f32 tiles in shared memory (bf16 inputs are
// widened on load), as the TPU kernel casts q, k and v to f32 before both
// products: simple and exact to f32 rounding, several times slower than
// the tensor cores' bf16 rate (wgmma, TMA and warp specialisation are later
// work).  Every tile is 64 x 64; a block of 256 threads is a 16 x 16 grid,
// thread (ty, tx) owning rows ty + 16 i and columns tx + 16 j (i, j < 4) of
// a score tile.  Shared-memory rows are dh + 1 floats long (odd), so the 16
// column threads of a half-warp read 16 distinct banks and the two row
// groups of a warp read broadcast words.  The multiply-adds are explicit
// fmaf (the library builds with -fmad=false).
//
//   1. fa_fwd: one block per (query tile, sequence x query head), the
//      longest causal rows scheduled first.  It walks the key tiles that
//      hold a valid key (tiles wholly above the diagonal or wholly left of
//      the window are skipped, as pl.when(run) skips them), keeps the
//      running max m, sum l and the output rows in registers, and writes
//      out = acc / max(l, 1e-30) and the row log-sum-exp lse = m + log(l)
//      [B, H, S] f32 for the backward.
//   2. fa_delta: Delta = rowsum(dO * O) [B, H, S] f32, one warp per row.
//   3. fa_bwd_dkdv: one block per (key tile, sequence x KV head).  It loops
//      over the rep query heads of the group and the query tiles that see
//      the tile, recomputes P = exp(s - lse) and dP = dO V^T, forms
//      dS = P (dP - Delta), and sums dV += P^T dO, dK += dS^T Q in
//      registers.
//   4. fa_bwd_dq: one block per (query tile, sequence x query head); it
//      walks the same key tiles as the forward and sums dQ += dS K.
//
// Every output element has one writer and every sum runs in a fixed order:
// no atomics, so two runs give the same bits.

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
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* sm, const T* __restrict__ x,
                                          int b, int s0, int h, int S,
                                          int NH) {
  for (int e = threadIdx.x; e < FA_TILE * DH; e += blockDim.x) {
    const int r = e / DH, d = e % DH, s = s0 + r;
    sm[r * (DH + 1) + d] =
        s < S ? to_f(x[(((int64_t)b * S + s) * NH + h) * DH + d]) : 0.0f;
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

// ------------------------------------------------------------------ forward
template <typename T, int DH>
__global__ void __launch_bounds__(FA_THREADS)
    fa_fwd(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o,
           float* __restrict__ lse, int S, int H, int KV, int causal,
           int window, float scale) {
  constexpr int LD = DH + 1, NC = DH / 16;
  extern __shared__ float sm[];
  float* Qs = sm;
  float* Ks = Qs + FA_TILE * LD;
  float* Vs = Ks + FA_TILE * LD;
  float* Ps = Vs + FA_TILE * LD;   // [64][65] probabilities
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FA_TILE;
  const int b = blockIdx.y / H, h = blockIdx.y % H, g = h / (H / KV);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<T, DH>(Qs, q, b, q0, h, S, H);
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
    load_tile<T, DH>(Ks, k, b, k0, g, S, KV);
    load_tile<T, DH>(Vs, v, b, k0, g, S, KV);
    __syncthreads();
    float s[4][4];
    tile_dot<DH>(Qs, Ks, ty, tx, s);
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
      for (int c = 0; c < NC; ++c) vv[c] = Vs[kk * LD + tx + 16 * c];
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
    T* row = o + (((int64_t)b * S + qi) * H + h) * DH;
#pragma unroll
    for (int c = 0; c < NC; ++c) row[tx + 16 * c] = from_f<T>(acc[i][c] / L);
    if (tx == 0) lse[((int64_t)b * H + h) * S + qi] = m[i] + logf(l[i]);
  }
}

// ----------------------------------------------------------------- backward
template <typename T, int DH>
__global__ void fa_delta(const T* __restrict__ o, const T* __restrict__ dout,
                         float* __restrict__ delta, int S, int H,
                         int64_t rows) {
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x >> 5) +
                      (threadIdx.x >> 5);   // (b * S + s) * H + h
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  float acc = 0.0f;
  for (int d = lane; d < DH; d += 32)
    acc = fmaf(to_f(dout[row * DH + d]), to_f(o[row * DH + d]), acc);
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

template <typename T, int DH>
__global__ void __launch_bounds__(FA_THREADS)
    fa_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, int S, int H, int KV, int causal,
                int window, float scale) {
  constexpr int LD = DH + 1, NC = DH / 16;
  extern __shared__ float sm[];
  float* Ks = sm;
  float* Vs = Ks + FA_TILE * LD;
  float* Qs = Vs + FA_TILE * LD;
  float* dOs = Qs + FA_TILE * LD;
  float* Ps = dOs + FA_TILE * LD;   // [64 queries][65]
  float* dSs = Ps + FA_TILE * FA_PLD;
  float* lse_s = dSs + FA_TILE * FA_PLD;
  float* dl_s = lse_s + FA_TILE;
  const int k0 = blockIdx.x * FA_TILE;
  const int b = blockIdx.y / KV, g = blockIdx.y % KV, rep = H / KV;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<T, DH>(Ks, k, b, k0, g, S, KV);
  load_tile<T, DH>(Vs, v, b, k0, g, S, KV);
  float dk_acc[4][NC], dv_acc[4][NC];   // keys ty + 16 i, dims tx + 16 c
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.0f;
  int lo, hi;
  query_tiles(k0, S, causal, window, lo, hi);
  for (int r = 0; r < rep; ++r) {
    const int h = g * rep + r;
    const int64_t row_base = ((int64_t)b * H + h) * S;
    for (int qt = lo; qt <= hi; ++qt) {
      const int q0 = qt * FA_TILE;
      __syncthreads();
      load_tile<T, DH>(Qs, q, b, q0, h, S, H);
      load_tile<T, DH>(dOs, dout, b, q0, h, S, H);
      load_rows(lse_s, lse, row_base, q0, S);
      load_rows(dl_s, delta, row_base, q0, S);
      __syncthreads();
      float s[4][4], dp[4][4];
      tile_dot<DH>(Qs, Ks, ty, tx, s);
      tile_dot<DH>(dOs, Vs, ty, tx, dp);
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
        float p[4], ds[4], dov[NC], qv[NC];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = Ps[qq * FA_PLD + ty + 16 * i];
          ds[i] = dSs[qq * FA_PLD + ty + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dov[c] = dOs[qq * LD + tx + 16 * c];
          qv[c] = Qs[qq * LD + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            dv_acc[i][c] = fmaf(p[i], dov[c], dv_acc[i][c]);
            dk_acc[i][c] = fmaf(ds[i], qv[c], dk_acc[i][c]);
          }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= S) continue;
    const int64_t at = (((int64_t)b * S + kj) * KV + g) * DH;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[at + tx + 16 * c] = from_f<T>(dk_acc[i][c] * scale);
      dv[at + tx + 16 * c] = from_f<T>(dv_acc[i][c]);
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(FA_THREADS)
    fa_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int S, int H, int KV, int causal,
              int window, float scale) {
  constexpr int LD = DH + 1, NC = DH / 16;
  extern __shared__ float sm[];
  float* Qs = sm;
  float* dOs = Qs + FA_TILE * LD;
  float* Ks = dOs + FA_TILE * LD;
  float* Vs = Ks + FA_TILE * LD;
  float* dSs = Vs + FA_TILE * LD;   // [64 queries][65]
  float* lse_s = dSs + FA_TILE * FA_PLD;
  float* dl_s = lse_s + FA_TILE;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FA_TILE;
  const int b = blockIdx.y / H, h = blockIdx.y % H, g = h / (H / KV);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t row_base = ((int64_t)b * H + h) * S;

  load_tile<T, DH>(Qs, q, b, q0, h, S, H);
  load_tile<T, DH>(dOs, dout, b, q0, h, S, H);
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
    load_tile<T, DH>(Ks, k, b, k0, g, S, KV);
    load_tile<T, DH>(Vs, v, b, k0, g, S, KV);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<DH>(Qs, Ks, ty, tx, s);
    tile_dot<DH>(dOs, Vs, ty, tx, dp);
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
      for (int c = 0; c < NC; ++c) kv[c] = Ks[kk * LD + tx + 16 * c];
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
    T* row = dq + (((int64_t)b * S + qi) * H + h) * DH;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      row[tx + 16 * c] = from_f<T>(dq_acc[i][c] * scale);
  }
}

// ------------------------------------------------------------------ launch
template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

static size_t tiles_smem(int dh, int n_tiles, int n_ptiles, int n_rows) {
  return sizeof(float) * ((size_t)n_tiles * FA_TILE * (dh + 1) +
                          (size_t)n_ptiles * FA_TILE * FA_PLD +
                          (size_t)n_rows * FA_TILE);
}

template <typename T, int DH>
static int fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int S, int H, int KV, int causal,
               int window, float scale, cudaStream_t stream) {
  const size_t smem = tiles_smem(DH, 3, 1, 0);
  cudaError_t err = allow_smem(fa_fwd<T, DH>, smem);
  if (err != cudaSuccess) return (int)err;
  fa_fwd<T, DH><<<dim3((S + FA_TILE - 1) / FA_TILE, B * H), FA_THREADS, smem,
                  stream>>>((const T*)q, (const T*)k, (const T*)v, (T*)o, lse,
                            S, H, KV, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
static int bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int B, int S, int H, int KV, int causal,
               int window, float scale, cudaStream_t stream) {
  const int64_t rows = (int64_t)B * S * H;
  fa_delta<T, DH><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      (const T*)o, (const T*)dout, delta, S, H, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (S + FA_TILE - 1) / FA_TILE;
  const size_t smem_kv = tiles_smem(DH, 4, 2, 2);
  err = allow_smem(fa_bwd_dkdv<T, DH>, smem_kv);
  if (err != cudaSuccess) return (int)err;
  fa_bwd_dkdv<T, DH><<<dim3(n_tiles, B * KV), FA_THREADS, smem_kv, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, S, H, KV, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem_q = tiles_smem(DH, 4, 1, 2);
  err = allow_smem(fa_bwd_dq<T, DH>, smem_q);
  if (err != cudaSuccess) return (int)err;
  fa_bwd_dq<T, DH><<<dim3(n_tiles, B * H), FA_THREADS, smem_q, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, S, H, KV, causal, window, scale);
  return (int)cudaGetLastError();
}

static bool shape_ok(int B, int S, int H, int KV) {
  return B >= 1 && S >= 1 && KV >= 1 && H % KV == 0 && (int64_t)B * H <= 65535;
}

#define FA_DISPATCH(CALL)                                        \
  if (dtype == 0 && dh == 16) return CALL(float, 16);            \
  if (dtype == 0 && dh == 64) return CALL(float, 64);            \
  if (dtype == 0 && dh == 128) return CALL(float, 128);          \
  if (dtype == 1 && dh == 16) return CALL(__nv_bfloat16, 16);    \
  if (dtype == 1 && dh == 64) return CALL(__nv_bfloat16, 64);    \
  if (dtype == 1 && dh == 128) return CALL(__nv_bfloat16, 128);  \
  return (int)cudaErrorInvalidValue;

// dtype: 0 = f32, 1 = bf16; dh in {16, 64, 128}.  q/o [B, S, H, dh],
// k/v [B, S, KV, dh], lse [B, H, S] f32, all contiguous.
extern "C" int arms_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, void* o, float* lse,
                                        int B, int S, int H, int KV, int dh,
                                        int causal, int window, float scale,
                                        int dtype, cudaStream_t stream) {
  if (!shape_ok(B, S, H, KV)) return (int)cudaErrorInvalidValue;
#define FA_FWD(T, D) \
  fwd<T, D>(q, k, v, o, lse, B, S, H, KV, causal, window, scale, stream)
  FA_DISPATCH(FA_FWD)
#undef FA_FWD
}

// dout like o; delta [B, H, S] f32 scratch; dq like q, dk/dv like k.
extern "C" int arms_flash_attention_bwd(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const void* dout, const float* lse,
                                        float* delta, void* dq, void* dk,
                                        void* dv, int B, int S, int H, int KV,
                                        int dh, int causal, int window,
                                        float scale, int dtype,
                                        cudaStream_t stream) {
  if (!shape_ok(B, S, H, KV)) return (int)cudaErrorInvalidValue;
#define FA_BWD(T, D)                                                      \
  bwd<T, D>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, KV, causal, \
            window, scale, stream)
  FA_DISPATCH(FA_BWD)
#undef FA_BWD
}
