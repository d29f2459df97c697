// Mamba2 SSD chunked scan, forward and backward, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba_scan/kernel.py
// (mamba_scan_kernel), whose contract is ssd_chunked in
// src/repro/models/mamba2.py: x [B, S, H, P] (f32 or bf16), dt [B, S, H],
// A [H] < 0, Bm/Cm [B, S, N] (one group, shared by the H heads), all f32
// but x; S a multiple of the chunk Q.  Within chunk c of head h, with
// a_q = dt_q A and cs the inclusive cumsum of a over the chunk:
//
//   y[i]   = sum_{j<=i} exp(cs_i - cs_j) (C_i . B_j) dt_j x[j]
//          + exp(cs_i) C_i . h_c                    (h_c: state entering c)
//   h_c+1  = exp(cs_Q-1) h_c + sum_j exp(cs_Q-1 - cs_j) dt_j x[j] B_j^T
//
// y in x's dtype, the final state h_nc [B, H, P, N] f32.  The JAX package
// has no backward kernel (it differentiates ssd_chunked); here the
// backward is hand-written too.  Build:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libmamba_scan.so mamba_scan.cu
//
// Bound: operations.  At the training shape (B = 2, S = 4,096, H = 32,
// P = 64, N = 128, Q = 64) the forward does 9.7 GFLOP and the backward 28.1
// for 146 and 220 MB of inputs and outputs, far above the card's f32
// balance.  The products stay f32 on the CUDA cores: the gradient gates
// and the f32 card == CPU training checks hold them to f32 rounding, and a
// 3xTF32 mma.sync product (a = hi + lo, three products) measured only
// 1.16-1.17 times these tiles' rate on an H100 at 3.6 times their error
// (tools/redesign_probe.py).  Every product is register-tiled (tile_mm):
// a block's 256 threads each own a 4 x 4 tile of a 64 x 64 output frame
// and accumulate outer products in registers from float4 strips of shared
// memory, 16 fmaf for every two 16-byte loads.  The passes shared with the
// backward read each operand in the layout it arrives in (row-major from
// device memory); a tile's rows follow the operand's layout (4 consecutive
// rows when the strip runs along them, rows 16 apart when it runs along
// k), and shared rows are an odd number of 16-byte words long, so both
// kinds of strip load without bank conflicts.  ms_out stores its row
// operands transposed as it fills them, so its tiles take 4 consecutive
// rows and its triangle ends each tile's k range at the tile's last row.
// Every output is one fmaf chain in k order.  Shared memory fills in one
// of two ways.  staged (passes 1, 2 and 5) keeps 8 of a thread's
// device-memory loads in flight, consecutive threads on consecutive
// columns of a row, each load stored as one float: right for frames
// stored in the layout they are read in.  frame_fill (pass 4 only) gives
// a thread 4 consecutive rows of one column, so a frame stored transposed
// takes each thread's 4 values as one conflict-free 16-byte store, with 8
// loads in flight a round; staged's one-float stores into a transposed
// frame conflict 4 ways, and ms_out read slower with them (PERF.md §6).
// A new pass takes staged unless it stores transposed.

// The TPU kernel walks the chunks of one (b, h) in order with the state in
// VMEM; here blocks run in parallel, so the scan is cut into passes over
// device memory:
//
//   1. ms_cb: C . B^T of each (b, chunk), shared by the H heads (one block
//      per (chunk, b)).
//   2. ms_states: one block per (chunk, head, b).  The chunk's cumsum cs
//      (serial in f64, rounded once per element as PyTorch's CPU cumsum
//      rounds it, so the card's decays equal the CPU's: exp turns a
//      last-ulp difference of cs into a relative error of every decay;
//      written to scratch for the later passes) and its input
//      state sum_j w_j x[j] B_j^T, w_j = exp(cs_Q-1 - cs_j) dt_j; in the
//      backward also the gradient the chunk's off-diagonal output sends
//      to the state entering it, sum_i exp(cs_i) dy[i] C_i^T.  Two blocks
//      fit an SM (the two products in blocks of their own, three an SM,
//      measured 10 % slower); the serial cumsum reads dt from shared
//      memory.
//   3. ms_scan: a thread walks 4 state elements of one (b, h) over the
//      chunks, the next 8 chunks' loads in flight while it carries through
//      the current 8: forward, it replaces each chunk state by the state
//      entering the chunk and writes the final state; backward, it walks
//      the chunks in reverse and leaves the gradient of the state leaving
//      each chunk.  Bound by bytes: st and du read and written once.
//   4. ms_out: one block per (chunk, head, b): y from the decay-masked
//      C . B^T, x dt and the state entering the chunk, the forward's own
//      pass and the TPU kernel's output (the pallas body's y).  Bound by
//      operations (5.4 GFLOP at the training shape; st, 134 MB, read
//      once).  Both products run on the register tiles, the triangle's k
//      range ending at a tile's last row and the state term walking N in
//      64-column blocks, so three 64 x 68 frames (52 KiB) let four blocks
//      share an SM, and a frame fills in two memory latencies with
//      conflict-free transposed stores.  Each output is one fmaf chain over
//      j, then one over n, both ascending, the plain sums' order.
//   5. ms_bwd_chunk: one block per (chunk, head, b) forms the chunk's dx,
//      ddt and its head's share of dBm, dCm and dA.  It holds P, Q <= 64
//      (one frame) and walks N in 64-column blocks, so its shared memory
//      is six 64 x 68 frames, 104 KiB, and two blocks fit an SM (213 KiB
//      with whole matrices would allow one): x, dy^T, dCB^T and dxdt live
//      the whole block; two frames hold M = L o CB, then B and dH, then h
//      and C of each column block.  The chunk-level sums (rows and columns
//      of dM o M, x . dxdt, x . U, C . dC, <dH, h>) are fixed-order trees
//      over a tile's 4 entries and a half-warp's 16 tiles, and the tail
//      (dcs through w and g, the reverse cumsum over Q, ddt and the head's
//      dA share) is one warp's scan, not a thread's serial walk.
//      One block per (b, chunk) that walks the heads would keep B, C and
//      C . B^T in shared memory and drop the per-head dBm/dCm shares, but
//      it runs 128 blocks, one a SM with no second block to hide its
//      loads; the shares cost 268 MB of the backward's traffic
//      (0.08 ms at the HBM rate), which this design keeps.
//   6. ms_reduce_bc, ms_reduce_a: dBm, dCm summed over the heads, dA over
//      batch and chunks, in a fixed order.
//
// The backward recomputes the states entering the chunks (passes 1-3)
// rather than saving them from the forward: saving costs B H S/Q P N 4
// bytes a layer (134 MB at the training shape, 6.4 GB over 48 layers).
// Its scratch (states, their gradients, per-head dBm/dCm) is about 540 MB
// at the training shape and lives for one call.  The decay is selected,
// never multiplied by a 0/1 mask: exp(cs_i - cs_j) for i < j may be inf.
// Every output element has one writer and every sum runs in a fixed
// order: no atomics, so two runs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#define MS_THREADS 256
#define FR 64            // a register-tiled output frame is FR x FR
#define FLD (FR + 4)     // shared row of a frame: 17 16-byte words

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

__host__ __device__ __forceinline__ int frames(int n) {
  return (n + FR - 1) / FR;
}
__host__ __device__ __forceinline__ int up4(int n) { return (n + 3) & ~3; }
// A shared row holding whole frames: an odd number of 16-byte words.
__host__ __device__ __forceinline__ int frame_ld(int n) {
  return frames(n) * FR + 4;
}
// A shared row read only along k: an odd number of 16-byte words >= n.
__host__ __device__ __forceinline__ int k_ld(int n) {
  return (n + 7) / 8 * 8 + 4;
}

// ------------------------------------------------------ register tiles
// acc[r][c] += sum_{k0 <= k < k1} A(m_r, k) B(k, n_c), one fmaf chain in
// k order, for the 4 x 4 tile (mt, nt) of a 64 x 64 frame (thread t of
// 256 owns mt = t / 16, nt = t % 16).  A(m, k) is A[k lda + m] when AK
// (rows m_r = 4 mt + r), else A[m lda + k] (rows m_r = mt + 16 r);
// B(k, n) is B[k ldb + n] when BK (columns n_c = 4 nt + c), else
// B[n ldb + k] (columns n_c = nt + 16 c).  k0, k1, lda, ldb are multiples
// of 4 and the operands 16-byte aligned; entries past the true k range
// must be zero in both operands.
template <bool AK, bool BK>
__device__ __forceinline__ void tile_mm(float (&acc)[4][4],
                                        const float* __restrict__ A, int lda,
                                        const float* __restrict__ B, int ldb,
                                        int mt, int nt, int k0, int k1) {
  for (int k = k0; k < k1; k += 4) {
    float a[4][4], b[4][4];   // a[kk][r], b[kk][c]
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 u = AK ? *reinterpret_cast<const float4*>(
                                A + (k + q) * lda + 4 * mt)
                          : *reinterpret_cast<const float4*>(
                                A + (mt + 16 * q) * lda + k);
      const float4 v = BK ? *reinterpret_cast<const float4*>(
                                B + (k + q) * ldb + 4 * nt)
                          : *reinterpret_cast<const float4*>(
                                B + (nt + 16 * q) * ldb + k);
      if (AK) {
        a[q][0] = u.x; a[q][1] = u.y; a[q][2] = u.z; a[q][3] = u.w;
      } else {
        a[0][q] = u.x; a[1][q] = u.y; a[2][q] = u.z; a[3][q] = u.w;
      }
      if (BK) {
        b[q][0] = v.x; b[q][1] = v.y; b[q][2] = v.z; b[q][3] = v.w;
      } else {
        b[0][q] = v.x; b[1][q] = v.y; b[2][q] = v.z; b[3][q] = v.w;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[r][c] = fmaf(a[kk][r], b[kk][c], acc[r][c]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
}

// Sum over the 16 lanes of a half-warp (the 16 tiles nt of one mt), a
// fixed tree; lane nt = 0 holds the sum.
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Four consecutive columns n0..n0+3 of a row of length N: one 16-byte
// store (8 bytes in bf16) where they are all inside and N keeps them
// aligned.
__device__ __forceinline__ void store4(float* row, int n0, int N,
                                       const float (&v)[4]) {
  if (n0 + 3 < N && (N & 3) == 0) {
    *reinterpret_cast<float4*>(row + n0) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (n0 + c < N) row[n0 + c] = v[c];
  }
}

__device__ __forceinline__ void store4(__nv_bfloat16* row, int n0, int N,
                                       const float (&v)[4]) {
  if (n0 + 3 < N && (N & 3) == 0) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(row + n0) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                   *reinterpret_cast<const uint32_t*>(&hi));
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (n0 + c < N) row[n0 + c] = __float2bfloat16(v[c]);
  }
}

// put(q, c, get(q, c)) over a rows x cols grid, element e = threadIdx.x +
// i blockDim.x at (e / cols, e % cols) (stepped without a division), with
// STAGE of a thread's get()s (device-memory loads) in flight before their
// put()s: a block's fill costs a few memory latencies, not one an element.
#define STAGE 8
template <typename Get, typename Put>
__device__ __forceinline__ void staged(int rows, int cols, Get get, Put put) {
  const int dq = blockDim.x / cols, dc = blockDim.x % cols;
  int q = threadIdx.x / cols, c = threadIdx.x % cols;
  while (q < rows) {
    float v[STAGE];
    int qs[STAGE], cs[STAGE];
#pragma unroll
    for (int u = 0; u < STAGE; ++u) {
      qs[u] = q;
      cs[u] = c;
      v[u] = q < rows ? get(q, c) : 0.f;
      q += dq;
      c += dc;
      if (c >= cols) {
        c -= cols;
        ++q;
      }
    }
#pragma unroll
    for (int u = 0; u < STAGE; ++u)
      if (qs[u] < rows) put(qs[u], cs[u], v[u]);
  }
}

// ------------------------------------------------------------ 1. C . B^T
// cb [B, nc, Q, Q]: cb[i][j] = C_i . B_j for j <= i, 0 above the diagonal;
// 64 x 64 frames over (i, j), rows of C and B read along n.
__global__ void __launch_bounds__(MS_THREADS)
    ms_cb(const float* __restrict__ Bm, const float* __restrict__ Cm,
          float* __restrict__ cb, int S, int N, int Q) {
  extern __shared__ float sm[];
  const int c = blockIdx.x, b = blockIdx.y, nc = gridDim.x;
  const int ld = k_ld(N), rows = frames(Q) * FR;
  const int mt = threadIdx.x >> 4, nt = threadIdx.x & 15;
  float* sC = sm;              // [rows][ld]
  float* sB = sC + rows * ld;  // [rows][ld]
  const size_t row0 = (size_t)b * S + (size_t)c * Q;
  for (int t = 0; t < 2; ++t) {
    const float* src = t ? Bm : Cm;
    float* dst = t ? sB : sC;
    staged(rows, ld, [&](int q, int n) {
      return q < Q && n < N ? src[(row0 + q) * N + n] : 0.f;
    }, [&](int q, int n, float v) { dst[q * ld + n] = v; });
  }
  __syncthreads();
  float* out = cb + ((size_t)b * nc + c) * Q * Q;
  for (int fi = 0; fi < rows; fi += FR)
    for (int fj = 0; fj < rows; fj += FR) {
      float acc[4][4];
      zero(acc);
      if (fj <= fi)
        tile_mm<false, false>(acc, sC + fi * ld, ld, sB + fj * ld, ld, mt,
                              nt, 0, up4(N));
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = fi + mt + 16 * r, j = fj + nt + 16 * q;
          if (i < Q && j < Q) out[i * Q + j] = j <= i ? acc[r][q] : 0.f;
        }
    }
}

// ------------------------------------------------------ 2. chunk states
// cs [B, H, S]; st and du [B, H, nc, P, N].  With dy == nullptr only the
// forward's part runs.  64 x 64 frames over (p, n); k runs over the chunk.
template <typename T>
__global__ void __launch_bounds__(MS_THREADS, 2)
    ms_states(const T* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const float* __restrict__ Bm,
              const T* __restrict__ dy, const float* __restrict__ Cm,
              float* __restrict__ cs, float* __restrict__ st,
              float* __restrict__ du, int S, int H, int P, int N, int Q) {
  extern __shared__ float sm[];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int Qk = up4(Q), ldp = frame_ld(P), ldn = frame_ld(N);
  const int mt = threadIdx.x >> 4, nt = threadIdx.x & 15;
  float* scs = sm;               // [Qk]
  float* sw = scs + Qk;          // [Qk] exp(cs_Q-1 - cs_j) dt_j
  float* se = sw + Qk;           // [Qk] exp(cs_i)
  float* sxw = se + Qk;          // [Qk][ldp] w_j x[j]
  float* sB = sxw + Qk * ldp;    // [Qk][ldn]
  float* sdy = sB + Qk * ldn;    // [Qk][ldp] exp(cs_i) dy[i]   (backward)
  float* sC = sdy + Qk * ldp;    // [Qk][ldn]                   (backward)
  const size_t row0 = (size_t)b * S + (size_t)c * Q;
  // dt (into sw) and B, C; then the cumsum, then x w and dy e
  for (int q = threadIdx.x; q < Q; q += blockDim.x)
    sw[q] = dt[(row0 + q) * H + h];
  for (int t = 0; t < (dy ? 2 : 1); ++t) {
    const float* src = t ? Cm : Bm;
    float* dst = t ? sC : sB;
    staged(Qk, ldn, [&](int q, int n) {
      return q < Q && n < N ? src[(row0 + q) * N + n] : 0.f;
    }, [&](int q, int n, float v) { dst[q * ldn + n] = v; });
  }
  __syncthreads();
  if (threadIdx.x == 0) {   // summed in f64, as PyTorch's CPU cumsum does
    const float a = A[h];
    double run = 0.0;
    for (int q = 0; q < Q; ++q) {
      run += (double)(sw[q] * a);
      scs[q] = (float)run;
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < Qk; q += blockDim.x) {
    const bool in = q < Q;
    sw[q] = in ? expf(scs[Q - 1] - scs[q]) * sw[q] : 0.f;
    se[q] = in ? expf(scs[q]) : 0.f;
    if (in) cs[((size_t)b * H + h) * S + (size_t)c * Q + q] = scs[q];
  }
  __syncthreads();
  for (int t = 0; t < (dy ? 2 : 1); ++t) {
    const T* src = t ? dy : x;
    const float* scale = t ? se : sw;
    float* dst = t ? sdy : sxw;
    staged(Qk, ldp, [&](int q, int p) {
      return q < Q && p < P ? to_f(src[((row0 + q) * H + h) * P + p]) : 0.f;
    }, [&](int q, int p, float v) { dst[q * ldp + p] = v * scale[q]; });
  }
  __syncthreads();
  const size_t out0 = (((size_t)b * H + h) * nc + c) * P * N;
  for (int fp = 0; fp < P; fp += FR)
    for (int fn = 0; fn < N; fn += FR) {
      float acc[4][4];
      zero(acc);
      tile_mm<true, true>(acc, sxw + fp, ldp, sB + fn, ldn, mt, nt, 0, Qk);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = fp + 4 * mt + r;
        if (p < P) store4(st + out0 + (size_t)p * N, fn + 4 * nt, N, acc[r]);
      }
      if (!dy) continue;
      zero(acc);
      tile_mm<true, true>(acc, sdy + fp, ldp, sC + fn, ldn, mt, nt, 0, Qk);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = fp + 4 * mt + r;
        if (p < P) store4(du + out0 + (size_t)p * N, fn + 4 * nt, N, acc[r]);
      }
    }
}

// ---------------------------------------------------- 3. chunk recurrence
// Forward (st): st[c] <- the state entering chunk c; hfin <- the last
// state.  Backward (du): du[c] <- the gradient of the state leaving chunk
// c, from dh_final (zero when null).  A thread takes V consecutive
// elements (V = 4 where P N keeps them 16-byte aligned) and holds two
// batches of SCAN_AHEAD chunks: the next batch's loads are in flight while
// it carries through the current one (they do not depend on the carry),
// so the walk streams.
#define SCAN_AHEAD 8

template <int V> struct Vec { float v[V]; };

template <int V>
__device__ __forceinline__ Vec<V> vload(const float* p) {
  Vec<V> r;
  if (V == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    r.v[0] = u.x; r.v[1] = u.y; r.v[2] = u.z; r.v[3] = u.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) r.v[i] = p[i];
  }
  return r;
}

template <int V>
__device__ __forceinline__ void vstore(float* p, const Vec<V>& r) {
  if (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2],
                                                r.v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = r.v[i];
  }
}

template <int V>
__global__ void __launch_bounds__(MS_THREADS)
    ms_scan(const float* __restrict__ cs, float* __restrict__ st,
            float* __restrict__ hfin, float* __restrict__ du,
            const float* __restrict__ dhfin, int S, int H, int PN, int Q,
            int nc) {
  const int e = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (e >= PN) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const float* csr = cs + bh * S;
  const size_t base = bh * nc * PN + e;
  if (st) {
    Vec<V> s, cur[SCAN_AHEAD], nxt[SCAN_AHEAD];
#pragma unroll
    for (int i = 0; i < V; ++i) s.v[i] = 0.f;
#pragma unroll
    for (int u = 0; u < SCAN_AHEAD; ++u)
      if (u < nc) cur[u] = vload<V>(st + base + (size_t)u * PN);
    for (int c0 = 0; c0 < nc; c0 += SCAN_AHEAD) {
#pragma unroll
      for (int u = 0; u < SCAN_AHEAD; ++u)
        if (c0 + SCAN_AHEAD + u < nc)
          nxt[u] = vload<V>(st + base + (size_t)(c0 + SCAN_AHEAD + u) * PN);
#pragma unroll
      for (int u = 0; u < SCAN_AHEAD; ++u) {
        const int c = c0 + u;
        if (c < nc) {
          const float g = expf(csr[c * Q + Q - 1]);
          vstore<V>(st + base + (size_t)c * PN, s);
#pragma unroll
          for (int i = 0; i < V; ++i) s.v[i] = s.v[i] * g + cur[u].v[i];
        }
        cur[u] = nxt[u];
      }
    }
    if (hfin) vstore<V>(hfin + bh * PN + e, s);
  }
  if (du) {
    Vec<V> d, cur[SCAN_AHEAD], nxt[SCAN_AHEAD];
    if (dhfin) {
      d = vload<V>(dhfin + bh * PN + e);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) d.v[i] = 0.f;
    }
#pragma unroll
    for (int u = 0; u < SCAN_AHEAD; ++u)
      if (nc - 1 - u >= 0) cur[u] = vload<V>(du + base + (size_t)(nc - 1 - u) * PN);
    for (int c0 = nc - 1; c0 >= 0; c0 -= SCAN_AHEAD) {
#pragma unroll
      for (int u = 0; u < SCAN_AHEAD; ++u)
        if (c0 - SCAN_AHEAD - u >= 0)
          nxt[u] = vload<V>(du + base + (size_t)(c0 - SCAN_AHEAD - u) * PN);
#pragma unroll
      for (int u = 0; u < SCAN_AHEAD; ++u) {
        const int c = c0 - u;
        if (c >= 0) {
          const float g = expf(csr[c * Q + Q - 1]);
          vstore<V>(du + base + (size_t)c * PN, d);
#pragma unroll
          for (int i = 0; i < V; ++i) d.v[i] = d.v[i] * g + cur[u].v[i];
        }
        cur[u] = nxt[u];
      }
    }
  }
}

// ------------------------------------------------------------ 4. outputs
// put(q, c, v) with v[r] = get(q + r, c), r < 4, over a 64 x 64 frame of
// a 256-thread block: thread t takes column c = t % 64 (a warp reads 32
// consecutive columns of a row) and rows 4 (t / 64) + 16 u + r, u < 4, in
// two rounds of OUT_INFLIGHT groups u, each round's 8 loads in flight
// before its puts (16 at once spilled beside the accumulator).  A put of
// 4 consecutive rows of one column into a transposed frame is one 16-byte
// store, without bank conflicts.
#define OUT_INFLIGHT 2
template <typename Get, typename Put>
__device__ __forceinline__ void frame_fill(Get get, Put put) {
  const int c = threadIdx.x & (FR - 1), q0 = (threadIdx.x >> 6) * 4;
#pragma unroll 1   // a round's loads are not hoisted above the last puts
  for (int u0 = 0; u0 < 4; u0 += OUT_INFLIGHT) {
    float v[OUT_INFLIGHT][4];
#pragma unroll
    for (int u = 0; u < OUT_INFLIGHT; ++u)
#pragma unroll
      for (int r = 0; r < 4; ++r) v[u][r] = get(q0 + 16 * (u0 + u) + r, c);
#pragma unroll
    for (int u = 0; u < OUT_INFLIGHT; ++u) put(q0 + 16 * (u0 + u), c, v[u]);
  }
}

// f[c][q..q+3] = v: 4 rows q.. of column c into a transposed frame.
__device__ __forceinline__ void put_t(float* f, int q, int c,
                                      const float (&v)[4]) {
  *reinterpret_cast<float4*>(f + c * FLD + q) =
      make_float4(v[0], v[1], v[2], v[3]);
}

// One block per (chunk, head, b), over 64 x 64 frames (i, p) of y: the
// triangle sum_{j <= i} M[i][j] (x dt)[j][p] from frames of M^T (M = L o
// CB, formed while filling, the decay selected) and x dt, k over j up to
// the tile's last row (M is zero past the diagonal, so the chain is
// unchanged); then the state term sum_n C[i][n] h_c[p][n] from frames of
// C^T and h_c^T over 64-column blocks of N, the accumulator carried from
// block to block, so each is one fmaf chain in the parent's order; the
// triangle waits in M's frame meanwhile, and C^T takes the frame of x dt.
// y = triangle + exp(cs_i) state term.  Three 64 x FLD frames and the
// chunk's cs and dt, 52 KiB, and at most 64 registers: four blocks an SM
// (three read 17 % slower on an H100).
#define OUT_FRAMES 3
#define OUT_BLOCKS 4

template <typename T>
__global__ void __launch_bounds__(MS_THREADS, OUT_BLOCKS)
    ms_out(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ Cm, const float* __restrict__ cs,
           const float* __restrict__ cb, const float* __restrict__ st,
           T* __restrict__ y, int S, int H, int P, int N, int Q) {
  extern __shared__ float sm[];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int mt = threadIdx.x >> 4, nt = threadIdx.x & 15;
  float* sM = sm;                // [64][FLD] M^T [j][i]; then the triangle
  float* sX = sM + FR * FLD;     // [64][FLD] (x dt) [j][p]; then C^T [n][i]
  float* sH = sX + FR * FLD;     // [64][FLD] h_c^T [n][p]
  float* scs = sH + FR * FLD;    // [Qk] cs
  float* sdt = scs + up4(Q);     // [Qk] dt
  const size_t row0 = (size_t)b * S + (size_t)c * Q;
  const size_t bh = (size_t)b * H + h;
  for (int q = threadIdx.x; q < Q; q += blockDim.x) {
    scs[q] = cs[bh * S + (size_t)c * Q + q];
    sdt[q] = dt[(row0 + q) * H + h];
  }
  const float* cbc = cb + ((size_t)b * nc + c) * Q * Q;
  const float* hc = st + (bh * nc + c) * (size_t)P * N;
  for (int fi = 0; fi < Q; fi += FR)
    for (int fp = 0; fp < P; fp += FR) {
      float acc[4][4];
      zero(acc);
      for (int fj = 0; fj <= fi; fj += FR) {
        __syncthreads();   // the frames' last readers are done
        auto in = [&](int i, int j) { return fi + i < Q && fj + j <= fi + i; };
        const float* cbr = cbc + (size_t)fi * Q + fj;
        frame_fill([&](int i, int j) {
          return in(i, j) ? cbr[i * Q + j] : 0.f;
        }, [&](int i, int j, const float (&v)[4]) {
          float m[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            m[r] = in(i + r, j)
                       ? expf(scs[fi + i + r] - scs[fj + j]) * v[r] : 0.f;
          put_t(sM, i, j, m);
        });
        const T* xr = x + ((row0 + fj) * H + h) * P + fp;
        frame_fill([&](int j, int p) {
          return fj + j < Q && fp + p < P
                     ? to_f(xr[(size_t)j * H * P + p]) * sdt[fj + j] : 0.f;
        }, [&](int j, int p, const float (&v)[4]) {
#pragma unroll
          for (int r = 0; r < 4; ++r) sX[(j + r) * FLD + p] = v[r];
        });
        __syncthreads();
        tile_mm<true, true>(acc, sM, FLD, sX, FLD, mt, nt, 0,
                            fj < fi ? FR : 4 * mt + 4);
      }
      for (int n0 = 0; n0 < N; n0 += FR) {
        __syncthreads();
        if (n0 == 0) {   // every thread is past the triangle's product
#pragma unroll
          for (int r = 0; r < 4; ++r)
            *reinterpret_cast<float4*>(sM + (4 * mt + r) * FLD + 4 * nt) =
                make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
          zero(acc);
        }
        const float* cr = Cm + (row0 + fi) * N + n0;
        frame_fill([&](int i, int n) {
          return fi + i < Q && n0 + n < N ? cr[i * N + n] : 0.f;
        }, [&](int i, int n, const float (&v)[4]) { put_t(sX, i, n, v); });
        const float* hr = hc + (size_t)fp * N + n0;
        frame_fill([&](int p, int n) {
          return fp + p < P && n0 + n < N ? hr[p * N + n] : 0.f;
        }, [&](int p, int n, const float (&v)[4]) { put_t(sH, p, n, v); });
        __syncthreads();
        tile_mm<true, true>(acc, sX, FLD, sH, FLD, mt, nt, 0,
                            min(FR, up4(N - n0)));
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = fi + 4 * mt + r;
        if (i >= Q) continue;
        const float e = expf(scs[i]);
        const float4 d =
            *reinterpret_cast<const float4*>(sM + (4 * mt + r) * FLD + 4 * nt);
        const float v[4] = {d.x + e * acc[r][0], d.y + e * acc[r][1],
                            d.z + e * acc[r][2], d.w + e * acc[r][3]};
        store4(y + ((row0 + i) * H + h) * P + fp, 4 * nt, P - fp, v);
      }
    }
}

// ----------------------------------------------------- 5. chunk gradients
// One block per (chunk, head, b), P, Q <= 64, given dy, the state h_c
// entering the chunk (st) and the gradient dH of the state leaving it (du):
//   dxdt = M^T dy,  dM = (dy (x dt)^T) on j <= i,  dCB = dM L,
//   dcs  += rowsum(dM M) - colsum(dM M)                       (y_diag)
//   dC   = exp(cs_i) dy h_c + dCB B,  dcs_i += C_i . that first term
//   dB   = dCB^T C + w_j x[j] dH,  U = B dH^T,  dx = dt dxdt + w U
//   dw_j = x[j] . U[j],  dg = <dH, h_c>,  g = exp(cs_Q-1)
// then dcs through w and g, the reverse cumsum da, ddt = x . dxdt +
// exp(cs_Q-1 - cs_j) dw_j + A da_j and the head's dA share sum_j dt_j da_j.
// dBm/dCm shares go to dbp/dcp [B, H, S, N], dA shares to dap [B, H, nc].
// Shared memory: 8 vectors of 64 and six 64 x FLD frames; entries past
// Q, P or N are zero, so every product runs over the whole frame.
#define BWD_SMEM_FLOATS (8 * FR + 6 * FR * FLD)

template <typename T>
__global__ void __launch_bounds__(MS_THREADS, 2)
    ms_bwd_chunk(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, const T* __restrict__ dy,
                 const float* __restrict__ cs, const float* __restrict__ cb,
                 const float* __restrict__ st, const float* __restrict__ du,
                 T* __restrict__ dx, float* __restrict__ ddt,
                 float* __restrict__ dbp, float* __restrict__ dcp,
                 float* __restrict__ dap, int S, int H, int P, int N,
                 int Q) {
  extern __shared__ float sm[];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mt = tid >> 4, nt = tid & 15;
  const int Qk = up4(Q), Pk = up4(P);
  float* scs = sm;              // [64] cs
  float* sdt = scs + FR;        // [64] dt
  float* sw = sdt + FR;         // [64] w_j = exp(cs_Q-1 - cs_j) dt_j
  float* se = sw + FR;          // [64] exp(cs_i)
  float* sdcs = se + FR;        // [64] dcs
  float* sxd = sdcs + FR;       // [64] x[j] . dxdt[j]
  float* sdw = sxd + FR;        // [64] dw_j
  float* sred = sdw + FR;       // [64] warp partials of dg
  float* sX = sred + FR;        // [64][FLD] x[j][p]
  float* sYT = sX + FR * FLD;   // [64][FLD] dy^T [p][i]
  float* sGT = sYT + FR * FLD;  // [64][FLD] dCB^T [j][i]
  float* sD = sGT + FR * FLD;   // [64][FLD] dxdt [j][p]
  float* sR0 = sD + FR * FLD;   // [64][FLD] M [i][j]; B [j][n]; h [p][n]
  float* sR1 = sR0 + FR * FLD;  // [64][FLD] column partials; dH [p][n]; C
  const size_t row0 = (size_t)b * S + (size_t)c * Q;
  const size_t bh = (size_t)b * H + h;
  const size_t PN = (size_t)P * N;
  const float* hc = st + (bh * nc + c) * PN;
  const float* dhc = du + (bh * nc + c) * PN;

  if (tid < FR) {
    const bool in = tid < Q;
    scs[tid] = in ? cs[bh * S + (size_t)c * Q + tid] : 0.f;
    sdt[tid] = in ? dt[(row0 + tid) * H + h] : 0.f;
  }
  auto xi = [&](int q, int p) { return ((row0 + q) * H + h) * P + p; };
  staged(FR, FR, [&](int q, int p) {
    return q < Q && p < P ? to_f(x[xi(q, p)]) : 0.f;
  }, [&](int q, int p, float v) { sX[q * FLD + p] = v; });
  staged(FR, FR, [&](int q, int p) {
    return q < Q && p < P ? to_f(dy[xi(q, p)]) : 0.f;
  }, [&](int q, int p, float v) { sYT[p * FLD + q] = v; });
  __syncthreads();
  if (tid < FR) {
    const bool in = tid < Q;
    sw[tid] = in ? expf(scs[Q - 1] - scs[tid]) * sdt[tid] : 0.f;
    se[tid] = in ? expf(scs[tid]) : 0.f;
  }
  const float* cbc = cb + ((size_t)b * nc + c) * Q * Q;
  staged(FR, FR, [&](int i, int j) {
    return (j <= i && i < Q) ? cbc[i * Q + j] : 0.f;
  }, [&](int i, int j, float v) {
    sR0[i * FLD + j] = (j <= i && i < Q) ? expf(scs[i] - scs[j]) * v : 0.f;
  });
  __syncthreads();

  // dxdt[j][p] = sum_{i >= j} M[i][j] dy[i][p]: rows j = 4 mt + r, columns
  // p = nt + 16 c; kept in sD, and x . dxdt per row
  {
    float acc[4][4];
    zero(acc);
    tile_mm<true, false>(acc, sR0, FLD, sYT, FLD, mt, nt, 4 * mt, Qk);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = 4 * mt + r;
      float xs = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = nt + 16 * q;
        sD[j * FLD + p] = acc[r][q];
        xs += sX[j * FLD + p] * acc[r][q];
      }
      xs = half_warp_sum(xs);
      if (nt == 0) sxd[j] = xs;
    }
  }
  // dM[i][j] = dt_j sum_p dy[i][p] x[j][p] on j <= i: rows i = 4 mt + r,
  // columns j = nt + 16 c.  dCB = dM L goes to sGT transposed; dM o M is
  // summed by rows (half-warp) and by columns (partials over mt in sR1).
  {
    float acc[4][4], col[4] = {0.f, 0.f, 0.f, 0.f};
    zero(acc);
    tile_mm<true, false>(acc, sYT, FLD, sX, FLD, mt, nt, 0, Pk);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * mt + r;
      float row = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = nt + 16 * q;
        float dcb = 0.f, dl = 0.f;
        if (j <= i && i < Q) {
          const float dm = acc[r][q] * sdt[j];
          dcb = dm * expf(scs[i] - scs[j]);
          dl = dm * sR0[i * FLD + j];
        }
        sGT[j * FLD + i] = dcb;
        row += dl;
        col[q] += dl;
      }
      row = half_warp_sum(row);
      if (nt == 0) sdcs[i] = row;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) sR1[mt * FR + nt + 16 * q] = col[q];
  }
  __syncthreads();
  if (tid < FR) {
    float s = 0.f;
    for (int m = 0; m < 16; ++m) s += sR1[m * FR + tid];
    sdcs[tid] -= s;
  }
  __syncthreads();

  // Column blocks [n0, n0 + 64) of N.  U[j][p] = sum_n B[j][n] dH[p][n]
  // accumulates over the blocks in acc_u: rows j = mt + 16 r, columns
  // p = nt + 16 c.
  float acc_u[4][4];
  zero(acc_u);
  float dgp = 0.f;
  for (int n0 = 0; n0 < N; n0 += FR) {
    const int Nk = min(FR, up4(N - n0));
    auto put0 = [&](int r, int n, float v) { sR0[r * FLD + n] = v; };
    auto put1 = [&](int r, int n, float v) { sR1[r * FLD + n] = v; };
    auto at = [&](int r, int n) { return (size_t)r * N + n0 + n; };
    staged(FR, FR, [&](int r, int n) {
      return r < Q && n0 + n < N ? Bm[row0 * N + at(r, n)] : 0.f; }, put0);
    staged(FR, FR, [&](int r, int n) {
      return r < P && n0 + n < N ? dhc[at(r, n)] : 0.f; }, put1);
    __syncthreads();
    // dC's diagonal term sum_{j <= i} dCB[i][j] B[j][n] (rows i = 4 mt + r,
    // columns n = 4 nt + c) and dB's state term sum_p x[j][p] dH[p][n]
    // (rows j = mt + 16 r), both held to the next half; U; <dH, h>
    float acc_c[4][4], acc_b[4][4];
    zero(acc_c);
    zero(acc_b);
    tile_mm<true, true>(acc_c, sGT, FLD, sR0, FLD, mt, nt, 0,
                        min(4 * mt + 4, Qk));
    tile_mm<false, true>(acc_b, sX, FLD, sR1, FLD, mt, nt, 0, Pk);
    tile_mm<false, false>(acc_u, sR0, FLD, sR1, FLD, mt, nt, 0, Nk);
    auto h_at = [&](int p, int n) {
      return p < P && n0 + n < N ? hc[at(p, n)] : 0.f; };
    staged(FR, FR, h_at, [&](int p, int n, float v) {
      dgp = fmaf(sR1[p * FLD + n], v, dgp); });
    __syncthreads();
    staged(FR, FR, h_at, put0);
    staged(FR, FR, [&](int r, int n) {
      return r < Q && n0 + n < N ? Cm[row0 * N + at(r, n)] : 0.f; }, put1);
    __syncthreads();
    // dC = exp(cs_i) dy h + the diagonal term; dcs_i += C_i . exp(cs_i) dy h
    {
      float acc[4][4];
      zero(acc);
      tile_mm<true, true>(acc, sYT, FLD, sR0, FLD, mt, nt, 0, Pk);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * mt + r;
        float dot = 0.f, v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float off = se[i] * acc[r][q];
          dot = fmaf(sR1[i * FLD + 4 * nt + q], off, dot);
          v[q] = off + acc_c[r][q];
        }
        dot = half_warp_sum(dot);
        if (nt == 0) sdcs[i] += dot;
        if (i < Q)
          store4(dcp + (bh * S + (size_t)c * Q + i) * N, n0 + 4 * nt, N, v);
      }
    }
    // dB = sum_{i >= j} dCB[i][j] C[i][n] + w_j (x dH)[j][n]
    {
      float acc[4][4];
      zero(acc);
      tile_mm<false, true>(acc, sGT, FLD, sR1, FLD, mt, nt, 0, Qk);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = mt + 16 * r;
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = acc[r][q] + sw[j] * acc_b[r][q];
        if (j < Q)
          store4(dbp + (bh * S + (size_t)c * Q + j) * N, n0 + 4 * nt, N, v);
      }
    }
    __syncthreads();
  }

  // dx = dt dxdt + w U; dw_j = x[j] . U[j]
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = mt + 16 * r;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = nt + 16 * q;
      const float u = acc_u[r][q];
      if (j < Q && p < P)
        dx[((row0 + j) * H + h) * P + p] =
            from_f<T>(sdt[j] * sD[j * FLD + p] + sw[j] * u);
      s += sX[j * FLD + p] * u;
    }
    s = half_warp_sum(s);
    if (nt == 0) sdw[j] = s;
  }
  dgp = warp_sum(dgp);
  if (lane == 0) sred[warp] = dgp;
  __syncthreads();
  if (warp != 0) return;
  // One warp: dcs through w and g, the reverse cumsum da_q = sum_{m >= q}
  // dcs_m (lane l holds q = Q-1-2l and Q-2-2l), ddt and the dA share.
  float dg = 0.f;
  for (int w = 0; w < MS_THREADS / 32; ++w) dg += sred[w];
  const float cl = scs[Q - 1];
  float vs = 0.f;
  for (int q = lane; q < Q; q += 32) {
    const float v = sdw[q] * sw[q];
    sdcs[q] -= v;
    vs += v;
  }
  vs = warp_sum(vs);
  __syncwarp();
  if (lane == 0) sdcs[Q - 1] += dg * expf(cl) + vs;
  __syncwarp();
  const int qa = Q - 1 - 2 * lane, qb = qa - 1;
  const float xa = qa >= 0 ? sdcs[qa] : 0.f, xb = qb >= 0 ? sdcs[qb] : 0.f;
  float inc = xa + xb;
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += t;
  }
  float exc = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) exc = 0.f;
  const float da_a = exc + xa, da_b = da_a + xb;
  const float a = A[h];
  float dsum = 0.f;
  if (qa >= 0) {
    ddt[(row0 + qa) * H + h] =
        sxd[qa] + expf(cl - scs[qa]) * sdw[qa] + a * da_a;
    dsum = sdt[qa] * da_a;
  }
  if (qb >= 0) {
    ddt[(row0 + qb) * H + h] =
        sxd[qb] + expf(cl - scs[qb]) * sdw[qb] + a * da_b;
    dsum = fmaf(sdt[qb], da_b, dsum);
  }
  dsum = warp_sum(dsum);
  if (lane == 0) dap[bh * nc + c] = dsum;
}

// --------------------------------------------------------- 6. reductions
// dBm[b, s, n] = sum_h dbp[b, h, s, n], the same for dCm, h in order.
__global__ void __launch_bounds__(MS_THREADS)
    ms_reduce_bc(const float* __restrict__ dbp, const float* __restrict__ dcp,
                 float* __restrict__ dB, float* __restrict__ dC, int Bsz,
                 int SN, int H) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (size_t)Bsz * SN) return;
  const size_t b = e / SN, r = e % SN;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < H; ++h) {
    sb += dbp[(b * H + h) * SN + r];
    sc += dcp[(b * H + h) * SN + r];
  }
  dB[e] = sb;
  dC[e] = sc;
}

// dA[h] = sum over b, then chunks, of dap[b, h, c].
__global__ void ms_reduce_a(const float* __restrict__ dap,
                            float* __restrict__ dA, int Bsz, int H, int nc) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  float acc = 0.f;
  for (int b = 0; b < Bsz; ++b)
    for (int c = 0; c < nc; ++c) acc += dap[((size_t)b * H + h) * nc + c];
  dA[h] = acc;
}

// ------------------------------------------------------------ host side
static size_t cb_smem(int N, int Q) {
  return sizeof(float) * 2 * (size_t)frames(Q) * FR * k_ld(N);
}
static size_t states_smem(int P, int N, int Q, bool bwd) {
  const size_t Qk = up4(Q);
  return sizeof(float) * (3 * Qk + (size_t)(bwd ? 2 : 1) * Qk *
                                       (frame_ld(P) + frame_ld(N)));
}
static size_t out_smem(int Q) {
  return sizeof(float) * ((size_t)OUT_FRAMES * FR * FLD + 2 * (size_t)up4(Q));
}
static size_t bwd_smem() { return sizeof(float) * BWD_SMEM_FLOATS; }

template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Passes 1-3 (with the backward's du when dy is given): cb, cs, st (the
// states entering the chunks), hfin and du.
template <typename T>
static cudaError_t prologue(const T* x, const float* dt, const float* A,
                            const float* Bm, const float* Cm, const T* dy,
                            const float* dhfin, float* cs, float* cb,
                            float* st, float* du, float* hfin, int Bsz,
                            int S, int H, int P, int N, int Q,
                            cudaStream_t stream) {
  const int nc = S / Q;
  cudaError_t err;
  const size_t s1 = cb_smem(N, Q), s2 = states_smem(P, N, Q, dy != nullptr);
  if ((err = allow_smem(ms_cb, s1)) != cudaSuccess) return err;
  ms_cb<<<dim3(nc, Bsz), MS_THREADS, s1, stream>>>(Bm, Cm, cb, S, N, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem(ms_states<T>, s2)) != cudaSuccess) return err;
  ms_states<T><<<dim3(nc, H, Bsz), MS_THREADS, s2, stream>>>(
      x, dt, A, Bm, dy, Cm, cs, st, du, S, H, P, N, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int PN = P * N;
  if (PN % 4 == 0)
    ms_scan<4><<<dim3((PN / 4 + MS_THREADS - 1) / MS_THREADS, H, Bsz),
                 MS_THREADS, 0, stream>>>(cs, st, hfin, dy ? du : nullptr,
                                          dhfin, S, H, PN, Q, nc);
  else
    ms_scan<1><<<dim3((PN + MS_THREADS - 1) / MS_THREADS, H, Bsz),
                 MS_THREADS, 0, stream>>>(cs, st, hfin, dy ? du : nullptr,
                                          dhfin, S, H, PN, Q, nc);
  return cudaGetLastError();
}

template <typename T>
static int forward(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, void* y, void* hfin,
                   void* cs, void* cb, void* st, int Bsz, int S, int H, int P,
                   int N, int Q, cudaStream_t stream) {
  cudaError_t err = prologue<T>(
      (const T*)x, (const float*)dt, (const float*)A, (const float*)Bm,
      (const float*)Cm, nullptr, nullptr, (float*)cs, (float*)cb,
      (float*)st, nullptr, (float*)hfin, Bsz, S, H, P, N, Q, stream);
  if (err != cudaSuccess) return (int)err;
  const size_t s4 = out_smem(Q);
  if ((err = allow_smem(ms_out<T>, s4)) != cudaSuccess) return (int)err;
  ms_out<T><<<dim3(S / Q, H, Bsz), MS_THREADS, s4, stream>>>(
      (const T*)x, (const float*)dt, (const float*)Cm, (const float*)cs,
      (const float*)cb, (const float*)st, (T*)y, S, H, P, N, Q);
  return (int)cudaGetLastError();
}

template <typename T>
static int backward(const void* x, const void* dt, const void* A,
                    const void* Bm, const void* Cm, const void* dy,
                    const void* dhfin, void* dx, void* ddt, void* dA,
                    void* dB, void* dC, void* cs, void* cb, void* st,
                    void* du, void* dbp, void* dcp, void* dap, int Bsz,
                    int S, int H, int P, int N, int Q, cudaStream_t stream) {
  if (P > FR || Q > FR) return (int)cudaErrorInvalidValue;
  cudaError_t err = prologue<T>(
      (const T*)x, (const float*)dt, (const float*)A, (const float*)Bm,
      (const float*)Cm, (const T*)dy, (const float*)dhfin, (float*)cs,
      (float*)cb, (float*)st, (float*)du, nullptr, Bsz, S, H, P, N, Q,
      stream);
  if (err != cudaSuccess) return (int)err;
  const int nc = S / Q;
  const size_t s5 = bwd_smem();
  if ((err = allow_smem(ms_bwd_chunk<T>, s5)) != cudaSuccess) return (int)err;
  ms_bwd_chunk<T><<<dim3(nc, H, Bsz), MS_THREADS, s5, stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const float*)Bm,
      (const float*)Cm, (const T*)dy, (const float*)cs, (const float*)cb,
      (const float*)st, (const float*)du, (T*)dx, (float*)ddt, (float*)dbp,
      (float*)dcp, (float*)dap, S, H, P, N, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t total = (size_t)Bsz * S * N;
  ms_reduce_bc<<<(unsigned)((total + MS_THREADS - 1) / MS_THREADS),
                 MS_THREADS, 0, stream>>>((const float*)dbp,
                                          (const float*)dcp, (float*)dB,
                                          (float*)dC, Bsz, S * N, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ms_reduce_a<<<(H + 63) / 64, 64, 0, stream>>>((const float*)dap,
                                                (float*)dA, Bsz, H, nc);
  return (int)cudaGetLastError();
}

// The dynamic shared memory the largest pass needs at (P, N, Q), and what
// a block may opt in to on the device, in bytes: the wrapper rejects a
// shape whose need is above the limit before it launches.
extern "C" int arms_mamba_scan_smem(int P, int N, int Q, int device,
                                    long long* need, int* limit) {
  size_t m = bwd_smem();
  const size_t others[] = {cb_smem(N, Q), states_smem(P, N, Q, true),
                           out_smem(Q)};
  for (size_t o : others) m = o > m ? o : m;
  *need = (long long)m;
  return (int)cudaDeviceGetAttribute(
      limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// dtype: 0 = f32 x/y, 1 = bf16 x/y.  Scratch (f32, from the caller):
// cs [B, H, S], cb [B, S/Q, Q, Q], st [B, H, S/Q, P, N].
extern "C" int arms_mamba_scan_fwd(const void* x, const void* dt,
                                   const void* A, const void* Bm,
                                   const void* Cm, void* y, void* hfin,
                                   void* cs, void* cb, void* st, int Bsz,
                                   int S, int H, int P, int N, int Q,
                                   int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1
             ? forward<__nv_bfloat16>(x, dt, A, Bm, Cm, y, hfin, cs, cb, st,
                                      Bsz, S, H, P, N, Q, s)
             : forward<float>(x, dt, A, Bm, Cm, y, hfin, cs, cb, st, Bsz, S,
                              H, P, N, Q, s);
}

// dhfin may be null (a zero gradient of the final state).  Scratch as the
// forward's, plus du [B, H, S/Q, P, N], dbp/dcp [B, H, S, N], dap
// [B, H, S/Q].
extern "C" int arms_mamba_scan_bwd(const void* x, const void* dt,
                                   const void* A, const void* Bm,
                                   const void* Cm, const void* dy,
                                   const void* dhfin, void* dx, void* ddt,
                                   void* dA, void* dB, void* dC, void* cs,
                                   void* cb, void* st, void* du, void* dbp,
                                   void* dcp, void* dap, int Bsz, int S,
                                   int H, int P, int N, int Q, int dtype,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1
             ? backward<__nv_bfloat16>(x, dt, A, Bm, Cm, dy, dhfin, dx, ddt,
                                       dA, dB, dC, cs, cb, st, du, dbp, dcp,
                                       dap, Bsz, S, H, P, N, Q, s)
             : backward<float>(x, dt, A, Bm, Cm, dy, dhfin, dx, ddt, dA, dB,
                               dC, cs, cb, st, du, dbp, dcp, dap, Bsz, S, H,
                               P, N, Q, s);
}

