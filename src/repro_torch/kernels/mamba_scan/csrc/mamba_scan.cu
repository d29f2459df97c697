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
// P = 64, N = 128, Q = 64) the forward does about 10.9 GFLOP for about
// 146 MB moved, far above the card's f32 balance.  This first version is
// chunk-parallel and runs its products in f32 on the CUDA cores from
// shared memory (fmaf; the library builds with -fmad=false): simple and
// exact to f32 rounding.  The TPU kernel walks the chunks of one (b, h)
// in order with the state in VMEM; here blocks run in parallel, so the
// scan is cut into passes over device memory:
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
//      to the state entering it, sum_i exp(cs_i) dy[i] C_i^T.
//   3. ms_scan: one thread per (b, h, p, n) walks the chunks: forward,
//      it replaces each chunk state by the state entering the chunk and
//      writes the final state; backward, it walks the chunks in reverse
//      and leaves the gradient of the state leaving each chunk.
//   4. ms_out: one block per (chunk, head, b): y from the decay-masked
//      C . B^T, x dt and the state entering the chunk.
//   5. ms_bwd_chunk: one block per (chunk, head, b) forms the chunk's dx,
//      ddt and its head's share of dBm, dCm and dA (products of the
//      forward's terms with dy and with the gradient of the state leaving
//      the chunk, then the reverse cumsum back to dt and A).
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
#define MS_BWD_THREADS 512

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

// ------------------------------------------------------------ 1. C . B^T
// cb [B, nc, Q, Q]: cb[i][j] = C_i . B_j for j <= i, 0 above the diagonal.
// B rows in shared memory are N + 1 floats long, so the threads of a warp
// (consecutive j) read distinct banks.
__global__ void __launch_bounds__(MS_THREADS)
    ms_cb(const float* __restrict__ Bm, const float* __restrict__ Cm,
          float* __restrict__ cb, int S, int N, int Q) {
  extern __shared__ float sm[];
  const int c = blockIdx.x, b = blockIdx.y, nc = gridDim.x;
  float* sC = sm;              // [Q][N]
  float* sB = sC + Q * N;      // [Q][N + 1]
  const size_t row0 = (size_t)b * S + (size_t)c * Q;
  for (int e = threadIdx.x; e < Q * N; e += blockDim.x) {
    const int q = e / N, n = e % N;
    sC[e] = Cm[(row0 + q) * N + n];
    sB[q * (N + 1) + n] = Bm[(row0 + q) * N + n];
  }
  __syncthreads();
  float* out = cb + ((size_t)b * nc + c) * Q * Q;
  for (int e = threadIdx.x; e < Q * Q; e += blockDim.x) {
    const int i = e / Q, j = e % Q;
    float acc = 0.f;
    if (j <= i)
      for (int n = 0; n < N; ++n)
        acc = fmaf(sC[i * N + n], sB[j * (N + 1) + n], acc);
    out[e] = acc;
  }
}

// ------------------------------------------------------ 2. chunk states
// cs [B, H, S]; st and du [B, H, nc, P, N].  With dy == nullptr only the
// forward's part runs.
template <typename T>
__global__ void __launch_bounds__(MS_THREADS)
    ms_states(const T* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const float* __restrict__ Bm,
              const T* __restrict__ dy, const float* __restrict__ Cm,
              float* __restrict__ cs, float* __restrict__ st,
              float* __restrict__ du, int S, int H, int P, int N, int Q) {
  extern __shared__ float sm[];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  float* scs = sm;             // [Q]
  float* sw = scs + Q;         // [Q] exp(cs_Q-1 - cs_j) dt_j
  float* se = sw + Q;          // [Q] exp(cs_i)
  float* sxw = se + Q;         // [Q][P] w_j x[j]
  float* sB = sxw + Q * P;     // [Q][N]
  float* sdy = sB + Q * N;     // [Q][P] exp(cs_i) dy[i]   (backward)
  float* sC = sdy + Q * P;     // [Q][N]                   (backward)
  const size_t row0 = (size_t)b * S + (size_t)c * Q;
  if (threadIdx.x == 0) {   // summed in f64, as PyTorch's CPU cumsum does
    const float a = A[h];
    double run = 0.0;
    for (int q = 0; q < Q; ++q) {
      run += (double)(dt[(row0 + q) * H + h] * a);
      scs[q] = (float)run;
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < Q; q += blockDim.x) {
    sw[q] = expf(scs[Q - 1] - scs[q]) * dt[(row0 + q) * H + h];
    se[q] = expf(scs[q]);
    cs[((size_t)b * H + h) * S + (size_t)c * Q + q] = scs[q];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < Q * P; e += blockDim.x) {
    const int q = e / P, p = e % P;
    const size_t xi = ((row0 + q) * H + h) * P + p;
    sxw[e] = to_f(x[xi]) * sw[q];
    if (dy) sdy[e] = to_f(dy[xi]) * se[q];
  }
  for (int e = threadIdx.x; e < Q * N; e += blockDim.x) {
    sB[e] = Bm[row0 * N + e];
    if (dy) sC[e] = Cm[row0 * N + e];
  }
  __syncthreads();
  const size_t out0 = (((size_t)b * H + h) * nc + c) * P * N;
  for (int e = threadIdx.x; e < P * N; e += blockDim.x) {
    const int p = e / N, n = e % N;
    float acc = 0.f;
    for (int j = 0; j < Q; ++j) acc = fmaf(sxw[j * P + p], sB[j * N + n], acc);
    st[out0 + e] = acc;
    if (dy) {
      float u = 0.f;
      for (int i = 0; i < Q; ++i) u = fmaf(sdy[i * P + p], sC[i * N + n], u);
      du[out0 + e] = u;
    }
  }
}

// ---------------------------------------------------- 3. chunk recurrence
// Forward (st): st[c] <- the state entering chunk c; hfin <- the last
// state.  Backward (du): du[c] <- the gradient of the state leaving chunk
// c, from dh_final (zero when null).
__global__ void __launch_bounds__(MS_THREADS)
    ms_scan(const float* __restrict__ cs, float* __restrict__ st,
            float* __restrict__ hfin, float* __restrict__ du,
            const float* __restrict__ dhfin, int S, int H, int PN, int Q,
            int nc) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= PN) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const float* csr = cs + bh * S;
  const size_t base = bh * nc * PN + e;
  if (st) {
    float s = 0.f;
    for (int c = 0; c < nc; ++c) {
      const float g = expf(csr[c * Q + Q - 1]);
      const float v = st[base + (size_t)c * PN];
      st[base + (size_t)c * PN] = s;
      s = s * g + v;
    }
    if (hfin) hfin[bh * PN + e] = s;
  }
  if (du) {
    float d = dhfin ? dhfin[bh * PN + e] : 0.f;
    for (int c = nc - 1; c >= 0; --c) {
      const float g = expf(csr[c * Q + Q - 1]);
      const float u = du[base + (size_t)c * PN];
      du[base + (size_t)c * PN] = d;
      d = d * g + u;
    }
  }
}

// ------------------------------------------------------------ 4. outputs
// Shared rows of the state are N + 1 floats long: the threads of a warp
// (consecutive p) read distinct banks.
template <typename T>
__global__ void __launch_bounds__(MS_THREADS)
    ms_out(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ Cm, const float* __restrict__ cs,
           const float* __restrict__ cb, const float* __restrict__ st,
           T* __restrict__ y, int S, int H, int P, int N, int Q) {
  extern __shared__ float sm[];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  float* scs = sm;             // [Q]
  float* sxdt = scs + Q;       // [Q][P]
  float* sM = sxdt + Q * P;    // [Q][Q] decay-masked C . B^T
  float* sC = sM + Q * Q;      // [Q][N]
  float* sH = sC + Q * N;      // [P][N + 1] state entering the chunk
  const size_t row0 = (size_t)b * S + (size_t)c * Q;
  const size_t bh = (size_t)b * H + h;
  for (int q = threadIdx.x; q < Q; q += blockDim.x)
    scs[q] = cs[bh * S + (size_t)c * Q + q];
  for (int e = threadIdx.x; e < Q * P; e += blockDim.x) {
    const int q = e / P, p = e % P;
    sxdt[e] = to_f(x[((row0 + q) * H + h) * P + p]) * dt[(row0 + q) * H + h];
  }
  for (int e = threadIdx.x; e < Q * N; e += blockDim.x)
    sC[e] = Cm[row0 * N + e];
  const float* hc = st + (bh * nc + c) * P * N;
  for (int e = threadIdx.x; e < P * N; e += blockDim.x)
    sH[(e / N) * (N + 1) + e % N] = hc[e];
  __syncthreads();
  const float* cbc = cb + ((size_t)b * nc + c) * Q * Q;
  for (int e = threadIdx.x; e < Q * Q; e += blockDim.x) {
    const int i = e / Q, j = e % Q;
    sM[e] = j <= i ? expf(scs[i] - scs[j]) * cbc[e] : 0.f;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < Q * P; e += blockDim.x) {
    const int i = e / P, p = e % P;
    float diag = 0.f, off = 0.f;
    for (int j = 0; j <= i; ++j) diag = fmaf(sM[i * Q + j], sxdt[j * P + p], diag);
    for (int n = 0; n < N; ++n) off = fmaf(sC[i * N + n], sH[p * (N + 1) + n], off);
    y[((row0 + i) * H + h) * P + p] = from_f<T>(diag + expf(scs[i]) * off);
  }
}

// ----------------------------------------------------- 5. chunk gradients
// One block per (chunk, head, b), given dy, the state h_c entering the
// chunk (st) and the gradient dH of the state leaving it (du):
//   dxdt = M^T dy,  dM = (dy (x dt)^T) on j <= i,  dCB = dM L,
//   dcs  += rowsum(dM M) - colsum(dM M)                       (y_diag)
//   dC   = exp(cs_i) dy h_c + dCB B,  dcs_i += C_i . that first term
//   dB   = dCB^T C + w_j x[j] dH,  U = B dH^T,  dx = dt dxdt + w U
//   dw_j = x[j] . U[j],  dg = <dH, h_c>,  g = exp(cs_Q-1)
// then dcs through w and g, the reverse cumsum da, ddt = x . dxdt +
// exp(cs_Q-1 - cs_j) dw_j + A da_j and the head's dA share sum_j dt_j da_j.
// dBm/dCm shares go to dbp/dcp [B, H, S, N], dA shares to dap [B, H, nc].
// Shared rows: x is P + 1 floats long (consecutive j on distinct banks),
// M and dCB Q + 1, the dC-then-dH buffer N + 1 (consecutive p).
template <typename T>
__global__ void __launch_bounds__(MS_BWD_THREADS)
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
  const int QP1 = Q + 1, PP1 = P + 1, NP1 = N + 1;
  float* scs = sm;                      // [Q]
  float* sdt = scs + Q;                 // [Q]
  float* sw = sdt + Q;                  // [Q]
  float* se = sw + Q;                   // [Q]
  float* sdcs = se + Q;                 // [Q]
  float* sdw = sdcs + Q;                // [Q]
  float* sddt = sdw + Q;                // [Q]
  float* sred = sddt + Q;               // [MS_BWD_THREADS]
  float* sx = sred + MS_BWD_THREADS;    // [Q][P + 1]
  float* sdy = sx + Q * PP1;            // [Q][P]
  float* sdx = sdy + Q * P;             // [Q][P]
  float* sM = sdx + Q * P;              // [Q][Q + 1]
  float* sdCB = sM + Q * QP1;           // [Q][Q + 1]
  float* sC = sdCB + Q * QP1;           // [Q][N]
  float* sB = sC + Q * N;               // [Q][N]
  float* sH = sB + Q * N;               // [P][N]
  float* sT = sH + P * N;               // [max(Q, P)][N + 1]
  const size_t row0 = (size_t)b * S + (size_t)c * Q;
  const size_t bh = (size_t)b * H + h;
  const float a = A[h];

  for (int q = threadIdx.x; q < Q; q += blockDim.x) {
    scs[q] = cs[bh * S + (size_t)c * Q + q];
    sdt[q] = dt[(row0 + q) * H + h];
  }
  __syncthreads();
  for (int q = threadIdx.x; q < Q; q += blockDim.x) {
    sw[q] = expf(scs[Q - 1] - scs[q]) * sdt[q];
    se[q] = expf(scs[q]);
  }
  for (int e = threadIdx.x; e < Q * P; e += blockDim.x) {
    const int q = e / P, p = e % P;
    const size_t xi = ((row0 + q) * H + h) * P + p;
    sx[q * PP1 + p] = to_f(x[xi]);
    sdy[e] = to_f(dy[xi]);
  }
  for (int e = threadIdx.x; e < Q * N; e += blockDim.x) {
    sC[e] = Cm[row0 * N + e];
    sB[e] = Bm[row0 * N + e];
  }
  const float* hc = st + (bh * nc + c) * P * N;
  for (int e = threadIdx.x; e < P * N; e += blockDim.x) sH[e] = hc[e];
  const float* cbc = cb + ((size_t)b * nc + c) * Q * Q;
  for (int e = threadIdx.x; e < Q * Q; e += blockDim.x) {
    const int i = e / Q, j = e % Q;
    sM[i * QP1 + j] = j <= i ? expf(scs[i] - scs[j]) * cbc[e] : 0.f;
  }
  __syncthreads();

  // dxdt[j][p] = sum_{i>=j} M[i][j] dy[i][p]
  for (int e = threadIdx.x; e < Q * P; e += blockDim.x) {
    const int j = e / P, p = e % P;
    float acc = 0.f;
    for (int i = j; i < Q; ++i) acc = fmaf(sM[i * QP1 + j], sdy[i * P + p], acc);
    sdx[e] = acc;
  }
  __syncthreads();
  // dM, then dCB = dM L and (in place of M) dM M
  for (int e = threadIdx.x; e < Q * Q; e += blockDim.x) {
    const int i = e / Q, j = e % Q;
    float dcb = 0.f, dl = 0.f;
    if (j <= i) {
      float acc = 0.f;
      for (int p = 0; p < P; ++p) acc = fmaf(sdy[i * P + p], sx[j * PP1 + p], acc);
      const float dm = acc * sdt[j];
      dcb = dm * expf(scs[i] - scs[j]);
      dl = dm * sM[i * QP1 + j];
    }
    sdCB[i * QP1 + j] = dcb;
    sM[i * QP1 + j] = dl;
  }
  __syncthreads();
  // dC's off-diagonal term exp(cs_i) dy h_c into sT; dcs of y_diag
  for (int e = threadIdx.x; e < Q * N; e += blockDim.x) {
    const int i = e / N, n = e % N;
    float acc = 0.f;
    for (int p = 0; p < P; ++p) acc = fmaf(sdy[i * P + p], sH[p * N + n], acc);
    sT[i * NP1 + n] = se[i] * acc;
  }
  for (int q = threadIdx.x; q < Q; q += blockDim.x) {
    float row = 0.f, col = 0.f;
    for (int j = 0; j < Q; ++j) row += sM[q * QP1 + j];
    for (int i = 0; i < Q; ++i) col += sM[i * QP1 + q];
    sdcs[q] = row - col;
  }
  __syncthreads();
  // dcs of y_off; dC = off-diagonal term + dCB B
  for (int q = threadIdx.x; q < Q; q += blockDim.x) {
    float acc = 0.f;
    for (int n = 0; n < N; ++n) acc = fmaf(sC[q * N + n], sT[q * NP1 + n], acc);
    sdcs[q] += acc;
  }
  for (int e = threadIdx.x; e < Q * N; e += blockDim.x) {
    const int i = e / N, n = e % N;
    float acc = 0.f;
    for (int j = 0; j <= i; ++j) acc = fmaf(sdCB[i * QP1 + j], sB[j * N + n], acc);
    dcp[(bh * S + (size_t)c * Q + i) * N + n] = sT[i * NP1 + n] + acc;
  }
  __syncthreads();
  // dH: the gradient of the state leaving the chunk, into sT as [P][N + 1]
  const float* dhc = du + (bh * nc + c) * P * N;
  for (int e = threadIdx.x; e < P * N; e += blockDim.x)
    sT[(e / N) * NP1 + e % N] = dhc[e];
  __syncthreads();
  // dB = dCB^T C + w x dH
  for (int e = threadIdx.x; e < Q * N; e += blockDim.x) {
    const int j = e / N, n = e % N;
    float acc = 0.f, st_acc = 0.f;
    for (int i = j; i < Q; ++i) acc = fmaf(sdCB[i * QP1 + j], sC[i * N + n], acc);
    for (int p = 0; p < P; ++p) st_acc = fmaf(sx[j * PP1 + p], sT[p * NP1 + n], st_acc);
    dbp[(bh * S + (size_t)c * Q + j) * N + n] = acc + sw[j] * st_acc;
  }
  // U = B dH^T; dx = dt dxdt + w U; keep x dxdt (in sdx) and x U (in sdy)
  for (int e = threadIdx.x; e < Q * P; e += blockDim.x) {
    const int j = e / P, p = e % P;
    float u = 0.f;
    for (int n = 0; n < N; ++n) u = fmaf(sB[j * N + n], sT[p * NP1 + n], u);
    const float dxdt = sdx[e], xv = sx[j * PP1 + p];
    dx[((row0 + j) * H + h) * P + p] = from_f<T>(sdt[j] * dxdt + sw[j] * u);
    sdx[e] = xv * dxdt;
    sdy[e] = xv * u;
  }
  // dg = <dH, h_c>: a fixed share of the elements per thread
  {
    float acc = 0.f;
    for (int e = threadIdx.x; e < P * N; e += blockDim.x)
      acc = fmaf(sT[(e / N) * NP1 + e % N], sH[e], acc);
    sred[threadIdx.x] = acc;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < Q; q += blockDim.x) {
    float xd = 0.f, xu = 0.f;
    for (int p = 0; p < P; ++p) {
      xd += sdx[q * P + p];
      xu += sdy[q * P + p];
    }
    sddt[q] = xd;
    sdw[q] = xu;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float dg = 0.f;
    for (int t = 0; t < MS_BWD_THREADS; ++t) dg += sred[t];
    const float cl = scs[Q - 1];
    float dcl = dg * expf(cl);
    for (int j = 0; j < Q; ++j) {
      const float v = sdw[j] * sw[j];
      dcl += v;
      sdcs[j] -= v;
    }
    sdcs[Q - 1] += dcl;
    float run = 0.f, da_sum = 0.f;
    for (int q = Q - 1; q >= 0; --q) {
      run += sdcs[q];                   // da_q = sum_{m>=q} dcs_m
      ddt[(row0 + q) * H + h] =
          sddt[q] + expf(cl - scs[q]) * sdw[q] + a * run;
      da_sum = fmaf(sdt[q], run, da_sum);
    }
    dap[bh * nc + c] = da_sum;
  }
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
  return sizeof(float) * ((size_t)Q * N + (size_t)Q * (N + 1));
}
static size_t states_smem(int P, int N, int Q, bool bwd) {
  return sizeof(float) *
         (3 * (size_t)Q + (size_t)(bwd ? 2 : 1) * Q * (P + N));
}
static size_t out_smem(int P, int N, int Q) {
  return sizeof(float) * ((size_t)Q + (size_t)Q * P + (size_t)Q * Q +
                          (size_t)Q * N + (size_t)P * (N + 1));
}
static size_t bwd_smem(int P, int N, int Q) {
  const size_t m = Q > P ? Q : P;
  return sizeof(float) *
         (7 * (size_t)Q + MS_BWD_THREADS + (size_t)Q * (P + 1) +
          2 * (size_t)Q * P + 2 * (size_t)Q * (Q + 1) + 2 * (size_t)Q * N +
          (size_t)P * N + m * (N + 1));
}

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
  ms_scan<<<dim3((PN + MS_THREADS - 1) / MS_THREADS, H, Bsz), MS_THREADS, 0,
            stream>>>(cs, st, hfin, dy ? du : nullptr, dhfin, S, H, PN, Q,
                      nc);
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
  const size_t s4 = out_smem(P, N, Q);
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
  cudaError_t err = prologue<T>(
      (const T*)x, (const float*)dt, (const float*)A, (const float*)Bm,
      (const float*)Cm, (const T*)dy, (const float*)dhfin, (float*)cs,
      (float*)cb, (float*)st, (float*)du, nullptr, Bsz, S, H, P, N, Q,
      stream);
  if (err != cudaSuccess) return (int)err;
  const int nc = S / Q;
  const size_t s5 = bwd_smem(P, N, Q);
  if ((err = allow_smem(ms_bwd_chunk<T>, s5)) != cudaSuccess) return (int)err;
  ms_bwd_chunk<T><<<dim3(nc, H, Bsz), MS_BWD_THREADS, s5, stream>>>(
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
  size_t m = bwd_smem(P, N, Q);
  const size_t others[] = {cb_smem(N, Q), states_smem(P, N, Q, true),
                           out_smem(P, N, Q)};
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

