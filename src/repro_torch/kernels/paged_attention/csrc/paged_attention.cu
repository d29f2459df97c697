// Paged decode attention, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention/kernel.py
// (paged_attention_kernel): one query token per sequence attends, GQA, over
// the KV pages its block table names, with tokens at or past seq_lens[b]
// masked, an f32 softmax and the max(l, 1e-30) guard; the output has q's
// dtype (f32 or bf16).  The serving layer also needs each page's attention
// mass, the sum of the softmax probabilities of its tokens over heads, which
// the TPU kernel's online softmax never writes out.  Build:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libpaged_attention.so paged_attention.cu
//
// Bound: bytes.  Decode reads every valid K and V page once and does about
// 4 flops per element read, far below the card's 295 flops a byte.  The TPU
// kernel walks a sequence's pages in order on one core with the online
// softmax carried in VMEM; on Hopper that walk would leave most SMs idle, so
// the work is split flash-decoding style:
//
//   1. pa_partial: one block per (table entry, sequence x KV head).  It
//      stages the rep query rows in shared memory, forms the page's scores
//      (one warp per (row, token), lanes over head_dim, a fixed shuffle
//      tree), and writes the page's max m, sum l of exp(s - m), and
//      acc = sum_t exp(s_t - m) v_t for each query row.
//   2. pa_combine: one block per (sequence x KV head).  For each query row
//      it forms M = max m, the weights w = exp(m - M), L = sum l w in
//      table order, the output sum acc w / max(L, 1e-30), and each page's
//      mass l w / L.
//   3. pa_mass: one block per sequence sums the pages' mass over the heads
//      in head order, in f64, and rounds once.
//
// A table entry out of the pool's range is clamped into it (the
// reference's gather clamps too), so no entry reads outside the pools.
// A page with no valid token has m = -1e30, so its weight exp(-1e30 - M)
// is exactly 0 whenever any token is valid: it adds nothing to the output
// or the mass.  When no token is valid all weights are 1 and the output is
// the mean of V, as in the reference.  Every sum runs in a fixed order and
// nothing is atomic, so two runs give the same bits: the mass feeds an
// exact ranking (ARMS's EWMA and top-k).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define PA_THREADS 128
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

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T>
__global__ void pa_partial(const T* __restrict__ q, const T* __restrict__ kp,
                           const T* __restrict__ vp,
                           const int* __restrict__ tables,
                           const int* __restrict__ lens,
                           float* __restrict__ m_out,
                           float* __restrict__ l_out,
                           float* __restrict__ acc_out, int P, int H,
                           int KV, int page, int dh, int n_pp, float scale) {
  extern __shared__ float sm[];
  const int i = blockIdx.x;
  const int b = blockIdx.y / KV, kv = blockIdx.y % KV;
  const int rep = H / KV, h0 = kv * rep;
  float* qs = sm;              // [rep, dh] query rows, f32
  float* ps = sm + rep * dh;   // [rep, page] scores, then exp(s - m)
  const int64_t row = min(max(tables[(int64_t)b * n_pp + i], 0), P - 1);
  const int len = lens[b];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;

  for (int x = threadIdx.x; x < rep * dh; x += blockDim.x)
    qs[x] = to_f(q[((int64_t)b * H + h0) * dh + x]);
  __syncthreads();

  for (int pr = warp; pr < rep * page; pr += n_warps) {
    const int r = pr / page, t = pr % page;
    const T* k = kp + ((row * page + t) * KV + kv) * (int64_t)dh;
    float s = 0.0f;
    for (int d = lane; d < dh; d += 32) s += qs[r * dh + d] * to_f(k[d]);
    s = warp_sum(s);
    if (lane == 0) ps[pr] = (i * page + t < len) ? s * scale : NEG_INF_SCORE;
  }
  __syncthreads();

  for (int r = warp; r < rep; r += n_warps) {
    float m = -INFINITY;
    for (int t = lane; t < page; t += 32) m = fmaxf(m, ps[r * page + t]);
    m = warp_max(m);
    float l = 0.0f;
    for (int t = lane; t < page; t += 32) {
      const float p = expf(ps[r * page + t] - m);
      ps[r * page + t] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      const int64_t at = ((int64_t)b * H + h0 + r) * n_pp + i;
      m_out[at] = m;
      l_out[at] = l;
    }
  }
  __syncthreads();

  for (int x = threadIdx.x; x < rep * dh; x += blockDim.x) {
    const int r = x / dh, d = x % dh;
    float a = 0.0f;
    for (int t = 0; t < page; ++t)
      a += ps[r * page + t] * to_f(vp[((row * page + t) * KV + kv) * dh + d]);
    acc_out[(((int64_t)b * H + h0 + r) * n_pp + i) * dh + d] = a;
  }
}

template <typename T>
__global__ void pa_combine(const float* __restrict__ m_in,
                           const float* __restrict__ l_in,
                           const float* __restrict__ acc,
                           T* __restrict__ out, float* __restrict__ mass_h,
                           int H, int KV, int dh, int n_pp) {
  extern __shared__ float w[];   // [n_pp] weights exp(m - M)
  __shared__ float L_s;
  const int b = blockIdx.x / KV, kv = blockIdx.x % KV;
  const int rep = H / KV;
  for (int r = 0; r < rep; ++r) {
    const int64_t h = (int64_t)b * H + kv * rep + r;
    const float* m = m_in + h * n_pp;
    const float* l = l_in + h * n_pp;
    if (threadIdx.x == 0) {
      float M = -INFINITY;
      for (int i = 0; i < n_pp; ++i) M = fmaxf(M, m[i]);
      float L = 0.0f;
      for (int i = 0; i < n_pp; ++i) {
        w[i] = expf(m[i] - M);
        L += l[i] * w[i];
      }
      L_s = fmaxf(L, 1e-30f);
    }
    __syncthreads();
    const float L = L_s;
    for (int d = threadIdx.x; d < dh; d += blockDim.x) {
      float a = 0.0f;
      for (int i = 0; i < n_pp; ++i) a += acc[(h * n_pp + i) * dh + d] * w[i];
      out[h * dh + d] = from_f<T>(a / L);
    }
    if (mass_h != nullptr)
      for (int i = threadIdx.x; i < n_pp; i += blockDim.x)
        mass_h[h * n_pp + i] = l[i] * w[i] / L;
    __syncthreads();
  }
}

__global__ void pa_mass(const float* __restrict__ mass_h,
                        float* __restrict__ mass, int H, int n_pp) {
  const int b = blockIdx.x;
  for (int i = threadIdx.x; i < n_pp; i += blockDim.x) {
    double s = 0.0;
    for (int h = 0; h < H; ++h)
      s += (double)mass_h[((int64_t)b * H + h) * n_pp + i];
    mass[(int64_t)b * n_pp + i] = (float)s;
  }
}

template <typename T>
static int launch(const void* q, const void* kp, const void* vp,
                  const int* tables, const int* lens, void* out,
                  float* m_buf, float* l_buf, float* acc_buf, float* mass_h,
                  float* mass, int P, int B, int H, int KV, int page, int dh,
                  int n_pp, float scale, cudaStream_t stream) {
  const int rep = H / KV;
  const size_t smem1 = sizeof(float) * ((size_t)rep * dh + (size_t)rep * page);
  pa_partial<T><<<dim3(n_pp, B * KV), PA_THREADS, smem1, stream>>>(
      (const T*)q, (const T*)kp, (const T*)vp, tables, lens, m_buf, l_buf,
      acc_buf, P, H, KV, page, dh, n_pp, scale);
  pa_combine<T><<<B * KV, PA_THREADS, sizeof(float) * n_pp, stream>>>(
      m_buf, l_buf, acc_buf, (T*)out, mass != nullptr ? mass_h : nullptr, H,
      KV, dh, n_pp);
  if (mass != nullptr)
    pa_mass<<<B, PA_THREADS, 0, stream>>>(mass_h, mass, H, n_pp);
  return (int)cudaGetLastError();
}

// dtype: 0 = f32, 1 = bf16.  Scratch: m_buf/l_buf/mass_h [B, H, n_pp] and
// acc_buf [B, H, n_pp, dh] f32; mass [B, n_pp] f32 or null (then mass_h may
// be null too).
extern "C" int arms_paged_attention(const void* q, const void* kp,
                                    const void* vp, const int* tables,
                                    const int* lens, void* out, float* m_buf,
                                    float* l_buf, float* acc_buf,
                                    float* mass_h, float* mass, int P, int B,
                                    int H, int KV, int page, int dh, int n_pp,
                                    float scale, int dtype,
                                    cudaStream_t stream) {
  if (P < 1 || B < 1 || KV < 1 || H % KV != 0 || page < 1 || dh < 1 || n_pp < 1 ||
      B * KV > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, kp, vp, tables, lens, out, m_buf, l_buf, acc_buf,
                         mass_h, mass, P, B, H, KV, page, dh, n_pp, scale,
                         stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, kp, vp, tables, lens, out, m_buf, l_buf,
                                 acc_buf, mass_h, mass, P, B, H, KV, page,
                                 dh, n_pp, scale, stream);
  return (int)cudaErrorInvalidValue;
}
