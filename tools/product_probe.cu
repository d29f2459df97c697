// One product of the Mamba2 scan's backward, two ways, for the choice
// between f32 routes that keep f32 accuracy (tools/redesign_probe.py).
//
// Each block forms out = A^T B over a 64 x 64 frame with k = 64 (A and B
// [64][64] row-major, A read along its rows as the scan's dxdt and state
// products read theirs), REPS times over the same shared tiles, so the
// arithmetic and not device memory bounds the run:
//   prod_ffma: 256 threads, a 4 x 4 register tile each, fmaf on float4
//              strips of shared memory (the scan's tile_mm);
//   prod_3xtf32: 8 warps of mma.sync.m16n8k8 tf32, each operand split as
//              x = hi + lo (hi = x rounded to tf32), three products
//              hi.hi + hi.lo + lo.hi per step, summed in f32.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
//        -shared -Xcompiler -fPIC -o probe.so product_probe.cu
#include <cuda_runtime.h>
#include <stdint.h>

#define FLD 68
#define REPS 16

__device__ void load_tiles(const float* A, const float* B, float* sA,
                           float* sB) {
  const size_t off = (size_t)blockIdx.x * 64 * 64;
  for (int e = threadIdx.x; e < 64 * 64; e += blockDim.x) {
    sA[(e >> 6) * FLD + (e & 63)] = A[off + e];
    sB[(e >> 6) * FLD + (e & 63)] = B[off + e];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(256, 2)
    prod_ffma(const float* __restrict__ A, const float* __restrict__ B,
              float* __restrict__ out) {
  __shared__ __align__(16) float sA[64 * FLD];
  __shared__ __align__(16) float sB[64 * FLD];
  load_tiles(A, B, sA, sB);
  const int mt = threadIdx.x >> 4, nt = threadIdx.x & 15;
  float acc[4][4] = {};
  for (int rep = 0; rep < REPS; ++rep)
    for (int k = 0; k < 64; k += 4) {
      float a[4][4], b[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 u = *reinterpret_cast<const float4*>(sA + (k + q) * FLD + 4 * mt);
        const float4 v = *reinterpret_cast<const float4*>(sB + (k + q) * FLD + 4 * nt);
        a[q][0] = u.x; a[q][1] = u.y; a[q][2] = u.z; a[q][3] = u.w;
        b[q][0] = v.x; b[q][1] = v.y; b[q][2] = v.z; b[q][3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[r][c] = fmaf(a[kk][r], b[kk][c], acc[r][c]);
    }
  float* o = out + (size_t)blockIdx.x * 64 * 64;
  for (int r = 0; r < 4; ++r)
    for (int c = 0; c < 4; ++c) o[(4 * mt + r) * 64 + 4 * nt + c] = acc[r][c];
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(256, 2)
    prod_3xtf32(const float* __restrict__ A, const float* __restrict__ B,
                float* __restrict__ out) {
  __shared__ __align__(16) float sA[64 * FLD];
  __shared__ __align__(16) float sB[64 * FLD];
  load_tiles(A, B, sA, sB);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = 16 * (warp & 3), n0 = 32 * (warp >> 2);
  float acc[4][4] = {};   // [n-tile][fragment]
  for (int rep = 0; rep < REPS; ++rep)
    for (int k = 0; k < 64; k += 8) {
      // A(m, k) = sA[k][m]: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
      // a3 (g + 8, t + 4)
      const float av[4] = {sA[(k + t) * FLD + m0 + g],
                           sA[(k + t) * FLD + m0 + g + 8],
                           sA[(k + t + 4) * FLD + m0 + g],
                           sA[(k + t + 4) * FLD + m0 + g + 8]};
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ahi[i] = tf32(av[i]);
        alo[i] = tf32(av[i] - __uint_as_float(ahi[i]));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float b0 = sB[(k + t) * FLD + n0 + 8 * j + g];
        const float b1 = sB[(k + t + 4) * FLD + n0 + 8 * j + g];
        const uint32_t h0 = tf32(b0), h1 = tf32(b1);
        const uint32_t l0 = tf32(b0 - __uint_as_float(h0));
        const uint32_t l1 = tf32(b1 - __uint_as_float(h1));
        mma_tf32(acc[j], alo, h0, h1);
        mma_tf32(acc[j], ahi, l0, l1);
        mma_tf32(acc[j], ahi, h0, h1);
      }
    }
  float* o = out + (size_t)blockIdx.x * 64 * 64;
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + 8 * j + 2 * t;
    o[(m0 + g) * 64 + n] = acc[j][0];
    o[(m0 + g) * 64 + n + 1] = acc[j][1];
    o[(m0 + g + 8) * 64 + n] = acc[j][2];
    o[(m0 + g + 8) * 64 + n + 1] = acc[j][3];
  }
}

extern "C" int probe_product(int route, const float* A, const float* B,
                             float* out, int blocks, cudaStream_t stream) {
  if (route == 0)
    prod_ffma<<<blocks, 256, 0, stream>>>(A, B, out);
  else
    prod_3xtf32<<<blocks, 256, 0, stream>>>(A, B, out);
  return (int)cudaGetLastError();
}
