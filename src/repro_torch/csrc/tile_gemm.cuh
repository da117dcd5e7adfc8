// Batched tiled GEMM shared by conv1x1_gemm and stage1_tap_gemm:
//   C[t] (P x M) = A[t] (P x Cdim) @ B[t] (Cdim x M),  t = 0..T-1,
// fp32 FFMA accumulation (no TF32), A and B in TIn, C written in TOut.
//
// One block per (tm output channels, tp pixels, t).  The block walks its
// tp x tm region in 64 x 64 sub-tiles; 256 threads hold a 4 x 4 fp32
// accumulator each.  Per sub-tile the contraction runs in chunks of tc:
// the (64 x tc) slice of A is staged transposed, the (tc x 64) slice of
// B as it is, both converted to fp32, so shared memory is
// gemm_smem_bytes(tc) = 4 * tc * (64 + 1 + 64).  Ragged edges are
// masked to zero on load and skipped on store: nothing is padded in
// device memory.
#pragma once

#include "common.cuh"

constexpr int kGemmThreads = 256;
constexpr int kGemmSub = 64;      // sub-tile edge (pixels and channels)
constexpr int kGemmAStride = kGemmSub + 1;

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kGemmThreads)
tile_gemm_kernel(const TIn* __restrict__ A, const TIn* __restrict__ B,
                 TOut* __restrict__ Cout, int P, int Cdim, int M, int tp,
                 int tm, int tc) {
  extern __shared__ float smem[];
  float* As = smem;                          // [tc][64 + 1], transposed A
  float* Bs = smem + tc * kGemmAStride;      // [tc][64]
  const int64_t t = blockIdx.z;
  A += t * P * Cdim;
  B += t * Cdim * M;
  Cout += t * P * M;
  const int p_begin = blockIdx.y * tp;
  const int p_end = min(p_begin + tp, P);
  const int m_begin = blockIdx.x * tm;
  const int m_end = min(m_begin + tm, M);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  for (int p0 = p_begin; p0 < p_end; p0 += kGemmSub) {
    for (int m0 = m_begin; m0 < m_end; m0 += kGemmSub) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int c0 = 0; c0 < Cdim; c0 += tc) {
        const int kc = min(tc, Cdim - c0);
        // neighbouring threads read neighbouring channels of one pixel
        for (int e = tid; e < kGemmSub * kc; e += kGemmThreads) {
          const int k = e % kc, p = e / kc;
          const int gp = p0 + p;
          float v = 0.f;
          if (gp < p_end) v = to_f32(A[(int64_t)gp * Cdim + c0 + k]);
          As[k * kGemmAStride + p] = v;
        }
        for (int e = tid; e < kc * kGemmSub; e += kGemmThreads) {
          const int n = e % kGemmSub, k = e / kGemmSub;
          const int gm = m0 + n;
          float v = 0.f;
          if (gm < m_end) v = to_f32(B[(int64_t)(c0 + k) * M + gm]);
          Bs[k * kGemmSub + n] = v;
        }
        __syncthreads();
        for (int k = 0; k < kc; ++k) {
          float a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = As[k * kGemmAStride + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = Bs[k * kGemmSub + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gp = p0 + ty + 16 * i;
        if (gp >= p_end) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int gm = m0 + tx + 16 * j;
          if (gm < m_end) Cout[(int64_t)gp * M + gm] = from_f32<TOut>(acc[i][j]);
        }
      }
    }
  }
}

template <typename TIn, typename TOut>
static int launch_tile_gemm(const void* A, const void* B, void* C, int T,
                            int P, int Cdim, int M, int tp, int tm, int tc,
                            int smem, cudaStream_t stream) {
  auto kernel = tile_gemm_kernel<TIn, TOut>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((M + tm - 1) / tm, (P + tp - 1) / tp, T);
  kernel<<<grid, kGemmThreads, smem, stream>>>(
      static_cast<const TIn*>(A), static_cast<const TIn*>(B),
      static_cast<TOut*>(C), P, Cdim, M, tp, tm, tc);
  return static_cast<int>(cudaGetLastError());
}
