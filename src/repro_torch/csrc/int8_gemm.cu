// int8_gemm: the raw int32 accumulator of an int8 x int8 GEMM,
//   out (P x M, int32) = x2d (P x K, int8) @ w (K x M, int8).
// Dequantization is the cuconv_int8 executor's epilogue, not this
// kernel's: one kernel serves every scale layout.
//
// Replaces kernels/int8_gemm.py::int8_gemm of the JAX package (the Pallas
// GEMM that drives the MXU's integer path into an int32 VMEM
// accumulator).  What bounds it on the H100: at the int8 resnet_like
// nodes (P = N*OH*OW up to a few thousand, K = 9*C of 144 or 288, M of 16
// or 32) the bytes — one byte per input element, four per output — and,
// at these sizes, the launch; the int8 tensor cores (1,979 TOP/s) would
// be the ceiling of a later design.
//
// Design.  A tiled GEMM with integer arithmetic: one block per
// (tp pixels, tm channels), walking its region in 64 x 64 sub-tiles; 256
// threads hold a 4 x 4 int32 accumulator each.  The contraction runs in
// chunks of tc int8 values, staged as 32-bit words that pack four
// consecutive k of one row of x (stored transposed, one pad column) or
// of one column of w, so each __dp4a multiplies and sums four int8 pairs
// into an int32.  Products of codes in [-127, 127] are exact and sums of
// fewer than 2^31 / 127^2 (133,000) of them cannot overflow, so the
// result equals the plain version bit for bit.  Ragged edges (P, M, and
// K not a multiple of 4 or of tc) are zero on load, which is exact under
// symmetric quantization.  Shared memory is 4 * ceil(tc/4) * (64 + 1 +
// 64) bytes: kernels/int8_gemm.py::smem_bytes is that same model.
#include "common.cuh"

constexpr int kI8Threads = 256;
constexpr int kI8Sub = 64;            // sub-tile edge (pixels and channels)
constexpr int kI8AStride = kI8Sub + 1;

__global__ void __launch_bounds__(kI8Threads)
int8_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 int32_t* __restrict__ out, int P, int K, int M, int tp,
                 int tm, int tc) {
  extern __shared__ int words[];
  const int tcw = (tc + 3) / 4;                // words per staged chunk
  int* As = words;                             // [tcw][64 + 1], x packed
  int* Bs = words + tcw * kI8AStride;          // [tcw][64], w packed
  const int p_begin = blockIdx.x * tp;
  const int p_end = min(p_begin + tp, P);
  const int m_begin = blockIdx.y * tm;
  const int m_end = min(m_begin + tm, M);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  for (int p0 = p_begin; p0 < p_end; p0 += kI8Sub) {
    for (int m0 = m_begin; m0 < m_end; m0 += kI8Sub) {
      int acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0;
      for (int k0 = 0; k0 < K; k0 += tc) {
        const int k_end = min(k0 + tc, K);
        const int nw = (k_end - k0 + 3) / 4;
        // x: four consecutive k of one row per word, byte b = k0 + 4kw + b
        for (int e = tid; e < kI8Sub * nw; e += kI8Threads) {
          const int kw = e % nw, p = e / nw;
          const int gp = p0 + p;
          uint32_t v = 0;
          if (gp < p_end) {
            const int8_t* row = x + (int64_t)gp * K;
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const int k = k0 + 4 * kw + b;
              if (k < k_end) v |= (uint32_t)(uint8_t)row[k] << (8 * b);
            }
          }
          As[kw * kI8AStride + p] = (int)v;
        }
        // w: four consecutive k of one column per word
        for (int e = tid; e < nw * kI8Sub; e += kI8Threads) {
          const int n = e % kI8Sub, kw = e / kI8Sub;
          const int gm = m0 + n;
          uint32_t v = 0;
          if (gm < m_end) {
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const int k = k0 + 4 * kw + b;
              if (k < k_end)
                v |= (uint32_t)(uint8_t)w[(int64_t)k * M + gm] << (8 * b);
            }
          }
          Bs[kw * kI8Sub + n] = (int)v;
        }
        __syncthreads();
        for (int kw = 0; kw < nw; ++kw) {
          int a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = As[kw * kI8AStride + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = Bs[kw * kI8Sub + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
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
          if (gm < m_end) out[(int64_t)gp * M + gm] = acc[i][j];
        }
      }
    }
  }
}

REPRO_ERROR_STRING_EXPORT

REPRO_EXPORT int int8_gemm_launch(const void* x2d, const void* w, void* out,
                                  int P, int K, int M, int tp, int tm, int tc,
                                  int smem, void* stream) {
  cudaError_t err = allow_smem(int8_gemm_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((P + tp - 1) / tp, (M + tm - 1) / tm);
  int8_gemm_kernel<<<grid, kI8Threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x2d), static_cast<const int8_t*>(w),
      static_cast<int32_t*>(out), P, K, M, tp, tm, tc);
  return static_cast<int>(cudaGetLastError());
}
