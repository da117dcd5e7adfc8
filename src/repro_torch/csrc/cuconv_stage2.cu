// stage2_tap_sum: the paper's stage 2 (sum_kernel) — out[i] = sum over
// t of temps[t, i] for the (T, P*M) fp32 stage-1 temporaries.
//
// Replaces kernels/cuconv_stage2.py::stage2_tap_sum of the JAX package.
// One add per element read: bound by device-memory bytes (T*P*M*4 read,
// P*M written).  The design is a flat grid-stride pass in which
// neighbouring threads read neighbouring addresses of each tap plane,
// so every read is a coalesced 128-byte line; the TPU's (tp, tm) block
// tiling has no counterpart here.
#include "common.cuh"

constexpr int kSumThreads = 256;

template <typename TOut>
__global__ void __launch_bounds__(kSumThreads)
stage2_tap_sum_kernel(const float* __restrict__ temps, TOut* __restrict__ out,
                      int T, int64_t PM) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < PM;
       i += step) {
    float s = 0.f;
    for (int t = 0; t < T; ++t) s += temps[t * PM + i];
    out[i] = from_f32<TOut>(s);
  }
}

REPRO_ERROR_STRING_EXPORT

REPRO_EXPORT int stage2_tap_sum_launch(const void* temps, void* out,
                                       int out_dtype, int T, int PM,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t want = ((int64_t)PM + kSumThreads - 1) / kSumThreads;
  const int blocks = static_cast<int>(want < 132 * 32 ? want : 132 * 32);
  if (out_dtype == kFloat32) {
    stage2_tap_sum_kernel<float><<<blocks, kSumThreads, 0, s>>>(
        static_cast<const float*>(temps), static_cast<float*>(out), T, PM);
  } else if (out_dtype == kBFloat16) {
    stage2_tap_sum_kernel<__nv_bfloat16><<<blocks, kSumThreads, 0, s>>>(
        static_cast<const float*>(temps), static_cast<__nv_bfloat16*>(out),
        T, PM);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
