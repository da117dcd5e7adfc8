// Shared helpers of the repro_torch CUDA kernels: dtype conversion
// through the intrinsics only, and the error-string export every
// library carries.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

// dtype codes of the C interface (kernels/_build.py DTYPE_CODES)
enum ReproDtype { kFloat32 = 0, kBFloat16 = 1 };

template <typename T>
__device__ __forceinline__ float to_f32(T v);

template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }

template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);

template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// Blocks above 48 KB of dynamic shared memory must opt in per kernel.
template <typename K>
static cudaError_t allow_smem(K kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

#define REPRO_ERROR_STRING_EXPORT                              \
  REPRO_EXPORT const char* repro_cuda_error_string(int code) { \
    return cudaGetErrorString(static_cast<cudaError_t>(code)); \
  }
