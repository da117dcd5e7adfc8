// conv1x1_gemm: a 1x1 convolution as the GEMM (P x C) @ (C x M).
//
// Replaces kernels/conv1x1.py::conv1x1_gemm of the JAX package (the
// Pallas MXU-tiled GEMM).  On the H100 in fp32 without tensor cores it
// is bound by operations at the paper's shapes (t3_A: 2*49*832*256 flop
// over 67 TFLOP/s against 0.9 MB over 3.35 TB/s), so the design keeps
// every operand in shared memory for a 4 x 4 register micro-tile per
// thread (16 FFMA per 8 shared loads) and reads each input element from
// device memory once per 64-channel sub-tile.  The TPU wrapper's
// jnp.pad copies to tile multiples become load masks (tile_gemm.cuh).
#include "common.cuh"
#include "tile_gemm.cuh"

REPRO_ERROR_STRING_EXPORT

REPRO_EXPORT int conv1x1_gemm_launch(const void* x2d, const void* w,
                                     void* out, int dtype, int P, int C,
                                     int M, int tp, int tm, int tc, int smem,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_tile_gemm<float, float>(x2d, w, out, 1, P, C, M, tp, tm,
                                          tc, smem, s);
  if (dtype == kBFloat16)
    return launch_tile_gemm<__nv_bfloat16, __nv_bfloat16>(
        x2d, w, out, 1, P, C, M, tp, tm, tc, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
