// stage1_tap_gemm: the paper's stage 1 (scalar_prods_kernel) — one GEMM
// per filter tap, (T, P, C) x (T, C, M) -> (T, P, M) fp32 temporaries,
// written to device memory on purpose (the faithful two-stage memory
// behaviour the fused kernel is measured against).
//
// Replaces kernels/cuconv_stage1.py::stage1_tap_gemm of the JAX package.
// It is the tile GEMM of tile_gemm.cuh batched over T on blockIdx.z, so
// what bounds it is what bounds conv1x1_gemm plus the T*P*M*4 bytes of
// temporaries it writes; the design keeps those writes coalesced
// (neighbouring threads on neighbouring output channels).  It keeps the
// reference's (T, P, C) interface: the wrapper stacks the shifted views.
#include "common.cuh"
#include "tile_gemm.cuh"

REPRO_ERROR_STRING_EXPORT

REPRO_EXPORT int stage1_tap_gemm_launch(const void* xs, const void* w,
                                        void* out, int dtype, int T, int P,
                                        int C, int M, int tp, int tm, int tc,
                                        int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_tile_gemm<float, float>(xs, w, out, T, P, C, M, tp, tm,
                                          tc, smem, s);
  if (dtype == kBFloat16)
    return launch_tile_gemm<__nv_bfloat16, float>(xs, w, out, T, P, C, M, tp,
                                                  tm, tc, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
