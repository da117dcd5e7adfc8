// conv1d_tap: causal depthwise conv1d with the bias fused,
//   y[b, l, d] = sum_k x[b, l - K + 1 + k, d] * w[k, d] + bias[d],
// summed in fp32 and written once in x's dtype; x positions before 0 are
// zero (the causal left padding).
//
// Replaces kernels/conv1d_tap.py::conv1d_tap of the JAX package (the
// Pallas kernel that accumulates K shifted views of a stacked (K, B*L, D)
// copy of x into a VMEM fp32 tile, the tap axis innermost).  Here the
// bias is added in fp32 before the single write, which is what the
// Mamba2 block's causal_conv1d computes (nn/mamba.py); the TPU wrapper
// adds it after its cast instead, one bf16 rounding apart.
//
// What bounds it on the H100: bytes.  Each output element costs K FMAs
// against one input and one output element, so at the Mamba2 streams
// ((4, 512, 4096) and (4, 512, 128), K = 4) it does 1 FLOP per byte in
// fp32 (2 in bf16): far below the 20 FLOP/byte (fp32 at 67 TFLOP/s over
// 3.35 TB/s) at which arithmetic would bind.
//
// Design.  No shifted copy of x exists: each thread owns one channel d
// of one sequence b and walks a run of kC1dRun positions of l, keeping the
// K-wide window of x in registers, so every x element is read from
// device memory once per run (plus the K - 1 halo positions before the
// run, masked to zero before l = 0).  Neighbouring threads take
// neighbouring channels, so each warp's loads and stores of one position
// are contiguous.  w and bias (K + 1 values per channel) sit in
// registers.  Nothing is staged in shared memory.
#include "common.cuh"

constexpr int kC1dThreads = 128;   // channels per block
constexpr int kC1dRun = 32;        // positions of l per thread

template <typename T, int K>
__global__ void __launch_bounds__(kC1dThreads)
conv1d_tap_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const T* __restrict__ bias, T* __restrict__ y, int L,
                  int D) {
  const int d = blockIdx.x * kC1dThreads + threadIdx.x;
  if (d >= D) return;
  const int l0 = blockIdx.y * kC1dRun;
  const int b = blockIdx.z;
  const int64_t base = (int64_t)b * L * D + d;
  float wk[K];
#pragma unroll
  for (int k = 0; k < K; ++k) wk[k] = to_f32(w[(int64_t)k * D + d]);
  const float bd = bias != nullptr ? to_f32(bias[d]) : 0.0f;
  // win[k] holds x at l - K + 1 + k for the next output position l
  float win[K];
#pragma unroll
  for (int k = 0; k < K - 1; ++k) {
    const int l = l0 - (K - 1) + k;
    win[k + 1] = l >= 0 ? to_f32(x[base + (int64_t)l * D]) : 0.0f;
  }
  const int l_end = min(l0 + kC1dRun, L);
  for (int l = l0; l < l_end; ++l) {
#pragma unroll
    for (int k = 0; k < K - 1; ++k) win[k] = win[k + 1];
    win[K - 1] = to_f32(x[base + (int64_t)l * D]);
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) acc = fmaf(win[k], wk[k], acc);
    y[base + (int64_t)l * D] = from_f32<T>(acc + bd);
  }
}

template <typename T, int K>
static int launch(const void* x, const void* w, const void* bias, void* y,
                  int B, int L, int D, cudaStream_t stream) {
  dim3 grid((D + kC1dThreads - 1) / kC1dThreads,
            (L + kC1dRun - 1) / kC1dRun, B);
  conv1d_tap_kernel<T, K><<<grid, kC1dThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<T*>(y), L, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_taps(const void* x, const void* w, const void* bias,
                       void* y, int B, int L, int D, int K,
                       cudaStream_t stream) {
  switch (K) {
    case 1: return launch<T, 1>(x, w, bias, y, B, L, D, stream);
    case 2: return launch<T, 2>(x, w, bias, y, B, L, D, stream);
    case 3: return launch<T, 3>(x, w, bias, y, B, L, D, stream);
    case 4: return launch<T, 4>(x, w, bias, y, B, L, D, stream);
    case 5: return launch<T, 5>(x, w, bias, y, B, L, D, stream);
    case 6: return launch<T, 6>(x, w, bias, y, B, L, D, stream);
    case 7: return launch<T, 7>(x, w, bias, y, B, L, D, stream);
    case 8: return launch<T, 8>(x, w, bias, y, B, L, D, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

REPRO_ERROR_STRING_EXPORT

REPRO_EXPORT int conv1d_tap_launch(const void* x, const void* w,
                                   const void* bias, void* y, int dtype,
                                   int B, int L, int D, int K,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return launch_taps<__nv_bfloat16>(x, w, bias, y, B, L, D, K, s);
  return launch_taps<float>(x, w, bias, y, B, L, D, K, s);
}
