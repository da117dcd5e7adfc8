// conv1x1_gemm: a 1x1 convolution as the GEMM (P x C) @ (C x M), fp32
// accumulation, written in the input dtype.
//
// Replaces kernels/conv1x1.py::conv1x1_gemm of the JAX package (the
// Pallas MXU-tiled GEMM).  What bounds it on the H100: at the paper's
// shapes (21-103 MFLOP, P down to 49) the tensor cores' rate for the
// 3xTF32 product (495/3 TFLOP/s) against under 2 MB of operands, so the
// bound is a few microseconds and what decides the time is how many
// blocks are in flight and how well loads overlap the math.  Design:
//  - The block tile belongs to the kernel: BM = 64 or 32 pixel rows x
//    BN = 64 channels from 4 warps (2 x 2), each warp 2 or 1 16-row x
//    4 8-column mma tiles.  kernels/conv1x1.py::launch_geometry picks it,
//    and the number of contraction splits, from (P, C, M) alone; the
//    reference's tp/tm/tc do not size anything here.
//  - Where the output tiles alone are fewer than the card's 132 SMs, the
//    contraction over C is split across blocks (blockIdx.z) in fixed
//    ranges of 32-deep steps (splitk.cuh, shared with cuconv_fused): the
//    last block of a tile to arrive sums the fp32 partials in split
//    order, so two calls give the same bits.  The wrapper allocates
//    workspace and counters.
//  - fp32: mma.sync m16n8k8 on TF32 in the 3xTF32 split (mma_tf32.cuh).
//    bf16: mma.sync m16n8k16 on bf16.  fp32 accumulation in registers,
//    one rounding on the write.
//  - A 3-stage ring of 32-deep A (BM x 32) and B (32 x BN) tiles in
//    shared memory, filled by 16-byte cp.async (zero-fill past the edges)
//    while the tensor cores work on an earlier stage.  A rows are padded
//    by 16 bytes and B rows by 8 elements, so fragment loads hit 32
//    distinct banks.  Where C or M is not a multiple of 16 bytes, or a
//    base pointer is not 16-byte aligned, the same ring is filled by
//    masked scalar loads instead (vec = 0).
#include "common.cuh"
#include "mma_tf32.cuh"
#include "splitk.cuh"

constexpr int kThreads = 128;  // 4 warps, 2 x 2
constexpr int kBK = 32;        // contraction depth per stage
constexpr int kStages = 3;
constexpr int kBN = 64;

// kernels/conv1x1.py::launch_geometry models the same shared memory
template <typename T, int MI>
struct Tile {
  static constexpr int BM = 32 * MI, BN = kBN;
  static constexpr int LDA = kBK + RingPad<T>::A, LDB = BN + RingPad<T>::B;
  static constexpr int A_ELEMS = BM * LDA, B_ELEMS = kBK * LDB;
  static constexpr int SMEM = kStages * (A_ELEMS + B_ELEMS) * sizeof(T);
};

template <typename T, int MI>
__device__ __forceinline__ void load_stage(T* As, T* Bs,
                                           const T* __restrict__ A,
                                           const T* __restrict__ B, int P,
                                           int C, int M, int p0, int n0,
                                           int k0, int k_end, bool vec,
                                           int tid) {
  using L = Tile<T, MI>;
  constexpr int V = VecOf<T>::kElems;
  if (vec) {
    for (int e = tid; e < L::BM * kBK / V; e += kThreads) {
      const int r = e / (kBK / V), cc = (e % (kBK / V)) * V;
      const int p = p0 + r, k = k0 + cc;
      const bool ok = p < P && k < k_end;
      cp_async16(As + r * L::LDA + cc, ok ? A + (int64_t)p * C + k : A, ok);
    }
    for (int e = tid; e < kBK * L::BN / V; e += kThreads) {
      const int r = e / (L::BN / V), cc = (e % (L::BN / V)) * V;
      const int k = k0 + r, n = n0 + cc;
      const bool ok = k < k_end && n < M;
      cp_async16(Bs + r * L::LDB + cc, ok ? B + (int64_t)k * M + n : B, ok);
    }
  } else {
    for (int e = tid; e < L::BM * kBK; e += kThreads) {
      const int r = e / kBK, cc = e % kBK;
      const int p = p0 + r, k = k0 + cc;
      As[r * L::LDA + cc] =
          (p < P && k < k_end) ? A[(int64_t)p * C + k] : from_f32<T>(0.f);
    }
    for (int e = tid; e < kBK * L::BN; e += kThreads) {
      const int r = e / L::BN, cc = e % L::BN;
      const int k = k0 + r, n = n0 + cc;
      Bs[r * L::LDB + cc] =
          (k < k_end && n < M) ? B[(int64_t)k * M + n] : from_f32<T>(0.f);
    }
  }
}

template <typename T, int MI>
__global__ void __launch_bounds__(kThreads)
conv1x1_tc_kernel(const T* __restrict__ A, const T* __restrict__ B,
                  T* __restrict__ out, float* __restrict__ ws,
                  int* __restrict__ counters, int P, int C, int M,
                  int splits, int vec) {
  using L = Tile<T, MI>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);
  T* Bs = As + kStages * L::A_ELEMS;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int row0 = (warp >> 1) * 16 * MI, col0 = (warp & 1) * 32;
  const int p0 = blockIdx.x * L::BM, n0 = blockIdx.y * L::BN;
  const int z = blockIdx.z;
  // this split's fixed range of 32-deep steps
  const int k_steps = (C + kBK - 1) / kBK;
  int s_begin, s_end;
  split_steps(z, splits, k_steps, s_begin, s_end);
  const int nk = s_end - s_begin;
  const int k_end = min(s_end * kBK, C);

  float acc[MI][4][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      load_stage<T, MI>(As + s * L::A_ELEMS, Bs + s * L::B_ELEMS, A, B, P, C,
                        M, p0, n0, (s_begin + s) * kBK, k_end, vec, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 is free again
    const int nxt = kt + kStages - 1;
    if (nxt < nk) {
      const int slot = nxt % kStages;
      load_stage<T, MI>(As + slot * L::A_ELEMS, Bs + slot * L::B_ELEMS, A, B,
                        P, C, M, p0, n0, (s_begin + nxt) * kBK, k_end, vec,
                        tid);
    }
    cp_async_commit();
    const int slot = kt % kStages;
    warp_mma_stage<MI, 4, L::LDA, L::LDB, kBK>(
        acc, As + slot * L::A_ELEMS, Bs + slot * L::B_ELEMS, row0, col0, g,
        t);
  }
  cp_async_wait<0>();

  // this lane's accumulator (mi, ni, q) sits at row/column:
  //   p0 + row0 + mi*16 + g + 8*(q/2),  n0 + col0 + ni*8 + 2t + q%2
  float* dst = splits == 1 ? nullptr : ws + (int64_t)z * P * M;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = p0 + row0 + mi * 16 + g + 8 * (q >> 1);
        const int n = n0 + col0 + ni * 8 + 2 * t + (q & 1);
        if (p >= P || n >= M) continue;
        if (dst == nullptr)
          out[(int64_t)p * M + n] = from_f32<T>(acc[mi][ni][q]);
        else
          dst[(int64_t)p * M + n] = acc[mi][ni][q];
      }
  if (splits == 1) return;

  // split-K: the last block of this tile sums the partials in split order
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (!split_arrive_last(counters, tile, splits)) return;
  constexpr int PER = L::BM * L::BN / kThreads;
  int off[PER];
  float sum[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = tid + i * kThreads;
    const int p = p0 + e / L::BN, n = n0 + e % L::BN;
    off[i] = p < P && n < M ? p * M + n : -1;
  }
  split_sum<PER>(ws, P * M, splits, off, sum);
#pragma unroll
  for (int i = 0; i < PER; ++i)
    if (off[i] >= 0) out[off[i]] = from_f32<T>(sum[i]);
  split_reset(counters, tile);
}

template <typename T, int MI>
static int launch(const void* A, const void* B, void* out, void* ws,
                  void* counters, int P, int C, int M, int splits, int vec,
                  int smem, cudaStream_t stream) {
  using L = Tile<T, MI>;
  constexpr int V = VecOf<T>::kElems;
  const int k_steps = (C + kBK - 1) / kBK;
  const bool aligned = C % V == 0 && M % V == 0 &&
                       reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(B) % 16 == 0;
  // the split reduction indexes the workspace with ints
  const bool ws_ok = splits == 1 || (ws != nullptr && counters != nullptr &&
                                     (int64_t)splits * P * M <= INT32_MAX);
  if (smem != L::SMEM || splits < 1 || splits > k_steps || !ws_ok ||
      (vec && !aligned))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = conv1x1_tc_kernel<T, MI>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((P + L::BM - 1) / L::BM, (M + L::BN - 1) / L::BN, splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(B), static_cast<T*>(out),
      static_cast<float*>(ws), static_cast<int*>(counters), P, C, M, splits,
      vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_tile(const void* A, const void* B, void* out, void* ws,
                       void* counters, int P, int C, int M, int bm,
                       int splits, int vec, int smem, cudaStream_t s) {
  if (bm == 64)
    return launch<T, 2>(A, B, out, ws, counters, P, C, M, splits, vec, smem,
                        s);
  if (bm == 32)
    return launch<T, 1>(A, B, out, ws, counters, P, C, M, splits, vec, smem,
                        s);
  return static_cast<int>(cudaErrorInvalidValue);
}

REPRO_ERROR_STRING_EXPORT

REPRO_EXPORT int conv1x1_gemm_launch(const void* x2d, const void* w,
                                     void* out, void* ws, void* counters,
                                     int dtype, int P, int C, int M, int bm,
                                     int splits, int vec, int smem,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_tile<float>(x2d, w, out, ws, counters, P, C, M, bm, splits,
                              vec, smem, s);
  if (dtype == kBFloat16)
    return launch_tile<__nv_bfloat16>(x2d, w, out, ws, counters, P, C, M, bm,
                                      splits, vec, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
