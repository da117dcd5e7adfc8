// winograd_fused: a 3x3 stride-1 convolution by Winograd F(m x m, 3 x 3),
// m in {2, 4}, with the fused epilogue
//   out = act(A^T [sum over c of (B^T d_c B) . U_c] A + bias + addend)
// and one write in the input dtype.  U = G g G^T (fp32, (m+2)^2 x C x M)
// comes in precomputed by the wrapper, once per call.
//
// Replaces kernels/winograd_pallas.py::winograd_fused of the JAX package
// (the Pallas kernel that holds a (R, tt, tc) block of gathered tiles, a
// (R, tc, tm) block of U and an fp32 (R, tt, tm) accumulator in VMEM,
// R = (m+2)^2).  What bounds it on the H100: FFMA issue, fp32 without
// tensor cores — the R per-position GEMMs do 2*R*P*C*M flop (P tiles)
// against a few bytes per input and output element.
//
// Design.  None of the TPU blocks fits a block's 227 KB of shared memory
// (at the reference's plan for resnet_like's b1c1, m=2 and tt=256, the
// gathered d block alone is 256 KB in fp32), so:
//  - One block per (tt tiles, tm output channels); the block walks its
//    region in sub-tiles of ST tiles x MT channels.  Each thread owns PT
//    tiles x 2 channels and holds the R accumulators of each pair in
//    registers (m=2: 2 x 2 pairs x 16; m=4: 1 x 2 pairs x 36).
//  - C runs inside the block in chunks of kKC channels.  Per chunk the
//    block transforms its ST tiles x kKC channels (B^T d B, read straight
//    from the unpadded NHWC input with masks) into shared memory
//    [R][kKC][ST], stages U's [R][kKC][MT] slice beside it, and every
//    thread accumulates its pairs over the R positions.  So the gathered
//    tile tensor the TPU wrapper builds in device memory never exists.
//  - After the last chunk each thread applies A^T m A to its pairs, adds
//    bias then the addend (read from the NHWC addend with masks), applies
//    ReLU and writes its m x m outputs, masked at the ragged edge.
// Shared memory is 4 * R * kKC * (ST + MT) bytes:
// kernels/winograd_fused.py::smem_bytes is that same model, and the
// wrapper launches with what it returns.  The config's tc (the
// reference's contraction tile) has no counterpart here: the whole C loop
// runs inside one block.
#include "common.cuh"

constexpr int kWinoThreads = 256;
constexpr int kKC = 8;  // channels transformed and staged per chunk

// one-dimensional B^T (input) and A^T (output) transforms, spelled out
// (the same matrices as core/winograd.py)
template <int FM>
struct WinoTransform;

template <>
struct WinoTransform<2> {
  static __device__ __forceinline__ void bt(const float* d, float* r) {
    r[0] = d[0] - d[2];
    r[1] = d[1] + d[2];
    r[2] = d[2] - d[1];
    r[3] = d[1] - d[3];
  }
  static __device__ __forceinline__ void at(const float* m, float* y) {
    y[0] = m[0] + m[1] + m[2];
    y[1] = m[1] - m[2] - m[3];
  }
};

template <>
struct WinoTransform<4> {
  static __device__ __forceinline__ void bt(const float* d, float* r) {
    r[0] = 4.f * d[0] - 5.f * d[2] + d[4];
    r[1] = -4.f * d[1] - 4.f * d[2] + d[3] + d[4];
    r[2] = 4.f * d[1] - 4.f * d[2] - d[3] + d[4];
    r[3] = -2.f * d[1] - d[2] + 2.f * d[3] + d[4];
    r[4] = 2.f * d[1] - d[2] - 2.f * d[3] + d[4];
    r[5] = 4.f * d[1] - 5.f * d[3] + d[5];
  }
  static __device__ __forceinline__ void at(const float* m, float* y) {
    y[0] = m[0] + m[1] + m[2] + m[3] + m[4];
    y[1] = m[1] - m[2] + 2.f * (m[3] - m[4]);
    y[2] = m[1] + m[2] + 4.f * (m[3] + m[4]);
    y[3] = m[1] - m[2] + 8.f * (m[3] - m[4]) + m[5];
  }
};

template <typename T, int FM, int MT>
__global__ void __launch_bounds__(kWinoThreads)
winograd_fused_kernel(const T* __restrict__ x, const float* __restrict__ U,
                      const T* __restrict__ bias,
                      const T* __restrict__ addend, T* __restrict__ out,
                      int H, int W, int C, int M, int ph, int pw, int OH,
                      int OW, int TH, int TW, int P, int tt, int tm,
                      int relu) {
  using Tr = WinoTransform<FM>;
  constexpr int A = FM + 2;                 // input-tile edge
  constexpr int R = A * A;                  // Winograd-domain positions
  constexpr int PM = 2;                     // channels per thread
  constexpr int TX = MT / PM;               // threads across channels
  constexpr int TY = kWinoThreads / TX;     // threads across tiles
  constexpr int PT = FM == 2 ? 2 : 1;       // tiles per thread
  constexpr int ST = TY * PT;               // tiles per sub-tile
  extern __shared__ float smem[];
  float* Vs = smem;                         // [R][kKC][ST]
  float* Us = Vs + R * kKC * ST;            // [R][kKC][MT]

  const int p_begin = blockIdx.x * tt;
  const int p_end = min(p_begin + tt, P);
  const int m_begin = blockIdx.y * tm;
  const int m_end = min(m_begin + tm, M);
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int tiles_per_image = TH * TW;

  for (int mt0 = m_begin; mt0 < m_end; mt0 += MT) {
    for (int pt0 = p_begin; pt0 < p_end; pt0 += ST) {
      float acc[PT][PM][R];
#pragma unroll
      for (int i = 0; i < PT; ++i)
#pragma unroll
        for (int j = 0; j < PM; ++j)
#pragma unroll
          for (int r = 0; r < R; ++r) acc[i][j][r] = 0.f;

      for (int c0 = 0; c0 < C; c0 += kKC) {
        // input transform: one (tile, channel) per step; neighbouring
        // threads read neighbouring channels of one tile
        for (int e = tid; e < ST * kKC; e += kWinoThreads) {
          const int cc = e % kKC, s = e / kKC;
          const int p = pt0 + s, c = c0 + cc;
          float d[A][A];
          if (p < p_end && c < C) {
            const int n = p / tiles_per_image;
            const int rem = p - n * tiles_per_image;
            const int th = rem / TW, tw = rem - th * TW;
            const int ih0 = th * FM - ph, iw0 = tw * FM - pw;
            const T* xn = x + (int64_t)n * H * W * C + c;
#pragma unroll
            for (int i = 0; i < A; ++i)
#pragma unroll
              for (int j = 0; j < A; ++j) {
                const int ih = ih0 + i, iw = iw0 + j;
                d[i][j] = (ih >= 0 && ih < H && iw >= 0 && iw < W)
                              ? to_f32(xn[((int64_t)ih * W + iw) * C])
                              : 0.f;
              }
          } else {
#pragma unroll
            for (int i = 0; i < A; ++i)
#pragma unroll
              for (int j = 0; j < A; ++j) d[i][j] = 0.f;
          }
          // B^T d: transform each column, then each row of the result
          float t[A][A], col[A], res[A];
#pragma unroll
          for (int j = 0; j < A; ++j) {
#pragma unroll
            for (int i = 0; i < A; ++i) col[i] = d[i][j];
            Tr::bt(col, res);
#pragma unroll
            for (int i = 0; i < A; ++i) t[i][j] = res[i];
          }
#pragma unroll
          for (int i = 0; i < A; ++i) {
            Tr::bt(t[i], res);
#pragma unroll
            for (int l = 0; l < A; ++l)
              Vs[((i * A + l) * kKC + cc) * ST + s] = res[l];
          }
        }
        // U slice: R x kKC channels x MT output channels
        for (int e = tid; e < R * kKC * MT; e += kWinoThreads) {
          const int mm = e % MT, rest = e / MT;
          const int cc = rest % kKC, r = rest / kKC;
          const int c = c0 + cc, m = mt0 + mm;
          Us[e] = (c < C && m < m_end) ? U[((int64_t)r * C + c) * M + m]
                                       : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int cc = 0; cc < kKC; ++cc) {
            float a[PT], b[PM];
#pragma unroll
            for (int i = 0; i < PT; ++i)
              a[i] = Vs[(r * kKC + cc) * ST + ty + i * TY];
#pragma unroll
            for (int j = 0; j < PM; ++j)
              b[j] = Us[(r * kKC + cc) * MT + tx + j * TX];
#pragma unroll
            for (int i = 0; i < PT; ++i)
#pragma unroll
              for (int j = 0; j < PM; ++j)
                acc[i][j][r] = fmaf(a[i], b[j], acc[i][j][r]);
          }
        }
        __syncthreads();
      }

      // A^T m A, then bias, addend and ReLU in fp32, one write per output
#pragma unroll
      for (int i = 0; i < PT; ++i) {
        const int p = pt0 + ty + i * TY;
        if (p >= p_end) continue;
        const int n = p / tiles_per_image;
        const int rem = p - n * tiles_per_image;
        const int th = rem / TW, tw = rem - th * TW;
#pragma unroll
        for (int j = 0; j < PM; ++j) {
          const int m = mt0 + tx + j * TX;
          if (m >= m_end) continue;
          float t2[FM][A], col[A], res[FM];
#pragma unroll
          for (int l = 0; l < A; ++l) {
#pragma unroll
            for (int k = 0; k < A; ++k) col[k] = acc[i][j][k * A + l];
            Tr::at(col, res);
#pragma unroll
            for (int u = 0; u < FM; ++u) t2[u][l] = res[u];
          }
          const float bv = bias != nullptr ? to_f32(bias[m]) : 0.f;
#pragma unroll
          for (int u = 0; u < FM; ++u) {
            Tr::at(t2[u], res);
            const int oh = th * FM + u;
            if (oh >= OH) continue;
#pragma unroll
            for (int v = 0; v < FM; ++v) {
              const int ow = tw * FM + v;
              if (ow >= OW) continue;
              const int64_t o = (((int64_t)n * OH + oh) * OW + ow) * M + m;
              float y = res[v] + bv;
              if (addend != nullptr) y += to_f32(addend[o]);
              if (relu) y = fmaxf(y, 0.f);
              out[o] = from_f32<T>(y);
            }
          }
        }
      }
    }
  }
}

template <typename T, int FM, int MT>
static int launch_wino(const void* x, const float* U, const void* bias,
                       const void* addend, void* out, int N, int H, int W,
                       int C, int M, int ph, int pw, int OH, int OW, int tt,
                       int tm, int relu, int smem, cudaStream_t stream) {
  auto kernel = winograd_fused_kernel<T, FM, MT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int TH = (OH + FM - 1) / FM, TW = (OW + FM - 1) / FM;
  const int P = N * TH * TW;
  dim3 grid((P + tt - 1) / tt, (M + tm - 1) / tm);
  kernel<<<grid, kWinoThreads, smem, stream>>>(
      static_cast<const T*>(x), U, static_cast<const T*>(bias),
      static_cast<const T*>(addend), static_cast<T*>(out), H, W, C, M, ph,
      pw, OH, OW, TH, TW, P, tt, tm, relu);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_wino_variant(const void* x, const float* U,
                               const void* bias, const void* addend,
                               void* out, int N, int H, int W, int C, int M,
                               int ph, int pw, int OH, int OW, int fm, int tt,
                               int tm, int relu, int smem, cudaStream_t s) {
  // the channel sub-tile MT follows tm (kernels/winograd_fused.py mirrors it)
  if (fm == 2 && tm <= 16)
    return launch_wino<T, 2, 16>(x, U, bias, addend, out, N, H, W, C, M, ph,
                                 pw, OH, OW, tt, tm, relu, smem, s);
  if (fm == 2)
    return launch_wino<T, 2, 32>(x, U, bias, addend, out, N, H, W, C, M, ph,
                                 pw, OH, OW, tt, tm, relu, smem, s);
  if (fm == 4 && tm <= 16)
    return launch_wino<T, 4, 16>(x, U, bias, addend, out, N, H, W, C, M, ph,
                                 pw, OH, OW, tt, tm, relu, smem, s);
  if (fm == 4)
    return launch_wino<T, 4, 32>(x, U, bias, addend, out, N, H, W, C, M, ph,
                                 pw, OH, OW, tt, tm, relu, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

REPRO_ERROR_STRING_EXPORT

REPRO_EXPORT int winograd_fused_launch(
    const void* x, const void* U, const void* bias, const void* addend,
    void* out, int dtype, int N, int H, int W, int C, int M, int ph, int pw,
    int OH, int OW, int fm, int tt, int tm, int relu, int smem,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* u = static_cast<const float*>(U);
  if (dtype == kFloat32)
    return launch_wino_variant<float>(x, u, bias, addend, out, N, H, W, C, M,
                                      ph, pw, OH, OW, fm, tt, tm, relu, smem,
                                      s);
  if (dtype == kBFloat16)
    return launch_wino_variant<__nv_bfloat16>(x, u, bias, addend, out, N, H,
                                              W, C, M, ph, pw, OH, OW, fm, tt,
                                              tm, relu, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
