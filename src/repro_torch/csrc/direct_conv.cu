// direct_conv: an im2col-free direct convolution, any stride, no epilogue:
//   out[n, oh, ow, m] = sum over (di, dj, c) of
//                       x[n, oh*sh - ph + di, ow*sw - pw + dj, c] * w[di, dj, c, m]
// accumulated in fp32, one write in the input dtype.
//
// Replaces kernels/direct_conv.py::direct_conv of the JAX package (the
// Pallas kernel whose grid step stages one image's whole padded extent
// for a tc-channel slice and the matching (KH, KW, tc, tm) filter block
// in VMEM, with an fp32 accumulator across the sequential channel axis).
// What bounds it on the H100: FFMA issue, fp32 without tensor cores (the
// paper's t4_B: 2*169*384*3456 flop, 449 MFLOP over 67 TFLOP/s, against
// 1.1 MB of operands over 3.35 TB/s).
//
// Design.  A whole 224x224 image per block does not fit 227 KB of shared
// memory, so the block tiles space as well: one block per (THD x TWD
// output pixels, tm output channels, image), walking tm in sub-tiles of
// MT channels.  Per chunk of kKC input channels the block stages the
// input halo its pixels read — ((THD-1)*sh + KH) x ((TWD-1)*sw + KW) x
// kKC, read with masks from the unpadded NHWC input, so padding costs no
// copy — and the (KH*KW, kKC, MT) filter slice; every thread then runs
// all KH*KW taps of the chunk out of shared memory into a 4 pixels x 4
// channels fp32 register tile.  Each staged input element is so reused by
// up to KH*KW taps and MT channels, where cuconv_fused re-reads the input
// from device memory per (tap, channel) pair: that reuse is what the
// direct formulation buys.  Shared memory is
//   4 * kKC * (IH_T * IW_T + KH * KW * MT)
// bytes: kernels/direct_conv.py::smem_bytes is that same model, and the
// wrapper launches with what it returns.  The config's tc (the
// reference's channel slice) has no counterpart here: the whole C loop
// runs inside one block.
#include "common.cuh"

constexpr int kDirectThreads = 256;
constexpr int kKC = 8;  // input channels staged per chunk

template <typename T, int MT>
__global__ void __launch_bounds__(kDirectThreads)
direct_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ out, int H, int W, int C, int KH, int KW,
                   int M, int sh, int sw, int ph, int pw, int OH, int OW,
                   int tiles_w, int tm) {
  constexpr int TX = MT / 4;                      // threads across channels
  constexpr int TY = kDirectThreads / TX;         // threads across pixels
  constexpr int PIX = 4 * TY;                     // output pixels per block
  constexpr int TWD = PIX >= 128 ? 16 : 8;        // tile width
  constexpr int THD = PIX / TWD;                  // tile height
  const int IHT = (THD - 1) * sh + KH;            // input halo rows
  const int IWT = (TWD - 1) * sw + KW;            // input halo columns
  const int halo = IHT * IWT;
  const int taps = KH * KW;
  extern __shared__ float smem[];
  float* Xs = smem;                               // [kKC][IHT][IWT]
  float* Ws = Xs + kKC * halo;                    // [KH*KW][kKC][MT]

  const int n = blockIdx.z;
  const int oh0 = (blockIdx.x / tiles_w) * THD;
  const int ow0 = (blockIdx.x % tiles_w) * TWD;
  const int ih_base = oh0 * sh - ph, iw_base = ow0 * sw - pw;
  const int m_begin = blockIdx.y * tm;
  const int m_end = min(m_begin + tm, M);
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const T* xn = x + (int64_t)n * H * W * C;

  // the halo offset of each of this thread's 4 pixels
  int off[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = ty + i * TY;
    off[i] = (q / TWD) * sh * IWT + (q % TWD) * sw;
  }

  for (int mt0 = m_begin; mt0 < m_end; mt0 += MT) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int c0 = 0; c0 < C; c0 += kKC) {
      // input halo: neighbouring threads read neighbouring channels
      for (int e = tid; e < kKC * halo; e += kDirectThreads) {
        const int cc = e % kKC, pos = e / kKC;
        const int ii = pos / IWT, jj = pos - ii * IWT;
        const int ih = ih_base + ii, iw = iw_base + jj, c = c0 + cc;
        float v = 0.f;
        if (c < C && ih >= 0 && ih < H && iw >= 0 && iw < W)
          v = to_f32(xn[((int64_t)ih * W + iw) * C + c]);
        Xs[cc * halo + pos] = v;
      }
      // filter slice: HWIO rows (tap, c0..c0+kKC), channels mt0..mt0+MT
      for (int e = tid; e < taps * kKC * MT; e += kDirectThreads) {
        const int mm = e % MT, rest = e / MT;
        const int cc = rest % kKC, tap = rest / kKC;
        const int c = c0 + cc, m = mt0 + mm;
        Ws[e] = (c < C && m < m_end)
                    ? to_f32(w[((int64_t)tap * C + c) * M + m])
                    : 0.f;
      }
      __syncthreads();
      for (int cc = 0; cc < kKC; ++cc) {
        const float* xc = Xs + cc * halo;
        for (int di = 0; di < KH; ++di) {
          for (int dj = 0; dj < KW; ++dj) {
            const float* wt = Ws + ((di * KW + dj) * kKC + cc) * MT;
            const int d = di * IWT + dj;
            float a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = xc[off[i] + d];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = wt[tx + j * TX];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
          }
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = ty + i * TY;
      const int oh = oh0 + q / TWD, ow = ow0 + q % TWD;
      if (oh >= OH || ow >= OW) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = mt0 + tx + j * TX;
        if (m < m_end)
          out[(((int64_t)n * OH + oh) * OW + ow) * M + m] =
              from_f32<T>(acc[i][j]);
      }
    }
  }
}

template <typename T, int MT>
static int launch_direct(const void* x, const void* w, void* out, int N,
                         int H, int W, int C, int KH, int KW, int M, int sh,
                         int sw, int ph, int pw, int OH, int OW, int tm,
                         int smem, cudaStream_t stream) {
  constexpr int PIX = 4 * (kDirectThreads / (MT / 4));
  constexpr int TWD = PIX >= 128 ? 16 : 8;
  constexpr int THD = PIX / TWD;
  auto kernel = direct_conv_kernel<T, MT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_h = (OH + THD - 1) / THD, tiles_w = (OW + TWD - 1) / TWD;
  dim3 grid(tiles_h * tiles_w, (M + tm - 1) / tm, N);
  kernel<<<grid, kDirectThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), H, W, C, KH, KW, M, sh, sw, ph, pw, OH, OW,
      tiles_w, tm);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_direct_mt(const void* x, const void* w, void* out, int N,
                            int H, int W, int C, int KH, int KW, int M,
                            int sh, int sw, int ph, int pw, int OH, int OW,
                            int tm, int smem, cudaStream_t s) {
  // the channel sub-tile MT follows tm (kernels/direct_conv.py mirrors it)
  if (tm <= 16)
    return launch_direct<T, 16>(x, w, out, N, H, W, C, KH, KW, M, sh, sw, ph,
                                pw, OH, OW, tm, smem, s);
  if (tm <= 32)
    return launch_direct<T, 32>(x, w, out, N, H, W, C, KH, KW, M, sh, sw, ph,
                                pw, OH, OW, tm, smem, s);
  return launch_direct<T, 64>(x, w, out, N, H, W, C, KH, KW, M, sh, sw, ph,
                              pw, OH, OW, tm, smem, s);
}

REPRO_ERROR_STRING_EXPORT

REPRO_EXPORT int direct_conv_launch(const void* x, const void* w, void* out,
                                    int dtype, int N, int H, int W, int C,
                                    int KH, int KW, int M, int sh, int sw,
                                    int ph, int pw, int OH, int OW, int tm,
                                    int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_direct_mt<float>(x, w, out, N, H, W, C, KH, KW, M, sh, sw,
                                   ph, pw, OH, OW, tm, smem, s);
  if (dtype == kBFloat16)
    return launch_direct_mt<__nv_bfloat16>(x, w, out, N, H, W, C, KH, KW, M,
                                           sh, sw, ph, pw, OH, OW, tm, smem,
                                           s);
  return static_cast<int>(cudaErrorInvalidValue);
}
