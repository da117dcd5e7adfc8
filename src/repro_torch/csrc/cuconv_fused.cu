// cuconv_fused: both cuConv stages in one kernel, with the fused epilogue
//   out = act(sum over taps of X_shift(t) . W[t] + bias + addend)
// or a non-overlapping max/avg pool of act(... + bias), one write in the
// input dtype.
//
// Replaces kernels/cuconv_fused.py::cuconv_fused of the JAX package (the
// Pallas kernel whose tap axis revisits a VMEM-resident output block).
// What bounds it on the H100: FFMA issue in fp32 without tensor cores —
// at the paper's rows (t4_A: 2*49*384*1728 flop, 65 MFLOP, over 67
// TFLOP/s) the operations outweigh the bytes — and, at resnet_like's
// narrow widths, too few blocks to fill 132 SMs.
//
// Design.  One block per (tm output channels, `rows` output rows, image).
// The TPU grid's sequential tap revisits become a loop inside the block:
// the contraction runs over k = (tap, channel), flattened in HWIO order
// so the filter tile is a contiguous slice of w, in chunks of kKC, with
// the accumulator in registers (4 x 4 fp32 per thread).  The block walks
// its rows x OW x tm region in sub-tiles of PT pixels x MT channels
// (MT = 16, 32 or 64 by tm, so narrow layers keep all 256 threads busy).
// Inputs are read straight from the unpadded NHWC tensor: a tap that
// lands in the padding is masked to zero, and so are ragged channel and
// pixel edges, where the TPU wrapper padded x, w and the addend in
// device memory and sliced the output.  Small C (the stem's C = 3) does
// not waste a chunk because the chunk runs across taps.  The epilogue
// runs in fp32: bias, then the addend, then ReLU; under a pool the
// finished values of one channel sub-tile go to shared memory
// ([rows * OW][MT] fp32) and are pooled from there before the write.
// Shared memory is therefore 4 * (kKC * (PT + 1) + kKC * MT) bytes, plus
// 4 * rows * OW * MT under a pool: kernels/cuconv_fused.py::smem_bytes
// is that same model, and the wrapper launches with what it returns.
#include <math.h>

#include "common.cuh"

constexpr int kFusedThreads = 256;
constexpr int kKC = 16;  // (tap, channel) pairs staged per step

template <typename T, int MT>
__global__ void __launch_bounds__(kFusedThreads)
cuconv_fused_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const T* __restrict__ bias, const T* __restrict__ addend,
                    T* __restrict__ out, int H, int W, int C, int KH, int KW,
                    int M, int sh, int sw, int ph, int pw, int OH, int OW,
                    int tm, int rows, int relu, int pool_kind, int psh,
                    int psw) {
  constexpr int TX = MT / 4;                 // threads across channels
  constexpr int TY = kFusedThreads / TX;     // threads across pixels
  constexpr int PT = 4 * TY;                 // pixels per sub-tile
  constexpr int XS = PT + 1;                 // padded row of the input tile
  extern __shared__ float smem[];
  float* Xs = smem;                          // [kKC][PT + 1]
  float* Ws = Xs + kKC * XS;                 // [kKC][MT]
  float* Rs = Ws + kKC * MT;                 // pool only: [rows * OW][MT]

  const int n = blockIdx.z;
  const int oh0 = blockIdx.y * rows;
  const int m_begin = blockIdx.x * tm;
  const int m_end = min(m_begin + tm, M);
  const int rows_here = min(rows, OH - oh0);
  const int RP = rows_here * OW;             // output pixels of the block
  const int K = KH * KW * C;
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const T* xn = x + (int64_t)n * H * W * C;

  for (int mt0 = m_begin; mt0 < m_end; mt0 += MT) {
    for (int pt0 = 0; pt0 < RP; pt0 += PT) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

      for (int k0 = 0; k0 < K; k0 += kKC) {
        // input tile: kKC (tap, channel) pairs x PT output pixels;
        // neighbouring threads read neighbouring channels of one tap
        for (int e = tid; e < kKC * PT; e += kFusedThreads) {
          const int kk = e % kKC, p = e / kKC;
          const int k = k0 + kk, q = pt0 + p;
          float v = 0.f;
          if (k < K && q < RP) {
            const int tap = k / C, c = k - tap * C;
            const int di = tap / KW, dj = tap - di * KW;
            const int r = q / OW, ow = q - r * OW;
            const int ih = (oh0 + r) * sh - ph + di;
            const int iw = ow * sw - pw + dj;
            if (ih >= 0 && ih < H && iw >= 0 && iw < W)
              v = to_f32(xn[((int64_t)ih * W + iw) * C + c]);
          }
          Xs[kk * XS + p] = v;
        }
        // filter tile: HWIO rows k0..k0+kKC, channels mt0..mt0+MT
        for (int e = tid; e < kKC * MT; e += kFusedThreads) {
          const int mm = e % MT, kk = e / MT;
          const int k = k0 + kk, m = mt0 + mm;
          float v = 0.f;
          if (k < K && m < m_end) v = to_f32(w[(int64_t)k * M + m]);
          Ws[kk * MT + mm] = v;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kKC; ++kk) {
          float a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = Xs[kk * XS + ty + i * TY];
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = Ws[kk * MT + tx + j * TX];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
      }

      // epilogue in fp32: bias, then the residual addend, then ReLU
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = pt0 + ty + i * TY;
        if (q >= RP) continue;
        const int r = q / OW, ow = q - r * OW;
        const int oh = oh0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = mt0 + tx + j * TX;
          if (m >= m_end) continue;
          float v = acc[i][j];
          if (bias != nullptr) v += to_f32(bias[m]);
          const int64_t o = (((int64_t)n * OH + oh) * OW + ow) * M + m;
          if (addend != nullptr) v += to_f32(addend[o]);
          if (relu) v = fmaxf(v, 0.f);
          if (pool_kind != 0)
            Rs[q * MT + (m - mt0)] = v;       // pooled below
          else
            out[o] = from_f32<T>(v);
        }
      }
    }

    if (pool_kind != 0) {
      // the block holds whole pool windows (rows % psh == 0, OH % rows
      // == 0, OW % psw == 0 are the wrapper's checks)
      __syncthreads();
      const int POW = OW / psw, POH = OH / psh;
      const int PR = rows_here / psh, pr0 = oh0 / psh;
      const int mcount = min(MT, m_end - mt0);
      for (int e = tid; e < PR * POW * MT; e += kFusedThreads) {
        const int mm = e % MT, pp = e / MT;
        if (mm >= mcount) continue;
        const int pr = pp / POW, pc = pp - pr * POW;
        float v = pool_kind == 1 ? -INFINITY : 0.f;
        for (int a = 0; a < psh; ++a)
          for (int b = 0; b < psw; ++b) {
            const float u = Rs[((pr * psh + a) * OW + pc * psw + b) * MT + mm];
            v = pool_kind == 1 ? fmaxf(v, u) : v + u;
          }
        if (pool_kind == 2) v = v / (float)(psh * psw);
        out[(((int64_t)n * POH + pr0 + pr) * POW + pc) * M + mt0 + mm] =
            from_f32<T>(v);
      }
      __syncthreads();  // Rs is refilled by the next channel sub-tile
    }
  }
}

template <typename T, int MT>
static int launch_fused(const void* x, const void* w, const void* bias,
                        const void* addend, void* out, int N, int H, int W,
                        int C, int KH, int KW, int M, int sh, int sw, int ph,
                        int pw, int OH, int OW, int tm, int rows, int relu,
                        int pool_kind, int psh, int psw, int smem,
                        cudaStream_t stream) {
  auto kernel = cuconv_fused_kernel<T, MT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((M + tm - 1) / tm, (OH + rows - 1) / rows, N);
  kernel<<<grid, kFusedThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<const T*>(addend),
      static_cast<T*>(out), H, W, C, KH, KW, M, sh, sw, ph, pw, OH, OW, tm,
      rows, relu, pool_kind, psh, psw);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_fused_mt(const void* x, const void* w, const void* bias,
                           const void* addend, void* out, int N, int H, int W,
                           int C, int KH, int KW, int M, int sh, int sw,
                           int ph, int pw, int OH, int OW, int tm, int rows,
                           int relu, int pool_kind, int psh, int psw,
                           int smem, cudaStream_t s) {
  // the channel sub-tile MT follows tm (kernels/cuconv_fused.py mirrors it)
  if (tm <= 16)
    return launch_fused<T, 16>(x, w, bias, addend, out, N, H, W, C, KH, KW,
                               M, sh, sw, ph, pw, OH, OW, tm, rows, relu,
                               pool_kind, psh, psw, smem, s);
  if (tm <= 32)
    return launch_fused<T, 32>(x, w, bias, addend, out, N, H, W, C, KH, KW,
                               M, sh, sw, ph, pw, OH, OW, tm, rows, relu,
                               pool_kind, psh, psw, smem, s);
  return launch_fused<T, 64>(x, w, bias, addend, out, N, H, W, C, KH, KW, M,
                             sh, sw, ph, pw, OH, OW, tm, rows, relu,
                             pool_kind, psh, psw, smem, s);
}

REPRO_ERROR_STRING_EXPORT

REPRO_EXPORT int cuconv_fused_launch(
    const void* x, const void* w, const void* bias, const void* addend,
    void* out, int dtype, int N, int H, int W, int C, int KH, int KW, int M,
    int sh, int sw, int ph, int pw, int OH, int OW, int tm, int rows,
    int relu, int pool_kind, int psh, int psw, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_fused_mt<float>(x, w, bias, addend, out, N, H, W, C, KH,
                                  KW, M, sh, sw, ph, pw, OH, OW, tm, rows,
                                  relu, pool_kind, psh, psw, smem, s);
  if (dtype == kBFloat16)
    return launch_fused_mt<__nv_bfloat16>(
        x, w, bias, addend, out, N, H, W, C, KH, KW, M, sh, sw, ph, pw, OH,
        OW, tm, rows, relu, pool_kind, psh, psw, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
