// int8_gemm: the int32 accumulator of an int8 x int8 GEMM on the int8
// tensor cores, in two entries on one kernel body:
//  - the stacked entry (the reference's interface):
//      out (P x M, int32) = x2d (P x K, int8) @ w (K x M, int8);
//  - the conv entry (the cuconv_int8 executor's node): the same product
//    with the patch matrix gathered in the kernel from an unpadded NHWC
//    input, K ordered (tap, channel), the filter as (M, KH, KW, C) codes.
//    Its input is int8 codes (out: the raw int32 accumulator) or fp32,
//    quantized as it is staged, q = clamp(rint(x / s'), -127, 127) with
//    s' = s > 0 ? s : 1, and then out (fp32) is the requantization
//    epilogue in the reference's order: relu(float(acc) * (s * ws[m]) +
//    bias[m] + addend), each step rounded on its own (no FMA), so it is
//    bit-equal to the eager composition.
//
// Replaces kernels/int8_gemm.py::int8_gemm of the JAX package (the Pallas
// GEMM that drives the MXU's integer path into an int32 VMEM
// accumulator), and with the conv entry the patch matrix, quantization
// and epilogue the cuconv_int8 executor ran around it.  What bounds it on
// the H100: at the int8 resnet_like nodes (P = N*OH*OW of 64-1024, K =
// 9*C of 144 or 288, M of 16 or 32; at most 4.7 MOP) neither bytes nor
// the tensor cores' 1,979 TOP/s but latency: the launch, one round trip
// to memory for the operands and a short chain of mma.sync.
//
// Design.
//  - One block owns exactly one output tile of BM (16 or 32) pixels x BN
//    (M rounded up to 8, at most 32) channels, so every tile of a node
//    runs at once and none waits for another; kernels/int8_gemm.py::
//    launch_geometry picks them.  The plan's tp/tm/tc size nothing.
//  - The tile's whole contraction is staged in one go (in chunks of kc,
//    at most 512, where K is longer): A as BM rows and B as BN rows of kc
//    k-contiguous bytes (+16 bytes of padding a row, so the 32-bit
//    fragment loads hit 32 distinct banks).  A row p = (n, oh, ow) and
//    k = (tap, c) reads x[n, oh*sh - ph + di, ow*sw - pw + dj, c], zero in
//    the padding (code 0 is exact); a row's (ih0, iw0, image base) is
//    computed once per block.  Where C % 16 == 0 a tap's channels come in
//    16-byte runs: cp.async for codes, four float4 loads quantized into
//    16 codes for fp32; other C take a byte-wise path.  The stacked entry
//    is the same gather on a (P, 1, 1, K) input under a 1x1 filter.
//  - B is k-contiguous, as mma's .col operand wants: the conv entry's
//    (M, K) codes are copied in 16-byte runs, the stacked entry's (K, M)
//    is transposed as it is staged, 4 k of one column per 32-bit word.
//  - The 4 warps share the tile and split its k32-steps (warp w takes
//    steps w, w + 4, ...); each runs mma.sync.m16n8k32 s8 x s8 -> s32
//    over all of the tile's MI x NI fragments, and the 4 partial sums
//    are added in shared memory.  Integer sums are exact in any order:
//    products of codes in [-127, 127] summed over K <= 133,144 terms
//    stay below 2^31 (the wrapper refuses a longer K).
#include "common.cuh"
#include "mma_tf32.cuh"

constexpr int kI8Threads = 128;    // 4 warps
constexpr int kI8Warps = kI8Threads / 32;
constexpr int kI8KStep = 32;       // k of one mma.sync.m16n8k32
constexpr int kI8RowPad = 16;      // bytes after each staged row

struct I8Conv {
  int N, H, W, C, KH, KW, M, sh, sw, ph, pw, OH, OW;
  int K, P;    // KH*KW*C and N*OH*OW
  int kc;      // k staged per chunk, a multiple of 32
  int relu;
};

// kernels/int8_gemm.py::smem_bytes models the same shared memory
template <int MI, int NI>
struct I8Tile {
  static constexpr int BM = 16 * MI, BN = 8 * NI;
  static constexpr int LDR = BN + 8;   // int32 partial-sum rows
  static constexpr int RED = kI8Warps * BM * LDR * 4;
  static int smem(int kc) {
    const int stage = (BM + BN) * (kc + kI8RowPad);
    return stage > RED ? stage : RED;
  }
};

__device__ __forceinline__ int8_t quantize(float v, float s) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
  return static_cast<int8_t>(__float2int_rn(q));
}

// four codes in one word, the first in the low byte
__device__ __forceinline__ uint32_t quantize4(float4 f, float s) {
  const auto b = [&](float v, int i) {
    return static_cast<uint32_t>(static_cast<uint8_t>(quantize(v, s)))
           << (8 * i);
  };
  return b(f.x, 0) | b(f.y, 1) | b(f.z, 2) | b(f.w, 3);
}

// In: int8_t (codes) or float (quantized on load, with divisor sdiv)
template <typename In, bool KM, int MI, int NI>
__global__ void __launch_bounds__(kI8Threads)
int8_gemm_kernel(const In* __restrict__ x, const int8_t* __restrict__ w,
                 void* __restrict__ out, const float* __restrict__ scale,
                 const float* __restrict__ wscale,
                 const float* __restrict__ bias,
                 const float* __restrict__ addend, I8Conv cv, int vec_a,
                 int vec_b) {
  using L = I8Tile<MI, NI>;
  constexpr bool kFloat = sizeof(In) == 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lda = cv.kc + kI8RowPad;
  int8_t* As = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* Bs = As + L::BM * lda;
  // per tile row: first input row and column of its window, and the
  // image's first element (-1 past P)
  __shared__ int r_ih[L::BM], r_iw[L::BM], r_img[L::BM];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int p0 = blockIdx.x * L::BM, m0 = blockIdx.y * L::BN;
  const int ohw = cv.OH * cv.OW;
  for (int r = tid; r < L::BM; r += kI8Threads) {
    const int p = p0 + r;
    int ih = 0, iw = 0, img = -1;
    if (p < cv.P) {
      const int n = p / ohw, rem = p - n * ohw;
      const int oh = rem / cv.OW, ow = rem - oh * cv.OW;
      ih = oh * cv.sh - cv.ph;
      iw = ow * cv.sw - cv.pw;
      img = n * cv.H * cv.W;
    }
    r_ih[r] = ih;
    r_iw[r] = iw;
    r_img[r] = img;
  }
  float sdiv = 1.f;
  if constexpr (kFloat) {
    const float s = *scale;
    sdiv = s > 0.f ? s : 1.f;
  }
  __syncthreads();

  // element offset of (tile row r, k) in x, or -1 in the padding
  auto offset = [&](int r, int k) -> int {
    if (r_img[r] < 0 || k >= cv.K) return -1;
    const int tap = k / cv.C, c = k - tap * cv.C;
    const int di = tap / cv.KW, dj = tap - di * cv.KW;
    const int ih = r_ih[r] + di, iw = r_iw[r] + dj;
    if (ih < 0 || ih >= cv.H || iw < 0 || iw >= cv.W) return -1;
    return (r_img[r] + ih * cv.W + iw) * cv.C + c;
  };

  int acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0;

  for (int k0 = 0; k0 < cv.K; k0 += cv.kc) {
    // A: the tile's patch rows, k0 .. k0 + kc
    if (vec_a) {
      const int runs = cv.kc / 16;
      for (int e = tid; e < L::BM * runs; e += kI8Threads) {
        const int r = e / runs, j = e - r * runs;
        const int off = offset(r, k0 + 16 * j);
        int8_t* dst = As + r * lda + 16 * j;
        if constexpr (!kFloat) {
          cp_async16(dst, off >= 0 ? x + off : x, off >= 0);
        } else {
          uint32_t q[4] = {0u, 0u, 0u, 0u};
          if (off >= 0) {
            const float4* src = reinterpret_cast<const float4*>(x + off);
#pragma unroll
            for (int v = 0; v < 4; ++v) q[v] = quantize4(__ldg(src + v), sdiv);
          }
          *reinterpret_cast<uint4*>(dst) = make_uint4(q[0], q[1], q[2], q[3]);
        }
      }
    } else {
      for (int e = tid; e < L::BM * cv.kc; e += kI8Threads) {
        const int r = e / cv.kc, kk = e - r * cv.kc;
        const int off = offset(r, k0 + kk);
        int8_t v = 0;
        if (off >= 0) {
          if constexpr (kFloat)
            v = quantize(static_cast<float>(x[off]), sdiv);
          else
            v = static_cast<int8_t>(x[off]);
        }
        As[r * lda + kk] = v;
      }
    }
    // B: BN k-contiguous rows of the filter codes, k0 .. k0 + kc
    if constexpr (KM) {
      // (K, M), M-contiguous: 4 k of one column packed per word
      const int words = cv.kc / 4;
      for (int e = tid; e < L::BN * words; e += kI8Threads) {
        const int n = e % L::BN, kw = e / L::BN;
        const int m = m0 + n, k = k0 + 4 * kw;
        uint32_t v = 0u;
        if (m < cv.M) {
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (k + b < cv.K)
              v |= static_cast<uint32_t>(static_cast<uint8_t>(
                       w[(int64_t)(k + b) * cv.M + m])) << (8 * b);
        }
        *reinterpret_cast<uint32_t*>(Bs + n * lda + 4 * kw) = v;
      }
    } else if (vec_b) {
      const int runs = cv.kc / 16;
      for (int e = tid; e < L::BN * runs; e += kI8Threads) {
        const int n = e / runs, j = e - n * runs;
        const int m = m0 + n, k = k0 + 16 * j;
        const bool ok = m < cv.M && k < cv.K;
        cp_async16(Bs + n * lda + 16 * j, ok ? w + (int64_t)m * cv.K + k : w,
                   ok);
      }
    } else {
      for (int e = tid; e < L::BN * cv.kc; e += kI8Threads) {
        const int n = e / cv.kc, kk = e - n * cv.kc;
        const int m = m0 + n, k = k0 + kk;
        Bs[n * lda + kk] = m < cv.M && k < cv.K ? w[(int64_t)m * cv.K + k]
                                                 : int8_t(0);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // this warp's k32-steps of the chunk, over the whole tile
    const int steps = (min(cv.kc, cv.K - k0) + kI8KStep - 1) / kI8KStep;
    for (int s = warp; s < steps; s += kI8Warps) {
      const int kb = s * kI8KStep + 4 * t;
      uint32_t a[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int8_t* ap = As + (mi * 16 + g) * lda + kb;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(ap);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(ap + 8 * lda);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(ap + 16);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(ap + 8 * lda + 16);
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int8_t* bp = Bs + (ni * 8 + g) * lda + kb;
        uint32_t b[2];
        b[0] = *reinterpret_cast<const uint32_t*>(bp);
        b[1] = *reinterpret_cast<const uint32_t*>(bp + 16);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) mma_s8(acc[mi][ni], a[mi], b);
      }
    }
    __syncthreads();   // the staged chunk is free again
  }

  // the 4 warps' partial tiles to shared memory over the staging area;
  // lane (g, t)'s fragment q sits at row mi*16 + g + 8*(q/2), column
  // ni*8 + 2t + q%2
  int* Rs = reinterpret_cast<int*>(smem_raw) + warp * L::BM * L::LDR;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<int2*>(Rs + (mi * 16 + g + 8 * h) * L::LDR +
                                 ni * 8 + 2 * t) =
            make_int2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
  __syncthreads();

  const int* R0 = reinterpret_cast<const int*>(smem_raw);
  float s = 0.f;
  if constexpr (kFloat) s = *scale;
#pragma unroll 1
  for (int e = tid; e < L::BM * L::BN; e += kI8Threads) {
    const int r = e / L::BN, c = e - r * L::BN;
    const int p = p0 + r, m = m0 + c;
    if (p >= cv.P || m >= cv.M) continue;
    int sum = 0;
#pragma unroll
    for (int v = 0; v < kI8Warps; ++v) sum += R0[(v * L::BM + r) * L::LDR + c];
    const int64_t o = (int64_t)p * cv.M + m;
    if constexpr (!kFloat) {
      static_cast<int32_t*>(out)[o] = sum;
    } else {
      // the reference's fp32 order, one rounding per step
      float y = __fmul_rn(__int2float_rn(sum), __fmul_rn(s, wscale[m]));
      if (bias != nullptr) y = __fadd_rn(y, bias[m]);
      if (addend != nullptr) y = __fadd_rn(y, addend[o]);
      if (cv.relu) y = y < 0.f ? 0.f : y;
      static_cast<float*>(out)[o] = y;
    }
  }
}

template <typename In, bool KM, int MI, int NI>
static int launch(const void* x, const void* w, void* out, const void* scale,
                  const void* wscale, const void* bias, const void* addend,
                  const I8Conv& cv, int vec_a, int vec_b, int smem,
                  cudaStream_t stream) {
  using L = I8Tile<MI, NI>;
  const int m_tiles = (cv.P + L::BM - 1) / L::BM;
  const int n_tiles = (cv.M + L::BN - 1) / L::BN;
  const bool a_ok = cv.C % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool b_ok = !KM && cv.K % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (smem != L::smem(cv.kc) || cv.kc < kI8KStep || cv.kc % kI8KStep ||
      (vec_a && !a_ok) || (vec_b && !b_ok) || n_tiles > 65535 ||
      (sizeof(In) == 4 && (scale == nullptr || wscale == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = int8_gemm_kernel<In, KM, MI, NI>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(m_tiles, n_tiles);
  kernel<<<grid, kI8Threads, smem, stream>>>(
      static_cast<const In*>(x), static_cast<const int8_t*>(w), out,
      static_cast<const float*>(scale), static_cast<const float*>(wscale),
      static_cast<const float*>(bias), static_cast<const float*>(addend), cv,
      vec_a, vec_b);
  return static_cast<int>(cudaGetLastError());
}

template <typename In, bool KM, int MI>
static int launch_bn(const void* x, const void* w, void* out,
                     const void* scale, const void* wscale, const void* bias,
                     const void* addend, const I8Conv& cv, int bn, int vec_a,
                     int vec_b, int smem, cudaStream_t s) {
  switch (bn) {
    case 8:
      return launch<In, KM, MI, 1>(x, w, out, scale, wscale, bias, addend,
                                   cv, vec_a, vec_b, smem, s);
    case 16:
      return launch<In, KM, MI, 2>(x, w, out, scale, wscale, bias, addend,
                                   cv, vec_a, vec_b, smem, s);
    case 24:
      return launch<In, KM, MI, 3>(x, w, out, scale, wscale, bias, addend,
                                   cv, vec_a, vec_b, smem, s);
    case 32:
      return launch<In, KM, MI, 4>(x, w, out, scale, wscale, bias, addend,
                                   cv, vec_a, vec_b, smem, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename In, bool KM>
static int launch_tile(const void* x, const void* w, void* out,
                       const void* scale, const void* wscale,
                       const void* bias, const void* addend, const I8Conv& cv,
                       int bm, int bn, int vec_a, int vec_b, int smem,
                       cudaStream_t s) {
  if (bm == 16)
    return launch_bn<In, KM, 1>(x, w, out, scale, wscale, bias, addend, cv,
                                bn, vec_a, vec_b, smem, s);
  if (bm == 32)
    return launch_bn<In, KM, 2>(x, w, out, scale, wscale, bias, addend, cv,
                                bn, vec_a, vec_b, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

REPRO_ERROR_STRING_EXPORT

// in_float: x is fp32 (quantized on load; out is the fp32 epilogue) or
// int8 codes (out is the int32 accumulator); w_km: w is (K, M) (the
// stacked entry) or (M, K) (the conv entry's (M, KH, KW, C) codes)
REPRO_EXPORT int int8_gemm_launch(
    const void* x, const void* w, void* out, const void* scale,
    const void* wscale, const void* bias, const void* addend, int in_float,
    int w_km, int N, int H, int W, int C, int KH, int KW, int M, int sh,
    int sw, int ph, int pw, int OH, int OW, int bm, int bn, int kc, int relu,
    int vec_a, int vec_b, int smem, void* stream) {
  const I8Conv cv{N,  H,  W,  C,  KH, KW, M, sh, sw, ph,
                  pw, OH, OW, KH * KW * C,  N * OH * OW, kc, relu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_float && !w_km)
    return launch_tile<float, false>(x, w, out, scale, wscale, bias, addend,
                                     cv, bm, bn, vec_a, vec_b, smem, s);
  if (!in_float && !w_km)
    return launch_tile<int8_t, false>(x, w, out, scale, wscale, bias,
                                      addend, cv, bm, bn, vec_a, vec_b, smem,
                                      s);
  if (!in_float && w_km)
    return launch_tile<int8_t, true>(x, w, out, scale, wscale, bias, addend,
                                     cv, bm, bn, vec_a, vec_b, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
