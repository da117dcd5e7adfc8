// cuconv_fused: both cuConv stages in one kernel, with the fused epilogue
//   out = act(sum over taps of X_shift(t) . W[t] + bias + addend)
// or a non-overlapping max/avg pool of act(... + bias), one write in the
// input dtype.
//
// Replaces kernels/cuconv_fused.py::cuconv_fused of the JAX package (the
// Pallas kernel whose tap axis revisits a VMEM-resident output block).
// What bounds it on the H100: at the paper's rows (t4_B: 2*169*384*3456
// flop, 449 MFLOP, against 2.8 MB of operands) the tensor cores' rate for
// the 3xTF32 product (495/3 TFLOP/s; 989 in bf16), so the bound is a few
// microseconds and what decides the time is how many blocks are in flight
// and how well the loads overlap the math.
//
// Design: an implicit GEMM, (output pixels) x (k = tap, channel) times
// (k) x (output channels), on the tensor cores.
//  - The kernel owns its geometry (kernels/cuconv_fused.py::
//    launch_geometry): a block of 4 warps (2 x 2) computes BM = 64 or 32
//    output pixels x BN = 64, 32 or 16 output channels.  BN follows M, so
//    resnet_like's 16- and 32-channel layers fill their tiles, and the
//    tile shrinks where its tiles and splits would leave the card under
//    two blocks per SM.  The plan's tm/rows size nothing.
//  - The contraction runs over k = (tap, channel) in HWIO order, so the
//    filter slice of a 32-deep step is rows k0..k0+32 of the (KH*KW*C, M)
//    row-major view of w.  fp32: mma.sync m16n8k8 on TF32 in the 3xTF32
//    split; bf16: mma.sync m16n8k16.  fp32 accumulation in registers.
//  - Both operands go through a 3-stage ring in shared memory filled by
//    16-byte cp.async (zero-fill for padding and ragged edges) while the
//    tensor cores work on an earlier stage.  The input is an implicit
//    im2col gather: where C is a multiple of the 16-byte vector and x is
//    16-byte aligned, each 16-byte run of channels lies inside one tap of
//    one pixel.  Otherwise (the stem's C = 3, a misaligned pointer) the
//    same ring is filled by masked scalar loads, chosen at launch; the
//    filter likewise by M and w's alignment.  Each tile row's (pixel base,
//    ih0, iw0) is computed once per block into shared memory, and each
//    thread decodes its one k column's (tap, channel) once per step.
//  - Where the output tiles alone are too few to fill the card, K is
//    split across blocks in fixed runs of whole steps, and the last block
//    of a tile sums the partials in split order (splitk.cuh, shared with
//    conv1x1_gemm): deterministic, and CUDA-graph safe.  The partial
//    tiles go tile-major through shared memory in 16-byte stores, and the
//    last block reads them back 16 bytes at a time.
//  - The finished fp32 tile goes to shared memory over the drained ring,
//    and the epilogue runs from there in fp32: bias, then the NHWC
//    addend, then ReLU, one write.  Under a pool the pixel tile is a 2-D
//    spatial tile of one image (TH x TW, multiples of the pool window, so
//    it holds whole windows; the stem: 2 rows x 32 columns), pooled from
//    shared memory after bias and ReLU.  Pooled specs take no split.
#include <limits.h>
#include <math.h>

#include "common.cuh"
#include "mma_tf32.cuh"
#include "splitk.cuh"

constexpr int kThreads = 128;  // 4 warps, 2 x 2
constexpr int kBK = 32;        // contraction depth per stage
constexpr int kStages = 3;

struct ConvGeo {
  int N, H, W, C, KH, KW, M, sh, sw, ph, pw, OH, OW;
  int P, K;                 // N*OH*OW output pixels, KH*KW*C
  int relu, pool_kind, psh, psw;
  int TH, TW, tiles_h, tiles_w;  // the pooled spatial tile
};

// kernels/cuconv_fused.py::launch_geometry models the same shared memory
template <typename T, int MI, int NI>
struct FTile {
  static constexpr int BM = 32 * MI, BN = 16 * NI;
  static constexpr int LDA = kBK + RingPad<T>::A, LDB = BN + RingPad<T>::B;
  static constexpr int A_ELEMS = BM * LDA, B_ELEMS = kBK * LDB;
  static constexpr int RING = kStages * (A_ELEMS + B_ELEMS) * sizeof(T);
  // the finished fp32 tile, staged over the drained ring
  static constexpr int LDR = BN + 4;
  static constexpr int STAGED = BM * LDR * 4;
  static constexpr int SMEM = RING > STAGED ? RING : STAGED;
};

template <typename T, int MI, int NI>
__device__ __forceinline__ void load_stage(
    T* As, T* Bs, const T* __restrict__ x, const T* __restrict__ w,
    const int4* __restrict__ info, const ConvGeo& cg, int n0, int k0,
    int k_end, bool vec_a, bool vec_b, int tid) {
  using L = FTile<T, MI, NI>;
  constexpr int V = VecOf<T>::kElems;
  const T zero = from_f32<T>(0.f);
  // input: the implicit im2col gather; each thread owns one k column
  if (vec_a) {
    constexpr int CPR = kBK / V;           // 16-byte chunks per tile row
    const int cc = tid % CPR;
    const int k = k0 + cc * V;
    const bool kok = k < k_end;
    int di = 0, dj = 0, off = 0;
    if (kok) {
      const int tap = k / cg.C, c = k - tap * cg.C;
      di = tap / cg.KW;
      dj = tap - di * cg.KW;
      off = (di * cg.W + dj) * cg.C + c;
    }
    for (int r = tid / CPR; r < L::BM; r += kThreads / CPR) {
      const int4 in = info[r];
      const bool ok = kok && (unsigned)(in.y + di) < (unsigned)cg.H &&
                      (unsigned)(in.z + dj) < (unsigned)cg.W;
      cp_async16(As + r * L::LDA + cc * V, ok ? x + in.x + off : x, ok);
    }
  } else {
    const int kk = tid % kBK;
    const int k = k0 + kk;
    const bool kok = k < k_end;
    int di = 0, dj = 0, off = 0;
    if (kok) {
      const int tap = k / cg.C, c = k - tap * cg.C;
      di = tap / cg.KW;
      dj = tap - di * cg.KW;
      off = (di * cg.W + dj) * cg.C + c;
    }
    for (int r = tid / kBK; r < L::BM; r += kThreads / kBK) {
      const int4 in = info[r];
      const bool ok = kok && (unsigned)(in.y + di) < (unsigned)cg.H &&
                      (unsigned)(in.z + dj) < (unsigned)cg.W;
      As[r * L::LDA + kk] = ok ? x[in.x + off] : zero;
    }
  }
  // filter: rows k0..k0+kBK of the (K, M) view, columns n0..n0+BN
  if (vec_b) {
    for (int e = tid; e < kBK * L::BN / V; e += kThreads) {
      const int r = e / (L::BN / V), cc = (e % (L::BN / V)) * V;
      const int k = k0 + r, n = n0 + cc;
      const bool ok = k < k_end && n < cg.M;
      cp_async16(Bs + r * L::LDB + cc, ok ? w + k * cg.M + n : w, ok);
    }
  } else {
    for (int e = tid; e < kBK * L::BN; e += kThreads) {
      const int r = e / L::BN, cc = e % L::BN;
      const int k = k0 + r, n = n0 + cc;
      Bs[r * L::LDB + cc] =
          (k < k_end && n < cg.M) ? w[k * cg.M + n] : zero;
    }
  }
}

template <typename T, int MI, int NI>
__global__ void __launch_bounds__(kThreads)
cuconv_fused_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const T* __restrict__ bias, const T* __restrict__ addend,
                    T* __restrict__ out, float* __restrict__ ws,
                    int* __restrict__ counters, ConvGeo geo, int splits,
                    int vec_a, int vec_b) {
  using L = FTile<T, MI, NI>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);
  T* Bs = As + kStages * L::A_ELEMS;
  // per tile row: (input offset of (n, ih0, iw0), ih0, iw0, output pixel
  // index, or -1 where the row holds no pixel)
  __shared__ int4 info[L::BM];
  // whether this launch pools, re-read from here after the main loop
  // (held in a register across the loop, it made ptxas spill in the fp32
  // 64 x 16 variant)
  __shared__ int pooled;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int row0 = (warp >> 1) * 16 * MI, col0 = (warp & 1) * 8 * NI;
  const int n0 = blockIdx.y * L::BN;
  const int z = blockIdx.z;

  // which image and spatial tile (pooled), or which run of pixels
  int img = 0, th = 0, tw = 0;
  if (geo.pool_kind != 0) {
    const int per_img = geo.tiles_h * geo.tiles_w;
    img = blockIdx.x / per_img;
    const int rem = blockIdx.x - img * per_img;
    th = rem / geo.tiles_w;
    tw = rem - th * geo.tiles_w;
  }
  if (tid == 0) pooled = geo.pool_kind != 0;
  for (int r = tid; r < L::BM; r += kThreads) {
    int n, oh, ow;
    bool valid;
    if (geo.pool_kind != 0) {
      const int lr = r / geo.TW, lc = r - lr * geo.TW;
      n = img;
      oh = th * geo.TH + lr;
      ow = tw * geo.TW + lc;
      valid = lr < geo.TH && oh < geo.OH && ow < geo.OW;
    } else {
      const int p = blockIdx.x * L::BM + r;
      const int ohw = geo.OH * geo.OW;
      n = p / ohw;
      const int rem = p - n * ohw;
      oh = rem / geo.OW;
      ow = rem - oh * geo.OW;
      valid = p < geo.P;
    }
    int4 in = make_int4(0, INT_MIN / 2, INT_MIN / 2, -1);
    if (valid) {
      const int ih0 = oh * geo.sh - geo.ph, iw0 = ow * geo.sw - geo.pw;
      in = make_int4(((n * geo.H + ih0) * geo.W + iw0) * geo.C, ih0, iw0,
                     (n * geo.OH + oh) * geo.OW + ow);
    }
    info[r] = in;
  }
  __syncthreads();

  // this split's fixed run of 32-deep steps
  const int k_steps = (geo.K + kBK - 1) / kBK;
  int s_begin, s_end;
  split_steps(z, splits, k_steps, s_begin, s_end);
  const int nk = s_end - s_begin;
  const int k_end = min(s_end * kBK, geo.K);

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      load_stage<T, MI, NI>(As + s * L::A_ELEMS, Bs + s * L::B_ELEMS, x, w,
                            info, geo, n0, (s_begin + s) * kBK, k_end,
                            vec_a, vec_b, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 is free again
    const int nxt = kt + kStages - 1;
    if (nxt < nk) {
      const int slot = nxt % kStages;
      load_stage<T, MI, NI>(As + slot * L::A_ELEMS, Bs + slot * L::B_ELEMS,
                            x, w, info, geo, n0, (s_begin + nxt) * kBK,
                            k_end, vec_a, vec_b, tid);
    }
    cp_async_commit();
    const int slot = kt % kStages;
    warp_mma_stage<MI, NI, L::LDA, L::LDB, kBK>(
        acc, As + slot * L::A_ELEMS, Bs + slot * L::B_ELEMS, row0, col0, g,
        t);
  }
  cp_async_wait<0>();

  // The finished fp32 tile goes to shared memory over the drained ring;
  // the pool, the split reduction and the epilogue read it from there,
  // each as one loop (unrolled over a thread's fragments, the epilogue's
  // masks and flags overflow the predicate registers).  This lane's
  // accumulator (mi, ni, q) sits at tile row / column
  //   row0 + mi*16 + g + 8*(q/2),  col0 + ni*8 + 2t + q%2
  float* Rs = reinterpret_cast<float*>(smem_raw);
  __syncthreads();  // every warp is done with the ring
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int q2 = 0; q2 < 2; ++q2) {
        const int r = row0 + mi * 16 + g + 8 * q2;
        const int c = col0 + ni * 8 + 2 * t;
        *reinterpret_cast<float2*>(Rs + r * L::LDR + c) =
            make_float2(acc[mi][ni][2 * q2], acc[mi][ni][2 * q2 + 1]);
      }
  __syncthreads();

  if (pooled) {
    // act(conv + bias), then the window's max or mean
    const int PW = geo.TW / geo.psw, PH = geo.TH / geo.psh;
    const int POH = geo.OH / geo.psh, POW = geo.OW / geo.psw;
    for (int e = tid; e < PH * PW * L::BN; e += kThreads) {
      const int c = e % L::BN, win = e / L::BN;
      const int wr = win / PW, wc = win - wr * PW;
      const int m = n0 + c;
      const int oh = th * geo.TH + wr * geo.psh;
      const int ow = tw * geo.TW + wc * geo.psw;
      if (m >= geo.M || oh >= geo.OH || ow >= geo.OW) continue;
      const float b = bias != nullptr ? to_f32(bias[m]) : 0.f;
      float v = geo.pool_kind == 1 ? -INFINITY : 0.f;
      for (int i = 0; i < geo.psh; ++i)
        for (int j = 0; j < geo.psw; ++j) {
          float u = Rs[((wr * geo.psh + i) * geo.TW + wc * geo.psw + j) *
                           L::LDR + c] + b;
          if (geo.relu) u = fmaxf(u, 0.f);
          v = geo.pool_kind == 1 ? fmaxf(v, u) : v + u;
        }
      if (geo.pool_kind == 2) v = v / (float)(geo.psh * geo.psw);
      out[(((int64_t)img * POH + oh / geo.psh) * POW + ow / geo.psw) *
              geo.M + m] = from_f32<T>(v);
    }
    return;
  }

  constexpr int TILE = L::BM * L::BN;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (splits > 1) {
    // split-K: this split's partial tile goes to the tile-major workspace
    // in 16-byte stores; the last block of the tile sums the partials in
    // split order back into shared memory
    constexpr int G = TILE / 4 / kThreads;
    const int stride = gridDim.x * gridDim.y * TILE;  // one split's tiles
    float4* dst = reinterpret_cast<float4*>(ws + z * stride + tile * TILE);
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int e = 4 * (tid + j * kThreads);
      dst[e / 4] = *reinterpret_cast<const float4*>(
          Rs + (e / L::BN) * L::LDR + e % L::BN);
    }
    if (!split_arrive_last(counters, tile, splits)) return;
    float4 sum[G];
    split_sum4<G, kThreads>(ws + tile * TILE, stride, splits, sum);
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int e = 4 * (tid + j * kThreads);
      *reinterpret_cast<float4*>(Rs + (e / L::BN) * L::LDR + e % L::BN) =
          sum[j];
    }
    __syncthreads();
  }

  // the epilogue in fp32: bias, then the NHWC addend, then ReLU
#pragma unroll 1
  for (int e = tid; e < TILE; e += kThreads) {
    const int r = e / L::BN, c = e % L::BN;
    const int p = info[r].w, m = n0 + c;
    if (p < 0 || m >= geo.M) continue;
    const int o = p * geo.M + m;
    float v = Rs[r * L::LDR + c];
    if (bias != nullptr) v += to_f32(bias[m]);
    if (addend != nullptr) v += to_f32(addend[o]);
    if (geo.relu) v = fmaxf(v, 0.f);
    out[o] = from_f32<T>(v);
  }
  if (splits > 1) split_reset(counters, tile);
}

template <typename T, int MI, int NI>
static int launch(const void* x, const void* w, const void* bias,
                  const void* addend, void* out, void* ws, void* counters,
                  const ConvGeo& geo, int tiles, int splits, int vec_a,
                  int vec_b, int smem, cudaStream_t stream) {
  using L = FTile<T, MI, NI>;
  constexpr int V = VecOf<T>::kElems;
  const int k_steps = (geo.K + kBK - 1) / kBK;
  const bool a_ok = geo.C % V == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool b_ok = geo.M % V == 0 &&
                    reinterpret_cast<uintptr_t>(w) % 16 == 0;
  // the split reduction indexes the workspace with ints; pools take none
  const bool ws_ok =
      splits == 1 || (ws != nullptr && counters != nullptr &&
                      geo.pool_kind == 0 &&
                      (int64_t)splits * tiles * L::BM * L::BN <= INT32_MAX);
  const int n_tiles = (geo.M + L::BN - 1) / L::BN;
  const int m_tiles = geo.pool_kind != 0
                          ? geo.N * geo.tiles_h * geo.tiles_w
                          : (geo.P + L::BM - 1) / L::BM;
  const bool pool_ok = geo.pool_kind == 0 ||
                       (geo.TH * geo.TW <= L::BM && geo.TH % geo.psh == 0 &&
                        geo.TW % geo.psw == 0 && geo.TH > 0 && geo.TW > 0);
  if (smem != L::SMEM || splits < 1 || splits > k_steps || !ws_ok ||
      !pool_ok || tiles != m_tiles * n_tiles || (vec_a && !a_ok) ||
      (vec_b && !b_ok) || n_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = cuconv_fused_kernel<T, MI, NI>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(m_tiles, n_tiles, splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<const T*>(addend),
      static_cast<T*>(out), static_cast<float*>(ws),
      static_cast<int*>(counters), geo, splits, vec_a, vec_b);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MI>
static int launch_bn(const void* x, const void* w, const void* bias,
                     const void* addend, void* out, void* ws, void* counters,
                     const ConvGeo& geo, int bn, int tiles, int splits,
                     int vec_a, int vec_b, int smem, cudaStream_t s) {
  if (bn == 64)
    return launch<T, MI, 4>(x, w, bias, addend, out, ws, counters, geo,
                            tiles, splits, vec_a, vec_b, smem, s);
  if (bn == 32)
    return launch<T, MI, 2>(x, w, bias, addend, out, ws, counters, geo,
                            tiles, splits, vec_a, vec_b, smem, s);
  if (bn == 16)
    return launch<T, MI, 1>(x, w, bias, addend, out, ws, counters, geo,
                            tiles, splits, vec_a, vec_b, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
static int launch_tile(const void* x, const void* w, const void* bias,
                       const void* addend, void* out, void* ws,
                       void* counters, const ConvGeo& geo, int bm, int bn,
                       int tiles, int splits, int vec_a, int vec_b, int smem,
                       cudaStream_t s) {
  if (bm == 64)
    return launch_bn<T, 2>(x, w, bias, addend, out, ws, counters, geo, bn,
                           tiles, splits, vec_a, vec_b, smem, s);
  if (bm == 32)
    return launch_bn<T, 1>(x, w, bias, addend, out, ws, counters, geo, bn,
                           tiles, splits, vec_a, vec_b, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

REPRO_ERROR_STRING_EXPORT

REPRO_EXPORT int cuconv_fused_launch(
    const void* x, const void* w, const void* bias, const void* addend,
    void* out, void* ws, void* counters, int dtype, int N, int H, int W,
    int C, int KH, int KW, int M, int sh, int sw, int ph, int pw, int OH,
    int OW, int relu, int pool_kind, int psh, int psw, int th, int tw,
    int bm, int bn, int tiles, int splits, int vec_a, int vec_b, int smem,
    void* stream) {
  ConvGeo geo{N, H, W, C, KH, KW, M, sh, sw, ph, pw, OH, OW,
              N * OH * OW, KH * KW * C, relu, pool_kind, psh, psw,
              th, tw, 1, 1};
  if (pool_kind != 0) {
    if (th < 1 || tw < 1 || psh < 1 || psw < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    geo.tiles_h = (OH + th - 1) / th;
    geo.tiles_w = (OW + tw - 1) / tw;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_tile<float>(x, w, bias, addend, out, ws, counters, geo, bm,
                              bn, tiles, splits, vec_a, vec_b, smem, s);
  if (dtype == kBFloat16)
    return launch_tile<__nv_bfloat16>(x, w, bias, addend, out, ws, counters,
                                      geo, bm, bn, tiles, splits, vec_a,
                                      vec_b, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
