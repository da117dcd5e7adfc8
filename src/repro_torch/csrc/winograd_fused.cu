// winograd_fused: a 3x3 stride-1 convolution by Winograd F(m x m, 3 x 3),
// m in {2, 4}, with the fused epilogue
//   out = act(A^T [sum over c of (B^T d_c B) . U_c] A + bias + addend)
// and one write in the input dtype; U_c = G g_c G^T is formed in the
// kernel from the HWIO filter.
//
// Replaces kernels/winograd_pallas.py::winograd_fused of the JAX package
// (the Pallas kernel that holds a (R, tt, tc) block of gathered tiles, a
// (R, tc, tm) block of U and an fp32 (R, tt, tm) accumulator in VMEM,
// R = (m+2)^2).  What bounds it on the H100: the R per-position GEMMs,
// 2*R*P*C*M flop (P tiles) on the tensor cores in 3xTF32 (495/3
// TFLOP/s), against a few bytes per input and output element; at
// resnet50's layers a few microseconds, so what decides the time is
// blocks in flight, the transforms and load latency.
//
// Design.
//  - One block of 4 warps per (BT tiles x BN output channels); nothing
//    walks a region.  A warp owns 16 tiles x 8*J channels (J = 2 at m=2,
//    1 at m=4) and keeps R accumulator fragments of mma.sync m16n8k8,
//    R*J*4 registers (128 at m=2, 144 at m=4).  BT x BN is 32 x 32 (m=2)
//    or 16 x 32 (m=4), or 64 x 16 and 32 x 16 where the layer (tm) is
//    16 channels wide; kernels/winograd_fused.py::launch_geometry picks
//    it and models the shared memory below.
//  - C runs inside the block in chunks of 8 channels, one mma k-step.
//    The raw input patches of the block's tiles (unpadded NHWC, masked
//    at the image edge) and the raw 3x3 filter slice are staged by
//    16-byte cp.async into a 2-stage ring: chunk c+1 lands while chunk c
//    is transformed and multiplied.  Where C or M is not a multiple of
//    16 bytes, or a base pointer is not aligned, masked scalar loads fill
//    the same ring.
//  - Per chunk the block forms B^T d B for its (tile, channel) pairs and
//    U = G g G^T for its (channel, out-channel) pairs, in fp32, into
//    shared memory (XOR-swizzled so fragment loads hit 32 banks), then
//    every warp runs R 3xTF32 mma steps (mma_tf32.cuh), for both input
//    dtypes: the transformed operands are fp32.
//  - In mma's accumulator layout a lane holds the same (tile, channel)
//    pairs for every position r, so A^T m A runs in registers straight
//    on the fragments, then bias, the NHWC addend, ReLU and the masked
//    NHWC write.
// The reference's tt and tc have no counterpart here (the plan keeps
// them); tm only picks the 16-channel variant.
#include "common.cuh"
#include "mma_tf32.cuh"

constexpr int kWinoThreads = 128;  // 4 warps
constexpr int kKC = 8;             // channels per chunk (one mma k-step)

// one-dimensional B^T (input), G (filter) and A^T (output) transforms,
// spelled out (the same matrices as core/winograd.py)
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
  static __device__ __forceinline__ void g(const float* k, float* r) {
    r[0] = k[0];
    r[1] = 0.5f * (k[0] + k[1] + k[2]);
    r[2] = 0.5f * (k[0] - k[1] + k[2]);
    r[3] = k[2];
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
  static __device__ __forceinline__ void g(const float* k, float* r) {
    r[0] = 0.25f * k[0];
    r[1] = (-1.f / 6.f) * (k[0] + k[1] + k[2]);
    r[2] = (-1.f / 6.f) * (k[0] - k[1] + k[2]);
    r[3] = (1.f / 24.f) * k[0] + (1.f / 12.f) * k[1] + (1.f / 6.f) * k[2];
    r[4] = (1.f / 24.f) * k[0] - (1.f / 12.f) * k[1] + (1.f / 6.f) * k[2];
    r[5] = k[2];
  }
  static __device__ __forceinline__ void at(const float* m, float* y) {
    y[0] = m[0] + m[1] + m[2] + m[3] + m[4];
    y[1] = m[1] - m[2] + 2.f * (m[3] - m[4]);
    y[2] = m[1] + m[2] + 4.f * (m[3] + m[4]);
    y[3] = m[1] - m[2] + 8.f * (m[3] - m[4]) + m[5];
  }
};

// the block's shape and shared memory (kernels/winograd_fused.py
// launch_geometry models the same bytes)
template <typename T, int FM, int WT, int WN>
struct WinoGeo {
  static constexpr int A = FM + 2, R = A * A;
  static constexpr int J = FM == 2 ? 2 : 1;  // 8-channel mma tiles a warp
  static constexpr int BT = 16 * WT, BN = 8 * J * WN;
  static constexpr int LDR = R * kKC + 8;    // raw tile: R pixels x 8 + pad
  static constexpr int RAW_IN = BT * LDR;    // T, per stage
  static constexpr int RAW_F = 9 * kKC * BN; // T, per stage
  static constexpr int V = R * BT * kKC;     // float
  static constexpr int U = R * kKC * BN;     // float
  static constexpr int SMEM = 2 * (RAW_IN + RAW_F) * sizeof(T) +
                              (V + U) * sizeof(float);
};

// swizzles: V[r][tile][c] and U[r][c][n] as the mma fragments read them
__device__ __forceinline__ int v_swz(int tile) { return ((tile >> 2) & 1) << 2; }

template <int BN>
__device__ __forceinline__ int u_swz(int c) {
  return BN == 32 ? (c & 3) << 3 : ((c >> 1) & 1) << 3;
}

template <typename T, int FM, int WT, int WN>
__global__ void __launch_bounds__(kWinoThreads)
winograd_fused_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const T* __restrict__ bias,
                      const T* __restrict__ addend, T* __restrict__ out,
                      int H, int W, int C, int M, int ph, int pw, int OH,
                      int OW, int TH, int TW, int P, int vec, int relu) {
  using G = WinoGeo<T, FM, WT, WN>;
  using Tr = WinoTransform<FM>;
  constexpr int A = G::A, R = G::R, J = G::J, BT = G::BT, BN = G::BN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* raw_in = reinterpret_cast<T*>(smem_raw);       // [2][BT][LDR]
  T* raw_f = raw_in + 2 * G::RAW_IN;                // [2][9][8][BN]
  float* Vs = reinterpret_cast<float*>(raw_f + 2 * G::RAW_F);  // [R][BT][8]
  float* Us = Vs + G::V;                            // [R][8][BN]
  __shared__ int s_n[BT], s_oh[BT], s_ow[BT];       // tile origins

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int tb = (warp / WN) * 16, cb = (warp % WN) * 8 * J;
  const int tile0 = blockIdx.x * BT, n0 = blockIdx.y * BN;
  const int tiles_per_image = TH * TW;

  for (int i = tid; i < BT; i += kWinoThreads) {
    const int p = tile0 + i;
    const int n = p / tiles_per_image, rem = p - n * tiles_per_image;
    const int th = rem / TW;
    s_n[i] = p < P ? n : -1;
    s_oh[i] = th * FM;
    s_ow[i] = (rem - th * TW) * FM;
  }
  __syncthreads();

  // stage the raw input patches and filter slice of channels c0..c0+7
  auto load_chunk = [&](int stage, int c0) {
    T* ri = raw_in + stage * G::RAW_IN;
    T* rf = raw_f + stage * G::RAW_F;
    constexpr int V = VecOf<T>::kElems;
    if (vec) {
      for (int e = tid; e < BT * R * (kKC / V); e += kWinoThreads) {
        const int q = e % (kKC / V), rest = e / (kKC / V);
        const int pix = rest % R, tile = rest / R;
        const int ih = s_oh[tile] - ph + pix / A, iw = s_ow[tile] - pw + pix % A;
        const int c = c0 + q * V;
        const bool ok = s_n[tile] >= 0 && ih >= 0 && ih < H && iw >= 0 &&
                        iw < W && c < C;
        const T* src =
            ok ? x + (((int64_t)s_n[tile] * H + ih) * W + iw) * C + c : x;
        cp_async16(ri + tile * G::LDR + pix * kKC + q * V, src, ok);
      }
      for (int e = tid; e < 9 * kKC * (BN / V); e += kWinoThreads) {
        const int q = e % (BN / V), rest = e / (BN / V);
        const int cc = rest % kKC, tap = rest / kKC;
        const int c = c0 + cc, m = n0 + q * V;
        const bool ok = c < C && m < M;
        const T* src = ok ? w + ((int64_t)tap * C + c) * M + m : w;
        cp_async16(rf + (tap * kKC + cc) * BN + q * V, src, ok);
      }
    } else {
      for (int e = tid; e < BT * R * kKC; e += kWinoThreads) {
        const int cc = e % kKC, rest = e / kKC;
        const int pix = rest % R, tile = rest / R;
        const int ih = s_oh[tile] - ph + pix / A, iw = s_ow[tile] - pw + pix % A;
        const int c = c0 + cc;
        const bool ok = s_n[tile] >= 0 && ih >= 0 && ih < H && iw >= 0 &&
                        iw < W && c < C;
        ri[tile * G::LDR + pix * kKC + cc] =
            ok ? x[(((int64_t)s_n[tile] * H + ih) * W + iw) * C + c]
               : from_f32<T>(0.f);
      }
      for (int e = tid; e < 9 * kKC * BN; e += kWinoThreads) {
        const int nn = e % BN, rest = e / BN;
        const int cc = rest % kKC, tap = rest / kKC;
        const int c = c0 + cc, m = n0 + nn;
        rf[(tap * kKC + cc) * BN + nn] =
            (c < C && m < M) ? w[((int64_t)tap * C + c) * M + m]
                             : from_f32<T>(0.f);
      }
    }
  };

  float acc[R][J][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][j][q] = 0.f;

  const int nchunks = (C + kKC - 1) / kKC;
  load_chunk(0, 0);
  cp_async_commit();
  for (int ch = 0; ch < nchunks; ++ch) {
    if (ch + 1 < nchunks) load_chunk((ch + 1) & 1, (ch + 1) * kKC);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // chunk ch landed
    const T* ri = raw_in + (ch & 1) * G::RAW_IN;
    const T* rf = raw_f + (ch & 1) * G::RAW_F;
    // B^T d B per (tile, channel): columns first, then rows
    for (int e = tid; e < BT * kKC; e += kWinoThreads) {
      const int cc = e % kKC, tile = e / kKC;
      const T* d = ri + tile * G::LDR + cc;
      float tmp[A][A], col[A], res[A];
#pragma unroll
      for (int j = 0; j < A; ++j) {
#pragma unroll
        for (int i = 0; i < A; ++i) col[i] = to_f32(d[(i * A + j) * kKC]);
        Tr::bt(col, res);
#pragma unroll
        for (int i = 0; i < A; ++i) tmp[i][j] = res[i];
      }
      float* v = Vs + tile * kKC + (cc ^ v_swz(tile));
#pragma unroll
      for (int i = 0; i < A; ++i) {
        Tr::bt(tmp[i], res);
#pragma unroll
        for (int l = 0; l < A; ++l) v[(i * A + l) * BT * kKC] = res[l];
      }
    }
    // G g G^T per (channel, out-channel)
    for (int e = tid; e < kKC * BN; e += kWinoThreads) {
      const int nn = e % BN, cc = e / BN;
      const T* k = rf + cc * BN + nn;
      float gg[A][3], col[3], res[A];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
#pragma unroll
        for (int i = 0; i < 3; ++i) col[i] = to_f32(k[(i * 3 + j) * kKC * BN]);
        Tr::g(col, res);
#pragma unroll
        for (int i = 0; i < A; ++i) gg[i][j] = res[i];
      }
      float* u = Us + cc * BN + (nn ^ u_swz<BN>(cc));
#pragma unroll
      for (int i = 0; i < A; ++i) {
        Tr::g(gg[i], res);
#pragma unroll
        for (int l = 0; l < A; ++l) u[(i * A + l) * kKC * BN] = res[l];
      }
    }
    __syncthreads();  // V and U of chunk ch formed
    const int sw = v_swz(g);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float* v = Vs + (r * BT + tb) * kKC;
      uint32_t ab[4], as[4];
      split_tf32(v[g * kKC + (t ^ sw)], ab[0], as[0]);
      split_tf32(v[(g + 8) * kKC + (t ^ sw)], ab[1], as[1]);
      split_tf32(v[g * kKC + ((t + 4) ^ sw)], ab[2], as[2]);
      split_tf32(v[(g + 8) * kKC + ((t + 4) ^ sw)], ab[3], as[3]);
      const float* u = Us + r * kKC * BN;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int nn = cb + j * 8 + g;
        uint32_t bb[2], bs[2];
        split_tf32(u[t * BN + (nn ^ u_swz<BN>(t))], bb[0], bs[0]);
        split_tf32(u[(t + 4) * BN + (nn ^ u_swz<BN>(t + 4))], bb[1], bs[1]);
        mma_3xtf32(acc[r][j], ab, as, bb, bs);
      }
    }
    __syncthreads();  // V, U and this ring stage free again
  }

  // A^T m A on each of this lane's (tile, channel) pairs, then bias,
  // addend and ReLU in fp32, one masked write per output
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int tile = tb + g + 8 * (q >> 1);
    const int n = s_n[tile];
    if (n < 0) continue;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int m = n0 + cb + j * 8 + 2 * t + (q & 1);
      if (m >= M) continue;
      float t2[FM][A], col[A], res[FM];
#pragma unroll
      for (int l = 0; l < A; ++l) {
#pragma unroll
        for (int k = 0; k < A; ++k) col[k] = acc[k * A + l][j][q];
        Tr::at(col, res);
#pragma unroll
        for (int u = 0; u < FM; ++u) t2[u][l] = res[u];
      }
      const float bv = bias != nullptr ? to_f32(bias[m]) : 0.f;
#pragma unroll
      for (int u = 0; u < FM; ++u) {
        Tr::at(t2[u], res);
        const int oh = s_oh[tile] + u;
        if (oh >= OH) continue;
#pragma unroll
        for (int v = 0; v < FM; ++v) {
          const int ow = s_ow[tile] + v;
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

template <typename T, int FM, int WT, int WN>
static int launch_wino(const void* x, const void* w, const void* bias,
                       const void* addend, void* out, int N, int H, int W,
                       int C, int M, int ph, int pw, int OH, int OW, int vec,
                       int relu, int smem, cudaStream_t stream) {
  using G = WinoGeo<T, FM, WT, WN>;
  constexpr int V = VecOf<T>::kElems;
  const bool aligned = C % V == 0 && M % V == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (smem != G::SMEM || (vec && !aligned))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = winograd_fused_kernel<T, FM, WT, WN>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // two blocks of ~110 KB share an SM only under the largest carveout
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int TH = (OH + FM - 1) / FM, TW = (OW + FM - 1) / FM;
  const int P = N * TH * TW;
  dim3 grid((P + G::BT - 1) / G::BT, (M + G::BN - 1) / G::BN);
  kernel<<<grid, kWinoThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<const T*>(addend),
      static_cast<T*>(out), H, W, C, M, ph, pw, OH, OW, TH, TW, P, vec,
      relu);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_wino_variant(const void* x, const void* w,
                               const void* bias, const void* addend,
                               void* out, int N, int H, int W, int C, int M,
                               int ph, int pw, int OH, int OW, int fm, int bn,
                               int vec, int relu, int smem, cudaStream_t s) {
  // (WT, WN) warps across tiles and channels; kernels/winograd_fused.py
  // launch_geometry mirrors the choice
  if (fm == 2 && bn == 32)
    return launch_wino<T, 2, 2, 2>(x, w, bias, addend, out, N, H, W, C, M,
                                   ph, pw, OH, OW, vec, relu, smem, s);
  if (fm == 2 && bn == 16)
    return launch_wino<T, 2, 4, 1>(x, w, bias, addend, out, N, H, W, C, M,
                                   ph, pw, OH, OW, vec, relu, smem, s);
  if (fm == 4 && bn == 32)
    return launch_wino<T, 4, 1, 4>(x, w, bias, addend, out, N, H, W, C, M,
                                   ph, pw, OH, OW, vec, relu, smem, s);
  if (fm == 4 && bn == 16)
    return launch_wino<T, 4, 2, 2>(x, w, bias, addend, out, N, H, W, C, M,
                                   ph, pw, OH, OW, vec, relu, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

REPRO_ERROR_STRING_EXPORT

REPRO_EXPORT int winograd_fused_launch(
    const void* x, const void* w, const void* bias, const void* addend,
    void* out, int dtype, int N, int H, int W, int C, int M, int ph, int pw,
    int OH, int OW, int fm, int bn, int vec, int relu, int smem,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_wino_variant<float>(x, w, bias, addend, out, N, H, W, C, M,
                                      ph, pw, OH, OW, fm, bn, vec, relu, smem,
                                      s);
  if (dtype == kBFloat16)
    return launch_wino_variant<__nv_bfloat16>(x, w, bias, addend, out, N, H,
                                              W, C, M, ph, pw, OH, OW, fm, bn,
                                              vec, relu, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
