// direct_conv: an im2col-free direct convolution, any stride, no epilogue:
//   out[n, oh, ow, m] = sum over (di, dj, c) of
//                       x[n, oh*sh - ph + di, ow*sw - pw + dj, c] * w[di, dj, c, m]
// accumulated in fp32, one write in the input dtype.
//
// Replaces kernels/direct_conv.py::direct_conv of the JAX package (the
// Pallas kernel whose grid step stages one image's whole padded extent
// for a tc-channel slice and the matching (KH, KW, tc, tm) filter block
// in VMEM, with an fp32 accumulator across the sequential channel axis).
// What bounds it on the H100: at the paper's rows (t4_B: 2*169*384*3456
// flop, 449 MFLOP, against 2.8 MB of operands) the tensor cores' rate for
// the 3xTF32 product (495/3 TFLOP/s; 989 in bf16), so the bound is a few
// microseconds and what decides the time is how many blocks are in flight
// and how well the loads overlap the products.
//
// Design: a direct conv on the tensor cores that keeps what makes it
// "direct": each input element is staged once per block and every tap
// runs out of shared memory.
//  - A block computes a TH x TW tile of output pixels of one image (TH*TW
//    <= BM = 64 or 32 rows of the mma tile) by BN = 64, 32 or 16 output
//    channels, with 4 warps (2 x 2).  kernels/direct_conv.py::
//    launch_geometry picks the tile, the channel chunk and the splits from
//    the shape, so the launch fills the 132 SMs; the plan's tm/tc size
//    nothing.
//  - Per chunk of kc input channels the block stages the tile's input halo
//    ((TH-1)*sh + KH) x ((TW-1)*sw + KW) x kc, read from the unpadded NHWC
//    input in 16-byte cp.async runs of channels (zero-fill where the halo
//    falls in the padding), and the filter slice [tap][kc][BN].  Both go
//    through one ring of 2 or 3 stages, filled while the tensor cores work
//    on an earlier chunk.  Each halo position's input offset is computed
//    once per block into shared memory.  Where C is not a multiple of the
//    16-byte vector, or x is misaligned, masked scalar loads fill the halo
//    instead (the filter likewise by M and w's alignment).
//  - The products are mma.sync: 3xTF32 m16n8k8 in fp32, bf16 m16n8k16 in
//    bf16 (mma_tf32.cuh), fp32 accumulation in registers.  A warp's A rows
//    are tile pixels: row r = (r / TW, r % TW) of tap (di, dj) reads halo
//    position ((r / TW)*sh + di) * IWT + (r % TW)*sw + dj, so each staged
//    element is reused by up to KH*KW taps and BN channels; each A
//    fragment is split into TF32 big and small halves once per (tap,
//    k-step) and reused across the warp's n-fragments.  The halo rows are
//    padded by 16 bytes, so the fragment loads of 8 neighbouring pixels
//    hit 32 distinct banks.
//  - Where the output tiles alone are too few to fill the card, C is split
//    across blocks in whole chunks, and the last block of a tile sums the
//    fp32 partials in split order (splitk.cuh, shared with conv1x1_gemm and
//    cuconv_fused): deterministic, and CUDA-graph safe.  The finished tile
//    goes through shared memory over the drained ring, to the tile-major
//    workspace in 16-byte stores and to the output in one write.
#include "common.cuh"
#include "mma_tf32.cuh"
#include "splitk.cuh"

constexpr int kThreads = 128;  // 4 warps, 2 x 2

struct DirectGeo {
  int N, H, W, C, KH, KW, M, sh, sw, ph, pw, OH, OW;
  int TH, TW, tiles_h, tiles_w;  // the pixel tile, and tiles per image
  int IHT, IWT;                  // the tile's input halo
  int kc, chunks, stages;        // channels per chunk, chunks, ring depth
};

// channels of one mma k-step
template <typename T>
struct KStep {
  static constexpr int value = sizeof(T) == 4 ? 8 : 16;
};

// kernels/direct_conv.py::smem_bytes models the same shared memory:
// the halo's offset table, then the ring (or the finished fp32 tile
// staged over it)
template <typename T, int MI, int NI>
struct DTile {
  static constexpr int BM = 32 * MI, BN = 16 * NI;
  static constexpr int LDB = BN + RingPad<T>::B;
  static constexpr int LDR = BN + 4;
};

__host__ __device__ inline int pos_bytes(const DirectGeo& g) {
  return (g.IHT * g.IWT * 4 + 15) / 16 * 16;
}

template <typename T, int MI, int NI>
__host__ __device__ inline int stage_elems(const DirectGeo& g) {
  return g.IHT * g.IWT * (g.kc + RingPad<T>::A) +
         g.KH * g.KW * g.kc * DTile<T, MI, NI>::LDB;
}

template <typename T, int MI, int NI>
static int smem_model(const DirectGeo& g) {
  using L = DTile<T, MI, NI>;
  const int ring = g.stages * stage_elems<T, MI, NI>(g) * (int)sizeof(T);
  const int staged = L::BM * L::LDR * 4;
  return pos_bytes(g) + (ring > staged ? ring : staged);
}

// one chunk of channels c0..c0+kc: the halo into Xs, the filter into Ws
template <typename T, int MI, int NI>
__device__ __forceinline__ void load_chunk(T* Xs, T* Ws,
                                           const T* __restrict__ x,
                                           const T* __restrict__ w,
                                           const int* __restrict__ pos,
                                           const DirectGeo& g, int n0,
                                           int c0, bool vec_a, bool vec_b,
                                           int tid) {
  using L = DTile<T, MI, NI>;
  constexpr int V = VecOf<T>::kElems;
  const T zero = from_f32<T>(0.f);
  const int halo = g.IHT * g.IWT;
  const int ldx = g.kc + RingPad<T>::A;
  if (vec_a) {
    const int rpp = g.kc / V;            // 16-byte runs per position
    for (int e = tid; e < halo * rpp; e += kThreads) {
      const int p = e / rpp, run = e - p * rpp;
      const int c = c0 + run * V;
      const int off = pos[p];
      const bool ok = off >= 0 && c < g.C;
      cp_async16(Xs + p * ldx + run * V, ok ? x + off + c : x, ok);
    }
  } else {
    for (int e = tid; e < halo * g.kc; e += kThreads) {
      const int p = e / g.kc, cc = e - p * g.kc;
      const int c = c0 + cc;
      const int off = pos[p];
      Xs[p * ldx + cc] = off >= 0 && c < g.C ? x[off + c] : zero;
    }
  }
  // filter rows (tap, k) of w's (KH*KW*C, M) view, columns n0..n0+BN
  const int rows = g.KH * g.KW * g.kc;
  if (vec_b) {
    constexpr int CPR = L::BN / V;
    for (int e = tid; e < rows * CPR; e += kThreads) {
      const int row = e / CPR, cc = (e - row * CPR) * V;
      const int tap = row / g.kc, c = c0 + row - tap * g.kc, n = n0 + cc;
      const bool ok = c < g.C && n < g.M;
      cp_async16(Ws + row * L::LDB + cc,
                 ok ? w + (tap * g.C + c) * g.M + n : w, ok);
    }
  } else {
    for (int e = tid; e < rows * L::BN; e += kThreads) {
      const int row = e / L::BN, cc = e - row * L::BN;
      const int tap = row / g.kc, c = c0 + row - tap * g.kc, n = n0 + cc;
      Ws[row * L::LDB + cc] =
          c < g.C && n < g.M ? w[(tap * g.C + c) * g.M + n] : zero;
    }
  }
}

// One k-step of one tap: the warp's MI x NI mma tiles (16 x 8 each),
// A row (mi, h) at halo position hrow[mi][h] + d, B columns col0.. of
// the tap's [kc][LDB] filter slice at row kk.  fp32 in 3xTF32.
template <int MI, int NI, int LDB>
__device__ __forceinline__ void mma_rows(float (*acc)[NI][4],
                                         const float* Xs, int ldx,
                                         int (*hrow)[2], int d,
                                         const float* Bk, int col0, int g,
                                         int t) {
  uint32_t ab[MI][4], as[MI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const float* a0 = Xs + (hrow[mi][0] + d) * ldx + t;
    const float* a1 = Xs + (hrow[mi][1] + d) * ldx + t;
    split_tf32(a0[0], ab[mi][0], as[mi][0]);
    split_tf32(a1[0], ab[mi][1], as[mi][1]);
    split_tf32(a0[4], ab[mi][2], as[mi][2]);
    split_tf32(a1[4], ab[mi][3], as[mi][3]);
  }
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    const float* b = Bk + t * LDB + col0 + ni * 8 + g;
    uint32_t bb[2], bs[2];
    split_tf32(b[0], bb[0], bs[0]);
    split_tf32(b[4 * LDB], bb[1], bs[1]);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
      mma_3xtf32(acc[mi][ni], ab[mi], as[mi], bb, bs);
  }
}

// the same on bf16 (m16n8k16)
template <int MI, int NI, int LDB>
__device__ __forceinline__ void mma_rows(float (*acc)[NI][4],
                                         const __nv_bfloat16* Xs, int ldx,
                                         int (*hrow)[2], int d,
                                         const __nv_bfloat16* Bk, int col0,
                                         int g, int t) {
  uint32_t a[MI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const __nv_bfloat16* a0 = Xs + (hrow[mi][0] + d) * ldx + 2 * t;
    const __nv_bfloat16* a1 = Xs + (hrow[mi][1] + d) * ldx + 2 * t;
    a[mi][0] = *reinterpret_cast<const uint32_t*>(a0);
    a[mi][1] = *reinterpret_cast<const uint32_t*>(a1);
    a[mi][2] = *reinterpret_cast<const uint32_t*>(a0 + 8);
    a[mi][3] = *reinterpret_cast<const uint32_t*>(a1 + 8);
  }
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    const __nv_bfloat16* bp = Bk + 2 * t * LDB + col0 + ni * 8 + g;
    uint32_t b[2];
    b[0] = pack_bf16(bp[0], bp[LDB]);
    b[1] = pack_bf16(bp[8 * LDB], bp[9 * LDB]);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) mma_bf16(acc[mi][ni], a[mi], b);
  }
}

template <typename T, int MI, int NI>
__global__ void __launch_bounds__(kThreads)
direct_conv_tc_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      T* __restrict__ out, float* __restrict__ ws,
                      int* __restrict__ counters, DirectGeo geo, int splits,
                      int vec_a, int vec_b) {
  using L = DTile<T, MI, NI>;
  constexpr int KS = KStep<T>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // per halo position: the input offset of its channel 0, or -1 where it
  // falls in the padding
  int* pos = reinterpret_cast<int*>(smem_raw);
  T* ring = reinterpret_cast<T*>(smem_raw + pos_bytes(geo));
  // per tile row: its output pixel's index, or -1 where it holds none
  __shared__ int opix[L::BM];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int row0 = (warp >> 1) * 16 * MI, col0 = (warp & 1) * 8 * NI;
  const int n0 = blockIdx.y * L::BN;
  const int z = blockIdx.z;
  const int per_img = geo.tiles_h * geo.tiles_w;
  const int img = blockIdx.x / per_img;
  const int rem = blockIdx.x - img * per_img;
  const int th = rem / geo.tiles_w, tw = rem - th * geo.tiles_w;
  const int oh0 = th * geo.TH, ow0 = tw * geo.TW;
  const int ih0 = oh0 * geo.sh - geo.ph, iw0 = ow0 * geo.sw - geo.pw;
  const int halo = geo.IHT * geo.IWT;
  const int pix = geo.TH * geo.TW;
  const int ldx = geo.kc + RingPad<T>::A;
  const int stage = stage_elems<T, MI, NI>(geo);
  const int x_elems = halo * ldx;
  const int taps = geo.KH * geo.KW;

  for (int e = tid; e < halo; e += kThreads) {
    const int ii = e / geo.IWT, jj = e - ii * geo.IWT;
    const int ih = ih0 + ii, iw = iw0 + jj;
    pos[e] = (unsigned)ih < (unsigned)geo.H && (unsigned)iw < (unsigned)geo.W
                 ? ((img * geo.H + ih) * geo.W + iw) * geo.C
                 : -1;
  }
  for (int r = tid; r < L::BM; r += kThreads) {
    const int oh = oh0 + r / geo.TW, ow = ow0 + r % geo.TW;
    opix[r] = r < pix && oh < geo.OH && ow < geo.OW
                  ? (img * geo.OH + oh) * geo.OW + ow
                  : -1;
  }
  // this lane's A rows at tap (0, 0); rows past the tile read position 0
  int hrow[MI][2];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + mi * 16 + g + 8 * h;
      const int tr = r / geo.TW, tc = r - tr * geo.TW;
      hrow[mi][h] = r < pix ? tr * geo.sh * geo.IWT + tc * geo.sw : 0;
    }
  __syncthreads();

  // this split's fixed run of whole chunks
  int s_begin, s_end;
  split_steps(z, splits, geo.chunks, s_begin, s_end);
  const int nk = s_end - s_begin;

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

  for (int s = 0; s < geo.stages - 1; ++s) {
    if (s < nk) {
      T* st = ring + s * stage;
      load_chunk<T, MI, NI>(st, st + x_elems, x, w, pos, geo, n0,
                            (s_begin + s) * geo.kc, vec_a, vec_b, tid);
    }
    cp_async_commit();
  }
#pragma unroll 1
  for (int kt = 0; kt < nk; ++kt) {
    if (geo.stages == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();  // chunk kt landed; the slot of chunk kt - 1 is free
    const int nxt = kt + geo.stages - 1;
    if (nxt < nk) {
      T* st = ring + (nxt % geo.stages) * stage;
      load_chunk<T, MI, NI>(st, st + x_elems, x, w, pos, geo, n0,
                            (s_begin + nxt) * geo.kc, vec_a, vec_b, tid);
    }
    cp_async_commit();
    const T* Xs = ring + (kt % geo.stages) * stage;
    const T* Ws = Xs + x_elems;
    int di = 0, dj = 0;
#pragma unroll 1
    for (int tap = 0; tap < taps; ++tap) {
      const int d = di * geo.IWT + dj;
      const T* Wt = Ws + tap * geo.kc * L::LDB;
#pragma unroll 1
      for (int kk = 0; kk < geo.kc; kk += KS)
        mma_rows<MI, NI, L::LDB>(acc, Xs + kk, ldx, hrow, d,
                                 Wt + kk * L::LDB, col0, g, t);
      if (++dj == geo.KW) {
        dj = 0;
        ++di;
      }
    }
  }
  cp_async_wait<0>();

  // The finished fp32 tile goes to shared memory over the drained ring;
  // the split reduction and the write read it from there.  This lane's
  // accumulator (mi, ni, q) sits at tile row / column
  //   row0 + mi*16 + g + 8*(q/2),  col0 + ni*8 + 2t + q%2
  float* Rs = reinterpret_cast<float*>(ring);
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

  constexpr int TILE = L::BM * L::BN;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (splits > 1) {
    // this split's partial tile to the tile-major workspace in 16-byte
    // stores; the last block of the tile sums the partials in split order
    // back into shared memory
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

  // one write in the input dtype
#pragma unroll 1
  for (int e = tid; e < TILE; e += kThreads) {
    const int r = e / L::BN, c = e % L::BN;
    const int p = opix[r], m = n0 + c;
    if (p < 0 || m >= geo.M) continue;
    out[(int64_t)p * geo.M + m] = from_f32<T>(Rs[r * L::LDR + c]);
  }
  if (splits > 1) split_reset(counters, tile);
}

template <typename T, int MI, int NI>
static int launch(const void* x, const void* w, void* out, void* ws,
                  void* counters, const DirectGeo& geo, int tiles,
                  int splits, int vec_a, int vec_b, int smem,
                  cudaStream_t stream) {
  using L = DTile<T, MI, NI>;
  constexpr int V = VecOf<T>::kElems;
  const bool a_ok = geo.C % V == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool b_ok = geo.M % V == 0 &&
                    reinterpret_cast<uintptr_t>(w) % 16 == 0;
  // the split reduction indexes the workspace with ints
  const bool ws_ok =
      splits == 1 ||
      (ws != nullptr && counters != nullptr &&
       (int64_t)splits * tiles * L::BM * L::BN <= INT32_MAX);
  const int n_tiles = (geo.M + L::BN - 1) / L::BN;
  const int64_t m_tiles = (int64_t)geo.N * geo.tiles_h * geo.tiles_w;
  if (smem != smem_model<T, MI, NI>(geo) || splits < 1 ||
      splits > geo.chunks || splits > 65535 || !ws_ok ||
      geo.TH * geo.TW > L::BM || geo.TH < 1 || geo.TW < 1 ||
      geo.kc % KStep<T>::value != 0 || (geo.stages != 2 && geo.stages != 3) ||
      tiles != m_tiles * n_tiles || m_tiles > INT32_MAX ||
      n_tiles > 65535 || (vec_a && !a_ok) || (vec_b && !b_ok))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = direct_conv_tc_kernel<T, MI, NI>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>(m_tiles), n_tiles, splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), static_cast<float*>(ws),
      static_cast<int*>(counters), geo, splits, vec_a, vec_b);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MI>
static int launch_bn(const void* x, const void* w, void* out, void* ws,
                     void* counters, const DirectGeo& geo, int bn, int tiles,
                     int splits, int vec_a, int vec_b, int smem,
                     cudaStream_t s) {
  if (bn == 64)
    return launch<T, MI, 4>(x, w, out, ws, counters, geo, tiles, splits,
                            vec_a, vec_b, smem, s);
  if (bn == 32)
    return launch<T, MI, 2>(x, w, out, ws, counters, geo, tiles, splits,
                            vec_a, vec_b, smem, s);
  if (bn == 16)
    return launch<T, MI, 1>(x, w, out, ws, counters, geo, tiles, splits,
                            vec_a, vec_b, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
static int launch_tile(const void* x, const void* w, void* out, void* ws,
                       void* counters, const DirectGeo& geo, int bm, int bn,
                       int tiles, int splits, int vec_a, int vec_b, int smem,
                       cudaStream_t s) {
  if (bm == 64)
    return launch_bn<T, 2>(x, w, out, ws, counters, geo, bn, tiles, splits,
                           vec_a, vec_b, smem, s);
  if (bm == 32)
    return launch_bn<T, 1>(x, w, out, ws, counters, geo, bn, tiles, splits,
                           vec_a, vec_b, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

REPRO_ERROR_STRING_EXPORT

REPRO_EXPORT int direct_conv_launch(
    const void* x, const void* w, void* out, void* ws, void* counters,
    int dtype, int N, int H, int W, int C, int KH, int KW, int M, int sh,
    int sw, int ph, int pw, int OH, int OW, int th, int tw, int bm, int bn,
    int kc, int stages, int tiles, int splits, int vec_a, int vec_b,
    int smem, void* stream) {
  if (th < 1 || tw < 1 || kc < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  DirectGeo geo{N, H, W, C, KH, KW, M, sh, sw, ph, pw, OH, OW,
                th, tw, (OH + th - 1) / th, (OW + tw - 1) / tw,
                (th - 1) * sh + KH, (tw - 1) * sw + KW,
                kc, (C + kc - 1) / kc, stages};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_tile<float>(x, w, out, ws, counters, geo, bm, bn, tiles,
                              splits, vec_a, vec_b, smem, s);
  if (dtype == kBFloat16)
    return launch_tile<__nv_bfloat16>(x, w, out, ws, counters, geo, bm, bn,
                                      tiles, splits, vec_a, vec_b, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
