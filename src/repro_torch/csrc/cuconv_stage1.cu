// stage1_tap_gemm: the paper's stage 1 (scalar_prods_kernel) — one GEMM
// per filter tap,
//   out[t] (P x M, fp32) = A_t (P x C) @ w[t] (C x M),  t = 0..T-1,
// the temporaries written to device memory on purpose: they are the
// faithful two-stage memory behaviour that the fused kernel is measured
// against, and stage 2 (cuconv_stage2.cu) sums them over t.
//
// Replaces kernels/cuconv_stage1.py::stage1_tap_gemm of the JAX package
// (the Pallas kernel that pins one tap's filter block in VMEM and streams
// the tap's shifted input view past it on the MXU).  What bounds it on
// the H100: at the paper's rows (t4_A: 9 taps of 49 x 192 x 384, 65
// MFLOP; t5_A: 25 taps of 49 x 48 x 128) the bytes, above all the T*P*M*4
// bytes of temporaries and the filter, against a few microseconds of
// 3xTF32 products (495/3 TFLOP/s; 989 in bf16).  At these sizes what
// decides the time is how many blocks are in flight and how well the
// loads overlap the products.
//
// Design:
//  - A batched GEMM on the tensor cores: fp32 as mma.sync m16n8k8 on TF32
//    in the 3xTF32 split, bf16 as mma.sync m16n8k16, fp32 accumulation in
//    registers (mma_tf32.cuh).  A block of 4 warps (2 x 2) computes BM =
//    64 or 32 rows x BN = 64, 32 or 16 channels of one tap, the tap on
//    blockIdx.z; kernels/cuconv_stage1.py::launch_geometry picks the tile
//    from (T, P, C, M) so the launch fills the 132 SMs without splitting
//    C.  The plan's tp/tm/tc size nothing.
//  - No stack of shifted views: the kernel reads A through a row rule.
//    Tap t = (di, dj) = (t / KW, t % KW) starts at di*tap_row + dj*tap_col
//    elements, and row p = (n, oh, ow) = (p / OHW, p % OHW / OW, p % OW)
//    sits at n*img + oh*row + ow*C after it.  For a padded NHWC input
//    (N, Hp, Wp, C) that is xp[n, oh + di, ow + dj, :]; for a stacked
//    (T, P, C) input, KW = T, tap_col = P*C, OHW = OW = P and row p at
//    p*C.  One kernel serves both entries, and they read the same values.
//  - A and B go through a 3-stage ring in shared memory filled by 16-byte
//    cp.async (zero-fill past the edges) while the tensor cores work on an
//    earlier stage; each row's offset is computed once per block.  Where
//    C or M is not a multiple of 16 bytes, or a base pointer is not
//    16-byte aligned, masked scalar loads fill the same ring.
//  - The finished fp32 tile goes to shared memory over the drained ring
//    and out to the temporaries in 16-byte stores where M is a multiple
//    of 4.
#include "common.cuh"
#include "mma_tf32.cuh"

constexpr int kThreads = 128;  // 4 warps, 2 x 2
constexpr int kBK = 32;        // contraction depth per stage
constexpr int kStages = 3;

// where row p of tap t starts in the input (see the header)
struct RowRule {
  int T, P, C, M;
  int KW, tap_row, tap_col;
  int OHW, OW, img, row;
};

// kernels/cuconv_stage1.py::smem_bytes models the same shared memory
template <typename T, int MI, int NI>
struct STile {
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
__device__ __forceinline__ void load_stage(T* As, T* Bs,
                                           const T* __restrict__ xt,
                                           const T* __restrict__ wt,
                                           const int* __restrict__ rows,
                                           const RowRule& rr, int n0, int k0,
                                           bool vec_a, bool vec_b, int tid) {
  using L = STile<T, MI, NI>;
  constexpr int V = VecOf<T>::kElems;
  const T zero = from_f32<T>(0.f);
  // A: rows of this tap's view, each thread one k column
  if (vec_a) {
    constexpr int CPR = kBK / V;           // 16-byte chunks per tile row
    const int cc = tid % CPR;
    const int k = k0 + cc * V;
    for (int r = tid / CPR; r < L::BM; r += kThreads / CPR) {
      const int off = rows[r];
      const bool ok = off >= 0 && k < rr.C;
      cp_async16(As + r * L::LDA + cc * V, ok ? xt + off + k : xt, ok);
    }
  } else {
    const int kk = tid % kBK;
    const int k = k0 + kk;
    for (int r = tid / kBK; r < L::BM; r += kThreads / kBK) {
      const int off = rows[r];
      As[r * L::LDA + kk] = off >= 0 && k < rr.C ? xt[off + k] : zero;
    }
  }
  // B: rows k0..k0+kBK of this tap's (C, M) filter, columns n0..n0+BN
  if (vec_b) {
    for (int e = tid; e < kBK * L::BN / V; e += kThreads) {
      const int r = e / (L::BN / V), cc = (e % (L::BN / V)) * V;
      const int k = k0 + r, n = n0 + cc;
      const bool ok = k < rr.C && n < rr.M;
      cp_async16(Bs + r * L::LDB + cc, ok ? wt + k * rr.M + n : wt, ok);
    }
  } else {
    for (int e = tid; e < kBK * L::BN; e += kThreads) {
      const int r = e / L::BN, cc = e % L::BN;
      const int k = k0 + r, n = n0 + cc;
      Bs[r * L::LDB + cc] = k < rr.C && n < rr.M ? wt[k * rr.M + n] : zero;
    }
  }
}

template <typename T, int MI, int NI>
__global__ void __launch_bounds__(kThreads)
stage1_tc_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 float* __restrict__ out, RowRule rr, int vec_a, int vec_b,
                 int vec_out) {
  using L = STile<T, MI, NI>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);
  T* Bs = As + kStages * L::A_ELEMS;
  // each tile row's offset after the tap's start, or -1 past P
  __shared__ int rows[L::BM];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int row0 = (warp >> 1) * 16 * MI, col0 = (warp & 1) * 8 * NI;
  const int p0 = blockIdx.x * L::BM, n0 = blockIdx.y * L::BN;
  const int tap = blockIdx.z;
  const int di = tap / rr.KW, dj = tap - di * rr.KW;
  const T* xt = x + di * rr.tap_row + dj * rr.tap_col;
  const T* wt = w + (int64_t)tap * rr.C * rr.M;

  for (int r = tid; r < L::BM; r += kThreads) {
    const int p = p0 + r;
    int off = -1;
    if (p < rr.P) {
      const int n = p / rr.OHW, rem = p - n * rr.OHW;
      const int oh = rem / rr.OW, ow = rem - oh * rr.OW;
      off = n * rr.img + oh * rr.row + ow * rr.C;
    }
    rows[r] = off;
  }
  __syncthreads();

  const int nk = (rr.C + kBK - 1) / kBK;
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
      load_stage<T, MI, NI>(As + s * L::A_ELEMS, Bs + s * L::B_ELEMS, xt, wt,
                            rows, rr, n0, s * kBK, vec_a, vec_b, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 is free again
    const int nxt = kt + kStages - 1;
    if (nxt < nk) {
      const int slot = nxt % kStages;
      load_stage<T, MI, NI>(As + slot * L::A_ELEMS, Bs + slot * L::B_ELEMS,
                            xt, wt, rows, rr, n0, nxt * kBK, vec_a, vec_b,
                            tid);
    }
    cp_async_commit();
    const int slot = kt % kStages;
    warp_mma_stage<MI, NI, L::LDA, L::LDB, kBK>(
        acc, As + slot * L::A_ELEMS, Bs + slot * L::B_ELEMS, row0, col0, g,
        t);
  }
  cp_async_wait<0>();

  // the finished tile to shared memory over the drained ring; this lane's
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

  // the temporaries of this tap: out[tap][p][m], one loop over the tile
  float* ot = out + (int64_t)tap * rr.P * rr.M;
  if (vec_out) {
    // M % 4 == 0: a run of 4 columns is all inside M or all past it
    constexpr int C4 = L::BN / 4;
#pragma unroll 1
    for (int e = tid; e < L::BM * C4; e += kThreads) {
      const int r = e / C4, c = (e - r * C4) * 4;
      const int p = p0 + r, m = n0 + c;
      if (p < rr.P && m < rr.M)
        *reinterpret_cast<float4*>(ot + (int64_t)p * rr.M + m) =
            *reinterpret_cast<const float4*>(Rs + r * L::LDR + c);
    }
  } else {
#pragma unroll 1
    for (int e = tid; e < L::BM * L::BN; e += kThreads) {
      const int r = e / L::BN, c = e - r * L::BN;
      const int p = p0 + r, m = n0 + c;
      if (p < rr.P && m < rr.M)
        ot[(int64_t)p * rr.M + m] = Rs[r * L::LDR + c];
    }
  }
}

template <typename T, int MI, int NI>
static int launch(const void* x, const void* w, void* out, const RowRule& rr,
                  int tiles, int vec_a, int vec_b, int smem,
                  cudaStream_t stream) {
  using L = STile<T, MI, NI>;
  constexpr int V = VecOf<T>::kElems;
  const bool a_ok = rr.C % V == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool b_ok = rr.M % V == 0 &&
                    reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int vec_out = rr.M % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int m_tiles = (rr.P + L::BM - 1) / L::BM;
  const int n_tiles = (rr.M + L::BN - 1) / L::BN;
  if (smem != L::SMEM || tiles != m_tiles * n_tiles || (vec_a && !a_ok) ||
      (vec_b && !b_ok) || rr.KW < 1 || rr.T < 1 || rr.T > 65535 ||
      n_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = stage1_tc_kernel<T, MI, NI>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(m_tiles, n_tiles, rr.T);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<float*>(out), rr, vec_a, vec_b, vec_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MI>
static int launch_bn(const void* x, const void* w, void* out,
                     const RowRule& rr, int bn, int tiles, int vec_a,
                     int vec_b, int smem, cudaStream_t s) {
  if (bn == 64)
    return launch<T, MI, 4>(x, w, out, rr, tiles, vec_a, vec_b, smem, s);
  if (bn == 32)
    return launch<T, MI, 2>(x, w, out, rr, tiles, vec_a, vec_b, smem, s);
  if (bn == 16)
    return launch<T, MI, 1>(x, w, out, rr, tiles, vec_a, vec_b, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
static int launch_tile(const void* x, const void* w, void* out,
                       const RowRule& rr, int bm, int bn, int tiles,
                       int vec_a, int vec_b, int smem, cudaStream_t s) {
  if (bm == 64)
    return launch_bn<T, 2>(x, w, out, rr, bn, tiles, vec_a, vec_b, smem, s);
  if (bm == 32)
    return launch_bn<T, 1>(x, w, out, rr, bn, tiles, vec_a, vec_b, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

REPRO_ERROR_STRING_EXPORT

REPRO_EXPORT int stage1_tap_gemm_launch(
    const void* x, const void* w, void* out, int dtype, int T, int P, int C,
    int M, int KW, int tap_row, int tap_col, int OHW, int OW, int img,
    int row, int bm, int bn, int tiles, int vec_a, int vec_b, int smem,
    void* stream) {
  const RowRule rr{T, P, C, M, KW, tap_row, tap_col, OHW, OW, img, row};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_tile<float>(x, w, out, rr, bm, bn, tiles, vec_a, vec_b,
                              smem, s);
  if (dtype == kBFloat16)
    return launch_tile<__nv_bfloat16>(x, w, out, rr, bm, bn, tiles, vec_a,
                                      vec_b, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
