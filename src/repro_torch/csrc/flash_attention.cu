// flash_attention: softmax(Q K^T / sqrt(D)) V, forward, with GQA,
//   q (B, Sq, H, D), k and v (B, Sk, KVH, D), out (B, Sq, H, D), all
//   contiguous; query head h reads key/value head h / (H / KVH).
// The (BH, S, D) layout is the case H = KVH = 1.  Causal masking is
// top-left aligned (query i sees keys 0..i), as in the TPU kernel: right
// for a prefill that starts at position 0.
//
// Replaces kernels/flash_attention.py::flash_attention of the JAX
// package (the Pallas kernel whose "arbitrary" KV grid dimension carries
// m, l and the accumulator in VMEM scratch).  The numerics are that
// kernel's: scores summed in fp32, scaled by 1/sqrt(D) in fp32 after the
// dot, masked to -1e30 (keys past Sk and, if causal, keys after the
// query), an online softmax with fp32 m, l and accumulator, p rounded to
// v's dtype before P V, and one division by max(l, 1e-30) at the end.
//
// What bounds it on the H100: operations at long sequences (4 D FLOPs
// per visible query-key pair: 51.5 GFLOP at S = 4096, H = 12, D = 128,
// on the bf16 tensor cores at 989 TFLOP/s), bytes at the served prefill
// (B = 4, S = 512: 14.7 MB in bf16 against 3.2 GFLOP).
//
// Design, after FlashAttention-2.  One block of 4 warps per (64 query
// rows, head, batch); each warp owns 16 query rows.  The grid runs the
// query tiles heaviest first (reverse blockIdx.x), so the causal grid's
// long tiles do not trail the launch.
//  - bf16: Q is staged once and held in registers as mma A fragments
//    (ldmatrix).  Per KV tile of 64 keys, S = Q K^T runs on mma.sync
//    m16n8k16 with fp32 accumulation (a product of two bf16 values is
//    exact in fp32, so only the order of summation changes); the scale,
//    the mask and the online softmax run on the accumulator fragments in
//    registers, with quad shuffles for the row max and sum; p is rounded
//    to bf16 in registers and is directly the A operand of P V (the
//    m16n8 C fragment of two key groups is the m16n8k16 A fragment), with
//    V's B fragments from ldmatrix.trans.  No score touches shared memory.
//  - fp32: both products in 3xTF32 on mma.sync m16n8k8, p kept in fp32
//    (v's dtype): the m16n8 C fragment of 8 keys is an m16n8k8 A fragment
//    with its k order permuted (key 2t as k = t, key 2t + 1 as k = t + 4),
//    and V's B fragment is read in the same order.
//  - K and V tiles stay in the input dtype in shared memory, swizzled
//    (16-byte chunk c of row r at c ^ (r & 7), so the fragment loads are
//    conflict-free), double-buffered by 16-byte cp.async: the next tile
//    is in flight while the current one is computed, with one
//    __syncthreads per tile (a third stage measured no faster).  Where D is not a multiple of the vector or a pointer is
//    not 16-byte aligned, masked scalar loads fill the same buffers.  The
//    head dimension is padded with zeros to DP = 64 or 128.
//  - Tiles past the causal diagonal are skipped; masks are computed only
//    on tiles that need them.  exp(x) is computed as exp2f(x log2 e), one
//    MUFU.EX2 and a multiply.
// Shared memory: Q + 2 x (K + V) tiles of 64 x DP, in the input dtype:
// 81,920 bytes at D = 128 in bf16 (two blocks per SM), 163,840 in fp32
// (one); kernels/flash_attention.py::launch_geometry is that same model.
#include "common.cuh"
#include "mma_tf32.cuh"

constexpr int kFaBQ = 64;          // query rows per block
constexpr int kFaBK = 64;          // keys per KV tile
constexpr int kFaThreads = 128;    // 4 warps x 16 query rows
constexpr int kFaStages = 2;       // K/V ring depth: double-buffered
constexpr float kFaNegInf = -1e30f;
constexpr float kFaLog2e = 1.4426950408889634f;

template <typename T, int DP>
struct FaTile {
  static constexpr int V = 16 / sizeof(T);     // elements per chunk
  static constexpr int ELEMS = kFaBQ * DP;     // one Q, K or V tile
  static constexpr int SMEM = (1 + 2 * kFaStages) * ELEMS * sizeof(T);
  static_assert(DP / V >= 8, "the swizzle needs 8 chunks per row");
};

// element offset of (row, col) in a swizzled [64][DP] tile
template <typename T, int DP>
__device__ __forceinline__ int swz(int row, int col) {
  constexpr int V = FaTile<T, DP>::V;
  return row * DP + (((col / V) ^ (row & 7)) * V) + (col % V);
}

// rows row0.. of a (rows, D) slab with `stride` elements between rows into
// a swizzled tile; rows past `nrows` and columns past D are zero
template <typename T, int DP>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          int64_t stride, int row0,
                                          int nrows, int D, bool vec,
                                          int tid) {
  constexpr int V = FaTile<T, DP>::V, CPR = DP / V;
  if (vec) {
    for (int e = tid; e < kFaBK * CPR; e += kFaThreads) {
      const int r = e / CPR, c = (e % CPR) * V;
      const bool ok = row0 + r < nrows && c < D;
      cp_async16(dst + swz<T, DP>(r, c),
                 ok ? src + (row0 + r) * stride + c : src, ok);
    }
  } else {
    for (int e = tid; e < kFaBK * DP; e += kFaThreads) {
      const int r = e / DP, c = e % DP;
      const bool ok = row0 + r < nrows && c < D;
      dst[swz<T, DP>(r, c)] =
          ok ? src[(row0 + r) * stride + c] : from_f32<T>(0.f);
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// S = Q K^T for the warp's 16 rows x 64 keys: bf16 from Q fragments in
// registers and K by ldmatrix
template <int DP>
__device__ __forceinline__ void scores(float (*s)[4], const uint32_t (*qf)[4],
                                       const __nv_bfloat16* Ks, int lane) {
#pragma unroll
  for (int kd = 0; kd < DP / 16; ++kd) {
#pragma unroll
    for (int nj = 0; nj < 8; nj += 2) {
      uint32_t kb[4];
      const int key = nj * 8 + (lane & 7) + 8 * (lane >> 4);
      const int col = kd * 16 + 8 * ((lane >> 3) & 1);
      ldmatrix_x4(kb, Ks + swz<__nv_bfloat16, DP>(key, col));
      mma_bf16(s[nj], qf[kd], kb);
      mma_bf16(s[nj + 1], qf[kd], kb + 2);
    }
  }
}

// the same in 3xTF32: Q fragments from shared memory, split per use
template <int DP>
__device__ __forceinline__ void scores(float (*s)[4], const float* Qs,
                                       const float* Ks, int wrow, int g,
                                       int t) {
#pragma unroll 2
  for (int kd = 0; kd < DP / 8; ++kd) {
    const int c = kd * 8 + t;
    uint32_t ab[4], as[4];
    split_tf32(Qs[swz<float, DP>(wrow + g, c)], ab[0], as[0]);
    split_tf32(Qs[swz<float, DP>(wrow + g + 8, c)], ab[1], as[1]);
    split_tf32(Qs[swz<float, DP>(wrow + g, c + 4)], ab[2], as[2]);
    split_tf32(Qs[swz<float, DP>(wrow + g + 8, c + 4)], ab[3], as[3]);
#pragma unroll
    for (int nj = 0; nj < 8; ++nj) {
      uint32_t bb[2], bs[2];
      split_tf32(Ks[swz<float, DP>(nj * 8 + g, c)], bb[0], bs[0]);
      split_tf32(Ks[swz<float, DP>(nj * 8 + g, c + 4)], bb[1], bs[1]);
      mma_3xtf32(s[nj], ab, as, bb, bs);
    }
  }
}

// o += P V for 64 keys: bf16, P's fragments rounded in registers
template <int DP>
__device__ __forceinline__ void add_pv(float (*o)[4], const float (*p)[4],
                                       const __nv_bfloat16* Vs, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    const float* p0 = p[2 * kk];
    const float* p1 = p[2 * kk + 1];
    a[0] = pack_bf16(__float2bfloat16(p0[0]), __float2bfloat16(p0[1]));
    a[1] = pack_bf16(__float2bfloat16(p0[2]), __float2bfloat16(p0[3]));
    a[2] = pack_bf16(__float2bfloat16(p1[0]), __float2bfloat16(p1[1]));
    a[3] = pack_bf16(__float2bfloat16(p1[2]), __float2bfloat16(p1[3]));
    const int key = kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int dn = 0; dn < DP / 8; dn += 2) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb,
                        Vs + swz<__nv_bfloat16, DP>(key, dn * 8 +
                                                             8 * (lane >> 4)));
      mma_bf16(o[dn], a, vb);
      mma_bf16(o[dn + 1], a, vb + 2);
    }
  }
}

// the same in 3xTF32 with P in fp32: key 2t is k = t, key 2t + 1 is k = t + 4
// (unrolled in full: p stays in registers only under constant indices)
template <int DP>
__device__ __forceinline__ void add_pv(float (*o)[4], const float (*p)[4],
                                       const float* Vs, int g, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t ab[4], as[4];
    split_tf32(p[j][0], ab[0], as[0]);
    split_tf32(p[j][2], ab[1], as[1]);
    split_tf32(p[j][1], ab[2], as[2]);
    split_tf32(p[j][3], ab[3], as[3]);
    const int key = j * 8 + 2 * t;
#pragma unroll
    for (int dn = 0; dn < DP / 8; ++dn) {
      uint32_t bb[2], bs[2];
      split_tf32(Vs[swz<float, DP>(key, dn * 8 + g)], bb[0], bs[0]);
      split_tf32(Vs[swz<float, DP>(key + 1, dn * 8 + g)], bb[1], bs[1]);
      mma_3xtf32(o[dn], ab, as, bb, bs);
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kFaThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H,
                       int KVH, int Sq, int Sk, int D, float scale,
                       int causal, int vec) {
  using L = FaTile<T, DP>;
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + L::ELEMS;                     // kFaStages tiles
  T* Vs = Ks + kFaStages * L::ELEMS;         // kFaStages tiles

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int wrow = warp * 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kFaBQ;   // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int64_t q_row = (int64_t)H * D;      // elements between positions
  const int64_t kv_row = (int64_t)KVH * D;
  const T* qp = q + (int64_t)b * Sq * q_row + (int64_t)h * D;
  const T* kp = k + (int64_t)b * Sk * kv_row + (int64_t)kvh * D;
  const T* vp = v + (int64_t)b * Sk * kv_row + (int64_t)kvh * D;
  T* op = o + (int64_t)b * Sq * q_row + (int64_t)h * D;

  const int q_last = min(q0 + kFaBQ, Sq) - 1;
  int n_tiles = (Sk + kFaBK - 1) / kFaBK;
  if (causal) n_tiles = min(n_tiles, q_last / kFaBK + 1);

  // the ring runs kFaStages - 1 tiles ahead; Q goes with tile 0
  load_tile<T, DP>(Qs, qp, q_row, q0, Sq, D, vec, tid);
#pragma unroll
  for (int st = 0; st < kFaStages - 1; ++st) {
    if (st < n_tiles) {
      load_tile<T, DP>(Ks + st * L::ELEMS, kp, kv_row, st * kFaBK, Sk, D, vec,
                       tid);
      load_tile<T, DP>(Vs + st * L::ELEMS, vp, kv_row, st * kFaBK, Sk, D, vec,
                       tid);
    }
    cp_async_commit();
  }

  // the warp's rows g and g + 8: running max, denominator, accumulator
  float m_r[2] = {kFaNegInf, kFaNegInf}, l_r[2] = {0.f, 0.f};
  float acc[DP / 8][4];
#pragma unroll
  for (int dn = 0; dn < DP / 8; ++dn)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dn][i] = 0.f;
  uint32_t qf[kBf16 ? DP / 16 : 1][4];       // bf16: Q's A fragments

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kFaStages - 2>();
    __syncthreads();   // tile it landed; tile it - 1's buffers are free
    if constexpr (kBf16) {
      if (it == 0) {
#pragma unroll
        for (int kd = 0; kd < DP / 16; ++kd) {
          const int row = wrow + (lane & 7) + 8 * ((lane >> 3) & 1);
          ldmatrix_x4(qf[kd], Qs + swz<T, DP>(row, kd * 16 + 8 * (lane >> 4)));
        }
      }
    }
    const int nxt = it + kFaStages - 1;
    if (nxt < n_tiles) {
      const int slot = nxt % kFaStages;
      load_tile<T, DP>(Ks + slot * L::ELEMS, kp, kv_row, nxt * kFaBK, Sk, D,
                       vec, tid);
      load_tile<T, DP>(Vs + slot * L::ELEMS, vp, kv_row, nxt * kFaBK, Sk, D,
                       vec, tid);
    }
    cp_async_commit();
    const T* Kt = Ks + (it % kFaStages) * L::ELEMS;
    const T* Vt = Vs + (it % kFaStages) * L::ELEMS;

    // S = Q K^T; fragment s[nj][i] is row g + 8 (i / 2), key nj*8 + 2t + i%2
    float s[8][4];
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nj][i] = 0.f;
    if constexpr (kBf16)
      scores<DP>(s, qf, Kt, lane);
    else
      scores<DP>(s, Qs, Kt, wrow, g, t);

    // scale after the dot, then the mask where this tile needs one
    const int k0 = it * kFaBK;
    const bool masked =
        k0 + kFaBK > Sk || (causal && k0 + kFaBK - 1 > q0 + wrow);
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float val = s[nj][i] * scale;
        if (masked) {
          const int key = k0 + nj * 8 + 2 * t + (i & 1);
          const int row = q0 + wrow + g + 8 * (i >> 1);
          if (key >= Sk || (causal && row < key)) val = kFaNegInf;
        }
        s[nj][i] = val;
      }

    // online softmax on the fragments: a row's 64 scores sit in one quad
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = kFaNegInf;
#pragma unroll
      for (int nj = 0; nj < 8; ++nj)
        mx = fmaxf(mx, fmaxf(s[nj][2 * rr], s[nj][2 * rr + 1]));
      const float m_new = fmaxf(m_r[rr], quad_max(mx));
      const float corr = exp2f((m_r[rr] - m_new) * kFaLog2e);
      float sum = 0.f;
#pragma unroll
      for (int nj = 0; nj < 8; ++nj)
#pragma unroll
        for (int i = 2 * rr; i < 2 * rr + 2; ++i) {
          const float p = s[nj][i] <= kFaNegInf
                              ? 0.f
                              : exp2f((s[nj][i] - m_new) * kFaLog2e);
          s[nj][i] = p;
          sum += p;
        }
      l_r[rr] = l_r[rr] * corr + quad_sum(sum);
      m_r[rr] = m_new;
#pragma unroll
      for (int dn = 0; dn < DP / 8; ++dn) {
        acc[dn][2 * rr] *= corr;
        acc[dn][2 * rr + 1] *= corr;
      }
    }

    // acc += P V, p in v's dtype
    if constexpr (kBf16)
      add_pv<DP>(acc, s, Vt, lane);
    else
      add_pv<DP>(acc, s, Vt, g, t);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int gq = q0 + wrow + g + 8 * rr;
    if (gq >= Sq) continue;
    const float l = fmaxf(l_r[rr], 1e-30f);
#pragma unroll
    for (int dn = 0; dn < DP / 8; ++dn)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = dn * 8 + 2 * t + i;
        if (col < D)
          op[(int64_t)gq * q_row + col] = from_f32<T>(acc[dn][2 * rr + i] / l);
      }
  }
}

template <typename T, int DP>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          void* o, int B, int Sq, int Sk, int H, int KVH,
                          int D, float scale, int causal, int smem,
                          cudaStream_t s) {
  using L = FaTile<T, DP>;
  if (smem != L::SMEM) return cudaErrorInvalidValue;
  const bool vec = D % L::V == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  auto kernel = flash_attention_kernel<T, DP>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // two bf16 blocks of 80 KB share an SM only under a large carveout
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kFaBQ - 1) / kFaBQ, H, B);
  kernel<<<grid, kFaThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KVH, Sq, Sk, D, scale,
      causal, vec);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_dp(const void* q, const void* k, const void* v,
                             void* o, int B, int Sq, int Sk, int H, int KVH,
                             int D, int dp, float scale, int causal,
                             int smem, cudaStream_t s) {
  if (dp == 64 && D <= 64)
    return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, KVH, D, scale, causal,
                         smem, s);
  if (dp == 128 && D <= 128)
    return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, KVH, D, scale, causal,
                          smem, s);
  return cudaErrorInvalidValue;
}

REPRO_ERROR_STRING_EXPORT

REPRO_EXPORT int flash_attention_launch(const void* q, const void* k,
                                        const void* v, void* o, int dtype,
                                        int B, int Sq, int Sk, int H,
                                        int KVH, int D, int dp, float scale,
                                        int causal, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (KVH < 1 || H % KVH != 0) return static_cast<int>(err);
  if (dtype == kBFloat16)
    err = launch_dp<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KVH, D, dp,
                                   scale, causal, smem, s);
  else if (dtype == kFloat32)
    err = launch_dp<float>(q, k, v, o, B, Sq, Sk, H, KVH, D, dp, scale,
                           causal, smem, s);
  return static_cast<int>(err);
}
