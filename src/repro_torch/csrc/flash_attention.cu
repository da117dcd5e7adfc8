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
// per visible query-key pair: 51.5 GFLOP at S = 4096, H = 12, D = 128),
// bytes at the served prefill (B = 4, S = 512: 14.7 MB in bf16 against
// 3.2 GFLOP).  This first design computes in fp32 FFMA, so its real
// ceiling is 67 TFLOP/s, not the tensor cores' 989 in bf16.
//
// Design.  One block per (query tile of 64 rows, head, batch), 256
// threads.  The block stages its Q tile once, then loops over KV tiles of
// 64 keys (the TPU's sequential grid dimension), stopping after the tile
// that holds the causal diagonal.  Per tile: K and V into shared memory
// (fp32, rows padded by one word against bank conflicts; keys past Sk
// zero), S = Q K^T as a 4 x 4 register tile per thread, the masked and
// scaled scores into shared memory, then each warp updates m and l of 8
// rows with shuffles, writes p back, and every thread rescales and adds
// P V into its 4 x 8 accumulator (rows ty + 16a, columns tx + 16b, so
// head_dim <= 128).  No repeated K/V tensor exists: the kv head is an
// offset.  Shared memory is 4 * (64 (D+1) * 3 + 64 * 65 + 3 * 64) bytes,
// 116,480 at D = 128: kernels/flash_attention.py::smem_bytes is that
// same model.
#include "common.cuh"

constexpr int kFaBQ = 64;          // query rows per block
constexpr int kFaBK = 64;          // keys per KV tile
constexpr int kFaThreads = 256;    // 16 x 16
constexpr int kFaColTiles = 8;     // accumulator columns per thread: D <= 128
constexpr float kFaNegInf = -1e30f;

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kFaThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H,
                       int KVH, int Sq, int Sk, int D, float scale,
                       int causal) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  const int ldp = kFaBK + 1;
  float* Qs = smem;                          // [BQ][D + 1]
  float* Ks = Qs + kFaBQ * ld;               // [BK][D + 1]
  float* Vs = Ks + kFaBK * ld;               // [BK][D + 1]
  float* Ps = Vs + kFaBK * ld;               // [BQ][BK + 1]
  float* row_m = Ps + kFaBQ * ldp;           // running max
  float* row_l = row_m + kFaBQ;              // running denominator
  float* row_c = row_l + kFaBQ;              // this tile's correction

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * kFaBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int64_t q_row = (int64_t)H * D;      // elements between positions
  const int64_t kv_row = (int64_t)KVH * D;
  const T* qp = q + (int64_t)b * Sq * q_row + (int64_t)h * D;
  const T* kp = k + (int64_t)b * Sk * kv_row + (int64_t)kvh * D;
  const T* vp = v + (int64_t)b * Sk * kv_row + (int64_t)kvh * D;
  T* op = o + (int64_t)b * Sq * q_row + (int64_t)h * D;

  for (int e = tid; e < kFaBQ * D; e += kFaThreads) {
    const int r = e / D, c = e % D;
    const int gq = q0 + r;
    Qs[r * ld + c] = gq < Sq ? to_f32(qp[(int64_t)gq * q_row + c]) : 0.0f;
  }
  if (tid < kFaBQ) {
    row_m[tid] = kFaNegInf;
    row_l[tid] = 0.0f;
  }
  float acc[4][kFaColTiles];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kFaColTiles; ++c) acc[a][c] = 0.0f;

  const int q_last = min(q0 + kFaBQ, Sq) - 1;
  int n_tiles = (Sk + kFaBK - 1) / kFaBK;
  if (causal) n_tiles = min(n_tiles, q_last / kFaBK + 1);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kFaBK;
    __syncthreads();            // the last tile's reads of Ks, Vs, Ps done
    for (int e = tid; e < kFaBK * D; e += kFaThreads) {
      const int r = e / D, c = e % D;
      const int gk = k0 + r;
      const bool in = gk < Sk;
      Ks[r * ld + c] = in ? to_f32(kp[(int64_t)gk * kv_row + c]) : 0.0f;
      Vs[r * ld + c] = in ? to_f32(vp[(int64_t)gk * kv_row + c]) : 0.0f;
    }
    __syncthreads();

    // S = Q K^T, scaled in fp32 after the dot, masked
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], kc[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = Qs[(ty + 16 * a) * ld + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kc[c] = Ks[(tx + 16 * c) * ld + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = fmaf(qa[a], kc[c], s[a][c]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c;
        const int gk = k0 + j;
        const bool valid = gk < Sk && (!causal || q0 + r >= gk);
        Ps[r * ldp + j] = valid ? s[a][c] * scale : kFaNegInf;
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows 8w .. 8w + 7, a lane two columns
    for (int i = 0; i < kFaBQ / 8; ++i) {
      const int r = warp * 8 + i;
      const int gq = q0 + r;
      float* pr = Ps + r * ldp;
      const float s0 = pr[lane], s1 = pr[lane + 32];
      const float m_prev = row_m[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const int g0 = k0 + lane, g1 = k0 + lane + 32;
      const bool v0 = g0 < Sk && (!causal || gq >= g0);
      const bool v1 = g1 < Sk && (!causal || gq >= g1);
      const float p0 = v0 ? expf(s0 - m_new) : 0.0f;
      const float p1 = v1 ? expf(s1 - m_new) : 0.0f;
      const float sum = warp_sum(p0 + p1);
      pr[lane] = round_to<T>(p0);              // p in v's dtype for P V
      pr[lane + 32] = round_to<T>(p1);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        row_l[r] = row_l[r] * corr + sum;
        row_m[r] = m_new;
        row_c[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float corr = row_c[ty + 16 * a];
#pragma unroll
      for (int c = 0; c < kFaColTiles; ++c) acc[a][c] *= corr;
    }
#pragma unroll 4
    for (int j = 0; j < kFaBK; ++j) {
      float pa[4], vc[kFaColTiles];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = Ps[(ty + 16 * a) * ldp + j];
#pragma unroll
      for (int c = 0; c < kFaColTiles; ++c) {
        const int col = tx + 16 * c;
        vc[c] = col < D ? Vs[j * ld + col] : 0.0f;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < kFaColTiles; ++c)
          acc[a][c] = fmaf(pa[a], vc[c], acc[a][c]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    const int gq = q0 + r;
    if (gq >= Sq) continue;
    const float l = fmaxf(row_l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < kFaColTiles; ++c) {
      const int col = tx + 16 * c;
      if (col < D) op[(int64_t)gq * q_row + col] = from_f32<T>(acc[a][c] / l);
    }
  }
}

REPRO_ERROR_STRING_EXPORT

REPRO_EXPORT int flash_attention_launch(const void* q, const void* k,
                                        const void* v, void* o, int dtype,
                                        int B, int Sq, int Sk, int H,
                                        int KVH, int D, float scale,
                                        int causal, int smem, void* stream) {
  dim3 grid((Sq + kFaBQ - 1) / kFaBQ, H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kBFloat16) {
    err = allow_smem(flash_attention_kernel<__nv_bfloat16>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_attention_kernel<__nv_bfloat16><<<grid, kFaThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(o), H, KVH, Sq, Sk, D, scale, causal);
  } else {
    err = allow_smem(flash_attention_kernel<float>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_attention_kernel<float><<<grid, kFaThreads, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), H, KVH, Sq,
        Sk, D, scale, causal);
  }
  return static_cast<int>(cudaGetLastError());
}
