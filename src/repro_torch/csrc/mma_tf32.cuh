// Tensor-core building blocks shared by conv1x1_gemm, cuconv_fused,
// winograd_fused, direct_conv, stage1_tap_gemm, flash_attention and
// int8_gemm: warp-level mma.sync on TF32 with the 3xTF32 split, on bf16
// and on int8, ldmatrix, cp.async copies into shared memory, and the
// warp tile of the implicit-GEMM rings.
//
// Why mma.sync and not wgmma: these products are 21-822 MFLOP with as
// few as 49 rows (attention: 64-row query tiles of one head).  wgmma's 64-row warpgroup tiles and TMA descriptors buy
// nothing at these sizes, where the card is bound by how many blocks are
// in flight and by latency; they belong to kernels with large tiles.
//
// 3xTF32: x = big + small with big = cvt.rna.tf32(x) and small =
// cvt.rna.tf32(x - big), and a*b ~ a_big*b_big + a_big*b_small +
// a_small*b_big, each product on the TF32 tensor cores with fp32
// accumulation.  That keeps about fp32 accuracy, where a plain TF32
// product keeps about three decimal digits and misses the kernels' 2e-5
// bound (tests/test_torch_tensor_cores.py emulates both).  It runs at a
// third of TF32's 495 TFLOP/s.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

// Fragment layouts of mma.sync.m16n8k8 (tf32) and m16n8k16 (bf16), for
// lane = 4 * g + t: A (16 x K, row-major) rows g and g + 8; B (K x 8)
// column g; C/D (16 x 8) rows g and g + 8, columns 2t and 2t + 1.
// tf32: a = {(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)},
//       b = {(t, g), (t + 4, g)}.
// bf16: a = {(g, 2t..2t+1), (g + 8, 2t..), (g, 2t+8..), (g + 8, 2t+8..)},
//       b = {(2t..2t+1, g), (2t+8..2t+9, g)}, the lower k in the low half.

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x -> (big, small), both TF32 bit patterns
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b in 3xTF32, operands already split; the small terms go
// first, so they are not lost against the large one
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t* ab,
                                           const uint32_t* as,
                                           const uint32_t* bb,
                                           const uint32_t* bs) {
  mma_tf32(d, as, bb);
  mma_tf32(d, ab, bs);
  mma_tf32(d, ab, bb);
}

// d += a * b on bf16, fp32 accumulation
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b on int8 (m16n8k32, s8 x s8 -> s32, exact while the sum fits
// int32).  Each register holds 4 consecutive k, the lowest in the low
// byte: a = {(g, 4t..4t+3), (g + 8, 4t..), (g, 16 + 4t..), (g + 8,
// 16 + 4t..)}, b = {(4t..4t+3, g), (16 + 4t.., g)}; d as for tf32.
__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// 16-byte asynchronous copy global -> shared, bypassing L1; with
// valid == false nothing is read and the 16 bytes are zero-filled
// (gmem must still be a valid address)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t dst =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(dst), "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most n committed groups are still in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// 16 bytes of T per cp.async
template <typename T>
struct VecOf {
  static constexpr int kElems = 16 / sizeof(T);
};

// ldmatrix: four 8x8 b16 matrices from shared memory, lanes 8i..8i+7
// giving the row addresses of matrix i (16-byte aligned); lane 4g + t
// receives row g, elements 2t and 2t + 1 of each (.trans: column g,
// rows 2t and 2t + 1), which is an mma.sync m16n8k16 fragment
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* smem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Row padding of an implicit-GEMM ring's A tile (rows x BK, row-major)
// and B tile (BK x columns, k-major): A rows + 16 bytes, B rows + 8
// elements, so the fragment loads of warp_mma_stage hit 32 distinct
// banks.
template <typename T>
struct RingPad {
  static constexpr int A = 16 / sizeof(T), B = 8;
};

// One BK-deep stage of a warp's MI x NI mma tiles (16 x 8 each): A rows
// row0.. of a [.][LDA] tile, B columns col0.. of a [BK][LDB] tile; fp32
// in 3xTF32, acc[mi][ni] the m16n8 accumulator fragment.
template <int MI, int NI, int LDA, int LDB, int BK>
__device__ __forceinline__ void warp_mma_stage(float (*acc)[NI][4],
                                               const float* As,
                                               const float* Bs, int row0,
                                               int col0, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 8) {
    uint32_t ab[MI][4], as[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const float* a = As + (row0 + mi * 16 + g) * LDA + kk + t;
      split_tf32(a[0], ab[mi][0], as[mi][0]);
      split_tf32(a[8 * LDA], ab[mi][1], as[mi][1]);
      split_tf32(a[4], ab[mi][2], as[mi][2]);
      split_tf32(a[8 * LDA + 4], ab[mi][3], as[mi][3]);
    }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const float* b = Bs + (kk + t) * LDB + col0 + ni * 8 + g;
      uint32_t bb[2], bs[2];
      split_tf32(b[0], bb[0], bs[0]);
      split_tf32(b[4 * LDB], bb[1], bs[1]);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        mma_3xtf32(acc[mi][ni], ab[mi], as[mi], bb, bs);
    }
  }
}

// the same on bf16 (m16n8k16)
template <int MI, int NI, int LDA, int LDB, int BK>
__device__ __forceinline__ void warp_mma_stage(float (*acc)[NI][4],
                                               const __nv_bfloat16* As,
                                               const __nv_bfloat16* Bs,
                                               int row0, int col0, int g,
                                               int t) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t a[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const __nv_bfloat16* ap = As + (row0 + mi * 16 + g) * LDA + kk + 2 * t;
      a[mi][0] = *reinterpret_cast<const uint32_t*>(ap);
      a[mi][1] = *reinterpret_cast<const uint32_t*>(ap + 8 * LDA);
      a[mi][2] = *reinterpret_cast<const uint32_t*>(ap + 8);
      a[mi][3] = *reinterpret_cast<const uint32_t*>(ap + 8 * LDA + 8);
    }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const __nv_bfloat16* bp = Bs + (kk + 2 * t) * LDB + col0 + ni * 8 + g;
      uint32_t b[2];
      b[0] = pack_bf16(bp[0], bp[LDB]);
      b[1] = pack_bf16(bp[8 * LDB], bp[9 * LDB]);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) mma_bf16(acc[mi][ni], a[mi], b);
    }
  }
}
