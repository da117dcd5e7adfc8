// Tensor-core building blocks shared by conv1x1_gemm and winograd_fused:
// warp-level mma.sync on TF32 with the 3xTF32 split, on bf16, and
// cp.async copies into shared memory.
//
// Why mma.sync and not wgmma: these products are 21-822 MFLOP with as
// few as 49 rows.  wgmma's 64-row warpgroup tiles and TMA descriptors buy
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
