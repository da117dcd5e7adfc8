// Split-K across blocks, shared by conv1x1_gemm and cuconv_fused.
//
// Where a launch's output tiles alone are too few to fill the card, the
// contraction's k_steps steps are cut into `splits` fixed runs of whole
// steps, one per blockIdx.z.  Each split writes its fp32 partial tile to
// a workspace allocated by the wrapper; the last block of a tile to
// arrive, by an atomic ticket on counters[tile], sums the partials in
// split order and writes the output, so two calls give the same bits and
// a CUDA graph replays them.  That block resets the ticket for the next
// call.  conv1x1_gemm keeps its partials as [splits][P][M] (split_sum);
// cuconv_fused keeps them tile-major, [splits][tiles][BM * BN], so the
// stores and the last block's loads are 16 bytes wide (split_sum4).
#pragma once

#include <stdint.h>

// [begin, end) steps of split z
__device__ __forceinline__ void split_steps(int z, int splits, int k_steps,
                                            int& begin, int& end) {
  begin = static_cast<int>(static_cast<int64_t>(z) * k_steps / splits);
  end = static_cast<int>(static_cast<int64_t>(z + 1) * k_steps / splits);
}

// Called by every thread of the block after its partial stores: true in
// the block that arrives last at `tile`, which may then read every
// split's partial.
__device__ __forceinline__ bool split_arrive_last(int* counters, int tile,
                                                  int splits) {
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(&counters[tile], 1) == splits - 1;
  __syncthreads();
  if (!is_last) return false;
  __threadfence();
  return true;
}

// sum[i] = the partials at offset off[i] summed in split order; the
// loads of four splits are in flight together.  An element with off[i]
// < 0 reads offset 0 instead (a valid address) and its sum is not to be
// used: the loads carry no predicate each, which keeps a tile of 8-16
// elements per thread inside the SM's predicate registers.  Offsets fit
// an int (the launchers check splits * P * M).
template <int PER>
__device__ __forceinline__ void split_sum(const float* __restrict__ ws,
                                          int stride, int splits,
                                          const int (&off)[PER],
                                          float (&sum)[PER]) {
  int at[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    sum[i] = 0.f;
    at[i] = max(off[i], 0);
  }
  int zz = 0;
  for (; zz + 4 <= splits; zz += 4) {
    const float* src = ws + zz * stride;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const float* q = src + at[i];
      const float a0 = __ldcg(q), a1 = __ldcg(q + stride),
                  a2 = __ldcg(q + 2 * stride), a3 = __ldcg(q + 3 * stride);
      sum[i] = (((sum[i] + a0) + a1) + a2) + a3;
    }
  }
  for (; zz < splits; ++zz) {
#pragma unroll
    for (int i = 0; i < PER; ++i) sum[i] += __ldcg(ws + zz * stride + at[i]);
  }
}

// sum[j] = float4 number threadIdx.x + j * THREADS of one tile's partials
// in a tile-major workspace (split z's tile at ws + z * stride), summed
// per component in split order; the loads of four splits are in flight
// together
template <int G, int THREADS>
__device__ __forceinline__ void split_sum4(const float* __restrict__ ws,
                                           int stride, int splits,
                                           float4 (&sum)[G]) {
  const float4* src = reinterpret_cast<const float4*>(ws) + threadIdx.x;
  const int stride4 = stride / 4;
#pragma unroll
  for (int j = 0; j < G; ++j) sum[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  int zz = 0;
  for (; zz + 4 <= splits; zz += 4) {
    float4 v[4][G];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int j = 0; j < G; ++j)
        v[k][j] = __ldcg(src + (zz + k) * stride4 + j * THREADS);
#pragma unroll
    for (int j = 0; j < G; ++j) {
      sum[j].x = (((sum[j].x + v[0][j].x) + v[1][j].x) + v[2][j].x) + v[3][j].x;
      sum[j].y = (((sum[j].y + v[0][j].y) + v[1][j].y) + v[2][j].y) + v[3][j].y;
      sum[j].z = (((sum[j].z + v[0][j].z) + v[1][j].z) + v[2][j].z) + v[3][j].z;
      sum[j].w = (((sum[j].w + v[0][j].w) + v[1][j].w) + v[2][j].w) + v[3][j].w;
    }
  }
  for (; zz < splits; ++zz) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const float4 v = __ldcg(src + zz * stride4 + j * THREADS);
      sum[j].x += v.x;
      sum[j].y += v.y;
      sum[j].z += v.z;
      sum[j].w += v.w;
    }
  }
}

// the last block, after its writes: the ticket is ready for the next call
__device__ __forceinline__ void split_reset(int* counters, int tile) {
  if (threadIdx.x == 0) counters[tile] = 0;
}
