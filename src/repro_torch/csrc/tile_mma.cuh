// Shared pieces of the two symmetric kernels (rank_update.cu,
// sym_stream.cu): the register-tiled FFMA inner product over one shared
// memory panel pair, and the f32 -> output-type store.
//
// Thread (ty, tx) of a TY x TX block owns the output elements
// (ty + TY*m, tx + TX*n), m < TM, n < TN: rows and columns are strided
// by the thread grid, so a warp reads neighbouring shared-memory words
// (no bank conflicts on the panel reads) and writes neighbouring
// global addresses in the epilogue (coalesced stores).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

template <typename T>
__device__ __forceinline__ T from_f32(float x);

template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// acc[m][n] += sum_q P[q][ty + TY*m] * Q[q][tx + TX*n]: one contraction
// panel of depth BK, operands stored k-major in shared memory.
template <int BK, int TM, int TN, int TY, int TX, int LDP, int LDQ>
__device__ __forceinline__ void panel_fma(const float (*P)[LDP],
                                          const float (*Q)[LDQ],
                                          float (&acc)[TM][TN], int ty,
                                          int tx) {
#pragma unroll
  for (int q = 0; q < BK; ++q) {
    float a[TM], b[TN];
#pragma unroll
    for (int m = 0; m < TM; ++m) a[m] = P[q][ty + TY * m];
#pragma unroll
    for (int n = 0; n < TN; ++n) b[n] = Q[q][tx + TX * n];
#pragma unroll
    for (int m = 0; m < TM; ++m) {
#pragma unroll
      for (int n = 0; n < TN; ++n) acc[m][n] = fmaf(a[m], b[n], acc[m][n]);
    }
  }
}

}  // namespace repro_torch
