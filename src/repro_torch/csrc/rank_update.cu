// Symmetric rank update over the lower triangle of the tile grid:
// SYRK  C = alpha * A A^T + beta * C0     (body 0)
// SYR2K C = alpha * (A B^T + B A^T) + beta * C0   (body 1)
// written as packed lower-triangle tiles (T, bm, bm), T = nt(nt+1)/2.
//
// Replaces the Pallas kernel src/repro/kernels/trigrid.py:rank_update
// (_rank_update_kernel with the bodies kernels/syrk.py:_syrk_body and
// kernels/syr2k.py:_syr2k_body, epilogue trigrid.py:Epilogue.apply).
//
// Design for Hopper.  On the TPU the grid (T, nk) runs in order and the
// contraction axis carries a VMEM accumulator across grid steps; here
// blocks run in parallel in no order, so each block owns one packed
// output tile t, reads its (i, j) tile coordinates from a small device
// table (imap/jmap, the counterpart of scalar prefetch), and loops over
// the whole contraction itself: BK-deep panels of the row blocks i and j
// are staged through shared memory and each thread accumulates a TM x TM
// register tile with FFMA in IEEE f32.  The epilogue runs in registers
// before the single store: alpha, beta * C0[t], the zeroed strict upper
// half of grid-diagonal tiles, diag_scale on the matrix diagonal, and
// the cast to f32 or bf16.  No work is spent on the empty upper triangle
// of the tile grid.  bm is a data format (the caller's packed layout),
// not a free tiling, so every power of two from 8 to 128 is compiled.
//
// What bounds it on an H100 at the serving path's shapes: the Gram
// update (A of 2048 x bucket, bucket 16..256, bm 128) does
// n(n+1)/2 * bucket * 2 flops against an 8.9 MB f32 store of 136 tiles;
// at bucket 64 that is 4.0 us of FP32 FFMA at 67 TFLOP/s against 2.7 us
// of store at 3.35 TB/s, so both are close and the bound is the FP32
// rate.  The Newton-Schulz SYRK (2048 x 2048, fill="full") does about
// 8.6 GFLOP and is bound by the FP32 FFMA rate (tensor cores would need
// TF32, which the f32 parity path forbids).  A one-tile-per-block grid
// gives 136 blocks at n = 2048, about one wave on 132 SMs; register
// tiles of 8 x 8 per thread keep 64 independent FFMAs in flight per
// panel step to hide latency at that low occupancy.
#include <cstdint>

#include "tile_mma.cuh"

namespace repro_torch {

template <int BODY, int BM, int TM, typename OutT>
__global__ void __launch_bounds__((BM / TM) * (BM / TM))
rank_update_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   int n2, const int* __restrict__ imap,
                   const int* __restrict__ jmap,
                   const float* __restrict__ c0, float alpha, float beta,
                   float diag_scale, OutT* __restrict__ out) {
  constexpr int T1 = BM / TM;             // threads per tile side
  constexpr int NT = T1 * T1;
  constexpr int BK = BM < 16 ? BM : 16;   // contraction panel depth
  constexpr int NP = BODY == 0 ? 2 : 4;   // panels staged per step
  // k-major panels, padded by one word so the transposing stores do not
  // all land in one bank
  __shared__ float P[NP][BK][BM + 1];

  const int t = blockIdx.x;
  const int ti = imap[t], tj = jmap[t];
  const int tid = threadIdx.x;
  const int ty = tid / T1, tx = tid % T1;
  const size_t row_i = (size_t)ti * BM * n2;
  const size_t row_j = (size_t)tj * BM * n2;

  float acc[TM][TM];
#pragma unroll
  for (int m = 0; m < TM; ++m) {
#pragma unroll
    for (int n = 0; n < TM; ++n) acc[m][n] = 0.f;
  }

  for (int k0 = 0; k0 < n2; k0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {
      const int r = e / BK, q = e % BK;
      const int k = k0 + q;
      const bool ok = k < n2;
      const size_t off = (size_t)r * n2 + k;
      if constexpr (BODY == 0) {
        P[0][q][r] = ok ? a[row_i + off] : 0.f;   // A_i
        P[1][q][r] = ok ? a[row_j + off] : 0.f;   // A_j
      } else {
        P[0][q][r] = ok ? a[row_i + off] : 0.f;   // A_i
        P[1][q][r] = ok ? b[row_j + off] : 0.f;   // B_j
        P[2][q][r] = ok ? b[row_i + off] : 0.f;   // B_i
        P[3][q][r] = ok ? a[row_j + off] : 0.f;   // A_j
      }
    }
    __syncthreads();
    panel_fma<BK, TM, TM, T1, T1, BM + 1, BM + 1>(P[0], P[1], acc, ty, tx);
    if constexpr (BODY == 1) {
      panel_fma<BK, TM, TM, T1, T1, BM + 1, BM + 1>(P[2], P[3], acc, ty,
                                                     tx);
    }
    __syncthreads();
  }

  // fused epilogue, in registers, then the one store of the tile
  const bool is_diag = ti == tj;
  const size_t tile = (size_t)t * BM * BM;
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int r = ty + T1 * m;
#pragma unroll
    for (int n = 0; n < TM; ++n) {
      const int c = tx + T1 * n;
      float v = alpha * acc[m][n];
      if (c0 != nullptr) v += beta * c0[tile + r * BM + c];
      if (is_diag && r < c) v = 0.f;
      if (is_diag && r == c) v *= diag_scale;
      out[tile + r * BM + c] = from_f32<OutT>(v);
    }
  }
}

template <int BODY, int BM, int TM, typename OutT>
static void launch(const float* a, const float* b, int n2, const int* imap,
                   const int* jmap, int T, const float* c0, float alpha,
                   float beta, float diag_scale, void* out,
                   cudaStream_t stream) {
  constexpr int NT = (BM / TM) * (BM / TM);
  rank_update_kernel<BODY, BM, TM, OutT><<<T, NT, 0, stream>>>(
      a, b, n2, imap, jmap, c0, alpha, beta, diag_scale,
      static_cast<OutT*>(out));
}

template <int BODY, typename OutT>
static int dispatch_bm(int bm, const float* a, const float* b, int n2,
                       const int* imap, const int* jmap, int T,
                       const float* c0, float alpha, float beta,
                       float diag_scale, void* out, cudaStream_t s) {
  switch (bm) {
    case 8:
      launch<BODY, 8, 1, OutT>(a, b, n2, imap, jmap, T, c0, alpha, beta,
                               diag_scale, out, s);
      break;
    case 16:
      launch<BODY, 16, 1, OutT>(a, b, n2, imap, jmap, T, c0, alpha, beta,
                                diag_scale, out, s);
      break;
    case 32:
      launch<BODY, 32, 2, OutT>(a, b, n2, imap, jmap, T, c0, alpha, beta,
                                diag_scale, out, s);
      break;
    case 64:
      launch<BODY, 64, 4, OutT>(a, b, n2, imap, jmap, T, c0, alpha, beta,
                                diag_scale, out, s);
      break;
    case 128:
      launch<BODY, 128, 8, OutT>(a, b, n2, imap, jmap, T, c0, alpha, beta,
                                 diag_scale, out, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// Plain C entry point (bound with ctypes).  body: 0 SYRK, 1 SYR2K (b
// required); a, b: (n1, n2) row-major f32 with n1 = nt * bm; imap/jmap:
// (T,) int32 device tables; c0: (T, bm, bm) f32 or null; out: (T, bm, bm)
// f32 (out_bf16 = 0) or bf16 (out_bf16 = 1).  Returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int repro_rank_update(int body, int bm, const void* a,
                                 const void* b, int n2, const void* imap,
                                 const void* jmap, int T, const void* c0,
                                 float alpha, float beta, float diag_scale,
                                 void* out, int out_bf16, void* stream) {
  using namespace repro_torch;
  auto A = static_cast<const float*>(a);
  auto B = static_cast<const float*>(b);
  auto I = static_cast<const int*>(imap);
  auto J = static_cast<const int*>(jmap);
  auto C = static_cast<const float*>(c0);
  auto s = static_cast<cudaStream_t>(stream);
  if (T <= 0 || n2 <= 0) return (int)cudaErrorInvalidValue;
  if (body == 0) {
    return out_bf16 ? dispatch_bm<0, __nv_bfloat16>(bm, A, B, n2, I, J, T, C,
                                                    alpha, beta, diag_scale,
                                                    out, s)
                    : dispatch_bm<0, float>(bm, A, B, n2, I, J, T, C, alpha,
                                            beta, diag_scale, out, s);
  }
  if (body == 1 && B != nullptr) {
    return out_bf16 ? dispatch_bm<1, __nv_bfloat16>(bm, A, B, n2, I, J, T, C,
                                                    alpha, beta, diag_scale,
                                                    out, s)
                    : dispatch_bm<1, float>(bm, A, B, n2, I, J, T, C, alpha,
                                            beta, diag_scale, out, s);
  }
  return (int)cudaErrorInvalidValue;
}
