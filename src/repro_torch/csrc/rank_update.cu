// Symmetric rank update over the lower triangle:
// SYRK  C = alpha * A A^T + beta * C0     (body 0)
// SYR2K C = alpha * (A B^T + B A^T) + beta * C0   (body 1)
// written as packed lower-triangle tiles (T, bm, bm), T = nt(nt+1)/2.
//
// Replaces the Pallas kernel src/repro/kernels/trigrid.py:rank_update
// (_rank_update_kernel with the bodies kernels/syrk.py:_syrk_body and
// kernels/syr2k.py:_syr2k_body, epilogue trigrid.py:Epilogue.apply).
//
// What bounds it on an H100: the Newton-Schulz SYRK (2048 x 2048,
// fill="full") does 8.6 GFLOP of useful work against ~25 MB of traffic,
// so it is bound by the tensor cores: 3 x 8.6 GFLOP / 495 TFLOP/s =
// 0.052 ms in 3xTF32.  The Gram update (A 2048 x bucket, bucket 16..256)
// is bound by its 8.9 MB packed store (2.7 us at 3.35 TB/s) and, with
// few contraction steps, by load latency.
//
// Design.  The TPU grid (T, nk) runs in order and carries a VMEM
// accumulator along nk; here blocks run in parallel in no order, so
// each block owns one output block and loops over the whole contraction
// itself (tile_mma.cuh: 3xTF32 mma.sync fed by a cp.async ring).  The
// output block is sized for the card, not by the packed format bm: 64 x
// 64 blocks of 4 warps, several resident per SM.  At d = 2048 that is
// 528 blocks, where one block per packed 128-tile gave 136, one wave
// and a 4-block tail on 132 SMs; 128 x 128 blocks measured slower on
// the card.  At d = 1024 it is 136 blocks instead of 36.  A
// small device table (trigrid.rank_blocks) lists the blocks on or below
// the block diagonal: the matrix row and column of each block's origin.
// The epilogue maps each element (r, c) to its packed tile (r / bm,
// c / bm) and offset, skips tiles above the diagonal, and applies alpha,
// beta * C0[t], the zeroed strict upper half of diagonal tiles (a
// select, so nothing in C0's upper half reaches the output), diag_scale
// on the matrix diagonal and the cast to f32 or bf16, then stores once.
// Where a 64-block lies below the block diagonal but inside a diagonal
// tile (bm = 128), it also stores the zeros of its mirror image (c, r),
// the part of that tile's strict upper half that no block computes.  A
// diagonal SYRK block stages its one operand once.  Rows past n1 and
// columns past n2 are zero-filled by the copies, so any n2 works (4 B
// copies when rows are not 16 B-aligned).
// A stack of matrices is one launch (the Newton-Schulz Grams of a
// stacked layer weight, 24 x 2048 x 5632 in Muon): grid (blocks, batch),
// blockIdx.y picks the matrix, and each is computed exactly as its own
// launch computes it, so the results agree bit for bit.  A single
// matrix runs an instance compiled without the stack offsets (STACK).
#include <cstdint>

#include "tile_mma.cuh"

namespace repro_torch {

// 64 x 64 output blocks of 4 warps, each warp a 32 x 32 tile
constexpr int kBO = 64;
constexpr int kWM = 2, kWN = 2;
constexpr int kRankThreads = 32 * kWM * kWN;
constexpr int kMT = kBO / kWM / 16;           // m16 tiles per warp
constexpr int kNT = kBO / kWN / 8;            // n8 tiles per warp
constexpr int kLD = kBK + 4;                  // padded panel row

// shared-memory panels staged per pipeline stage: A_i, A_j (SYRK) or
// A_i, B_j, B_i, A_j (SYR2K); the pipeline depth measured best on the
// H100: 4 stages for SYRK, 2 for SYR2K, 74 KB a block either way, so
// three blocks fit an SM
template <int BODY>
struct RankSmem {
  static constexpr int panels = BODY == 0 ? 2 : 4;
  static constexpr int stages = BODY == 0 ? 4 : 2;
  static constexpr int bytes = stages * panels * kBO * kLD * 4;
};

template <int BODY, bool VEC, bool STACK, typename OutT>
__global__ void __launch_bounds__(kRankThreads)
rank_update_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   int n1, int n2, int log_bm,
                   const int* __restrict__ blocks,
                   const float* __restrict__ c0, float alpha, float beta,
                   float diag_scale, OutT* __restrict__ out) {
  constexpr int NP = RankSmem<BODY>::panels;
  constexpr int BO = kBO, LD = kLD;
  extern __shared__ __align__(16) float smem[];

  // matrix blockIdx.y of a stack: its operands and packed tiles, each
  // matrix exactly as an unbatched launch computes it.  A launch of one
  // matrix compiles without the offsets: with them ptxas schedules the
  // NS SYRK's mainloop differently, 16 % slower at 2048^2 on the card
  // (PERF.md §6)
  if constexpr (STACK) {
    const long z = blockIdx.y;
    const long nt = n1 >> log_bm;
    a += z * n1 * n2;
    if (BODY == 1) b += z * n1 * n2;
    const long tiles = (nt * (nt + 1) / 2) << (2 * log_bm);
    if (c0 != nullptr) c0 += z * tiles;
    out += z * tiles;
  }

  const int row0 = blocks[2 * blockIdx.x];
  const int col0 = blocks[2 * blockIdx.x + 1];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp / kWN) * (BO / kWM);
  const int wn0 = (warp % kWN) * (BO / kWN);

  float acc[kMT][kNT][4], part[kMT][kNT][4];
  zero_acc(acc);

  const bool same = BODY == 0 && row0 == col0;
  const int rows_i = min(BO, n1 - row0), rows_j = min(BO, n1 - col0);
  const float* ai = a + (long)row0 * n2;
  const float* aj = a + (long)col0 * n2;
  const float* bi = BODY == 1 ? b + (long)row0 * n2 : nullptr;
  const float* bj = BODY == 1 ? b + (long)col0 * n2 : nullptr;
  auto load = [&](int s, int p) {
    float* st = smem + s * NP * BO * LD;
    const int k0 = p * kBK, kok = n2 - k0;
    stage_block<VEC, BO, kBK, kRankThreads>(st, LD, ai + k0, n2, rows_i,
                                            kok, tid);
    if constexpr (BODY == 0) {
      if (!same) {
        stage_block<VEC, BO, kBK, kRankThreads>(st + BO * LD, LD, aj + k0,
                                                n2, rows_j, kok, tid);
      }
    } else {
      stage_block<VEC, BO, kBK, kRankThreads>(st + BO * LD, LD, bj + k0, n2,
                                              rows_j, kok, tid);
      stage_block<VEC, BO, kBK, kRankThreads>(st + 2 * BO * LD, LD, bi + k0,
                                              n2, rows_i, kok, tid);
      stage_block<VEC, BO, kBK, kRankThreads>(st + 3 * BO * LD, LD, aj + k0,
                                              n2, rows_j, kok, tid);
    }
  };
  auto compute = [&](int s, int) {
    const float* P0 = smem + s * NP * BO * LD;
    const float* P1 = same ? P0 : P0 + BO * LD;
    zero_acc(part);
    // A fragments from the row block, B fragments from the column
    // block: both panels are k-contiguous ([row][k])
    panel_kmajor<kMT, kNT, LD>(part, P0, P1, wm0, wn0, g, t);
    if constexpr (BODY == 1) {
      panel_kmajor<kMT, kNT, LD>(part, P0 + 2 * BO * LD, P0 + 3 * BO * LD,
                                 wm0, wn0, g, t);
    }
    add_panel(acc, part);
  };
  pipeline<RankSmem<BODY>::stages>((n2 + kBK - 1) / kBK, load, compute);

  // fused epilogue, per element with its packed coordinates
  const int bm = 1 << log_bm, mask = bm - 1;
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = row0 + wm0 + 16 * m + g + 8 * (i >> 1);
        const int c = col0 + wn0 + 8 * n + 2 * t + (i & 1);
        if (r >= n1 || c >= n1) continue;
        const int ti = r >> log_bm, tj = c >> log_bm;
        if (ti < tj) continue;                   // no such packed tile
        const int rr = r & mask, cc = c & mask;
        const long base = ((long)ti * (ti + 1) / 2 + tj) << (2 * log_bm);
        const long idx = base + (long)rr * bm + cc;
        float v = alpha * acc[m][n][i];
        if (c0 != nullptr) v += beta * c0[idx];
        if (ti == tj && rr < cc) v = 0.f;
        if (r == c) v *= diag_scale;
        out[idx] = from_f32<OutT>(v);
        if (ti == tj && row0 != col0) {          // the mirror's zero
          out[base + (long)cc * bm + rr] = from_f32<OutT>(0.f);
        }
      }
    }
  }
}

template <int BODY, bool VEC, bool STACK, typename OutT>
static int launch_one(const float* a, const float* b, int n1, int n2,
                      int batch, int log_bm, const int* blocks, int nblocks,
                      const float* c0, float alpha, float beta,
                      float diag_scale, void* out, cudaStream_t stream) {
  constexpr int smem = RankSmem<BODY>::bytes;
  auto kernel = rank_update_kernel<BODY, VEC, STACK, OutT>;
  const int rc = allow_smem(kernel, smem);
  if (rc != 0) return rc;
  kernel<<<dim3(nblocks, batch), kRankThreads, smem, stream>>>(
      a, b, n1, n2, log_bm, blocks, c0, alpha, beta, diag_scale,
      static_cast<OutT*>(out));
  return (int)cudaGetLastError();
}

template <int BODY, bool VEC, typename OutT>
static int launch(const float* a, const float* b, int n1, int n2, int batch,
                  int log_bm, const int* blocks, int nblocks, const float* c0,
                  float alpha, float beta, float diag_scale, void* out,
                  cudaStream_t stream) {
  return batch > 1
             ? launch_one<BODY, VEC, true, OutT>(a, b, n1, n2, batch, log_bm,
                                                 blocks, nblocks, c0, alpha,
                                                 beta, diag_scale, out,
                                                 stream)
             : launch_one<BODY, VEC, false, OutT>(a, b, n1, n2, 1, log_bm,
                                                  blocks, nblocks, c0, alpha,
                                                  beta, diag_scale, out,
                                                  stream);
}

template <int BODY, typename OutT>
static int dispatch_vec(bool vec, const float* a, const float* b, int n1,
                        int n2, int batch, int log_bm, const int* blocks,
                        int nblocks, const float* c0, float alpha,
                        float beta, float ds, void* out, cudaStream_t s) {
  return vec ? launch<BODY, true, OutT>(a, b, n1, n2, batch, log_bm, blocks,
                                        nblocks, c0, alpha, beta, ds, out, s)
             : launch<BODY, false, OutT>(a, b, n1, n2, batch, log_bm, blocks,
                                         nblocks, c0, alpha, beta, ds, out,
                                         s);
}

}  // namespace repro_torch

// Plain C entry point (bound with ctypes).  body: 0 SYRK, 1 SYR2K (b
// required); bm: packed tile (8..128, a power of two); a, b: batch
// stacked (n1, n2) row-major f32 matrices, n1 = nt * bm; blocks:
// (nblocks, 2) int32 device table (row0, col0); c0: batch stacked
// (T, bm, bm) f32 or null; out: batch stacked (T, bm, bm) f32
// (out_bf16 = 0) or bf16 (1).  One launch, grid (nblocks, batch).
// Returns the launch's CUDA error code (0 on success).
extern "C" int repro_rank_update(int body, int bm, const void* a,
                                 const void* b, int n1, int n2, int batch,
                                 const void* blocks, int nblocks,
                                 const void* c0, float alpha, float beta,
                                 float diag_scale, void* out, int out_bf16,
                                 void* stream) {
  using namespace repro_torch;
  auto A = static_cast<const float*>(a);
  auto B = static_cast<const float*>(b);
  auto K = static_cast<const int*>(blocks);
  auto C = static_cast<const float*>(c0);
  auto s = static_cast<cudaStream_t>(stream);
  int log_bm = 0;
  while ((1 << log_bm) < bm) ++log_bm;
  if (nblocks <= 0 || n1 <= 0 || n2 <= 0 || batch <= 0 || batch > 65535 ||
      bm < 8 || bm > 128 ||
      (1 << log_bm) != bm || n1 % bm != 0 || (body == 1 && B == nullptr) ||
      (body != 0 && body != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool vec = n2 % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(B) % 16 == 0;
  if (body == 0) {
    return out_bf16
               ? dispatch_vec<0, __nv_bfloat16>(vec, A, B, n1, n2, batch,
                                                log_bm, K, nblocks, C, alpha,
                                                beta, diag_scale, out, s)
               : dispatch_vec<0, float>(vec, A, B, n1, n2, batch, log_bm, K,
                                        nblocks, C, alpha, beta, diag_scale,
                                        out, s);
  }
  return out_bf16
             ? dispatch_vec<1, __nv_bfloat16>(vec, A, B, n1, n2, batch,
                                              log_bm, K, nblocks, C, alpha,
                                              beta, diag_scale, out, s)
             : dispatch_vec<1, float>(vec, A, B, n1, n2, batch, log_bm, K,
                                      nblocks, C, alpha, beta, diag_scale,
                                      out, s);
}
