// Symmetric times dense with the symmetric operand as packed tiles:
// C = sym_s(A) B, A given only as its packed lower-triangle tiles
// (T, bm, bm), B (n1, n2), C (n1, n2) in f32 or bf16.  sym_s mirrors the
// lower half, with the matrix diagonal scaled by diag_scale (the packed
// cotangent prologue; 1 on the serving path).
//
// Replaces the Pallas kernel src/repro/kernels/trigrid.py:sym_stream
// (_sym_stream_kernel with the body kernels/symm.py:_symm_body and the
// lookup table trigrid.py:symm_lookup).
//
// Design for Hopper.  The TPU grid (nt, n2/bn, nt) carries a VMEM
// accumulator along its last axis; here one block owns the output block
// (row block i, a BN-wide column slab) and loops over k < nt itself.
// For each k it reads the tile index flat[i*nt + k] = tri(max(i,k)) +
// min(i,k) and the mode (0 as stored, 1 transposed, 2 diagonal) from a
// small device table, and stages BK-deep slices of the effective tile
// through shared memory: mode 1 transposes on the way in, mode 2
// symmetrises from the lower half only (the upper half of a diagonal
// tile is never read, so garbage or NaN there cannot leak) and applies
// diag_scale.  Each thread accumulates a TM x TN register tile with FFMA
// in IEEE f32 and casts once at the store.  Columns past n2 are masked,
// so any n2 works; the tile size bm (8..128) is the packed operand's
// format and is compiled for every power of two.
//
// What bounds it on an H100 at the serving path's shapes: each
// Newton-Schulz SYMM (2048 x 2048 times 2048 x 2048) does 17.2 GFLOP
// against ~41 MB of traffic, so it is bound by the FP32 FFMA rate
// (67 TFLOP/s; tensor cores would need TF32, which the f32 parity path
// forbids).  The seed product with the bm = 32 Gram tiles is the same
// work at a smaller register tile.  The per-request embedding product
// has n2 = 1, but the caller pads B to 128 columns (as the reference
// does), so it does 1.07 GFLOP and is bound by the FP32 rate (16 us);
// unpadded it would be bound by reading the 8.9 MB of packed factor
// tiles once (2.7 us at 3.35 TB/s).  512 blocks of 256 threads at the
// NS shapes fill the 132 SMs several times over.
#include <cstdint>

#include "tile_mma.cuh"

namespace repro_torch {

constexpr int kBN = 64;   // output columns per block
constexpr int kTN = 4;    // output columns per thread

template <int BM, int TM, typename OutT>
__global__ void __launch_bounds__((BM / TM) * (kBN / kTN))
sym_stream_kernel(const float* __restrict__ tiles,
                  const float* __restrict__ b, int nt, int n2,
                  const int* __restrict__ flat, const int* __restrict__ mode,
                  float diag_scale, OutT* __restrict__ out) {
  constexpr int TY = BM / TM, TX = kBN / kTN, NT = TY * TX;
  constexpr int BK = BM < 16 ? BM : 16;
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][kBN];

  const int i = blockIdx.y;
  const int j0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int ty = tid / TX, tx = tid % TX;

  float acc[TM][kTN];
#pragma unroll
  for (int m = 0; m < TM; ++m) {
#pragma unroll
    for (int n = 0; n < kTN; ++n) acc[m][n] = 0.f;
  }

  for (int k = 0; k < nt; ++k) {
    const int f = flat[i * nt + k];
    const int md = mode[i * nt + k];
    const float* tile = tiles + (size_t)f * BM * BM;
    for (int q0 = 0; q0 < BM; q0 += BK) {
      // effective A tile rows r, columns q0 .. q0+BK, stored k-major
      for (int e = tid; e < BM * BK; e += NT) {
        int r, q;
        if (md == 1) {          // transposed read: walk the stored rows
          r = e % BM;
          q = e / BM;
        } else {
          q = e % BK;
          r = e / BK;
        }
        const int c = q0 + q;
        float v;
        if (md == 0) {
          v = tile[r * BM + c];
        } else if (md == 1) {
          v = tile[c * BM + r];
        } else {                // diagonal: lower half only
          v = r >= c ? tile[r * BM + c] : tile[c * BM + r];
          if (r == c) v *= diag_scale;
        }
        As[q][r] = v;
      }
      for (int e = tid; e < BK * kBN; e += NT) {
        const int q = e / kBN, cc = e % kBN;
        const int col = j0 + cc;
        const size_t row = (size_t)k * BM + q0 + q;
        Bs[q][cc] = col < n2 ? b[row * n2 + col] : 0.f;
      }
      __syncthreads();
      panel_fma<BK, TM, kTN, TY, TX, BM + 1, kBN>(As, Bs, acc, ty, tx);
      __syncthreads();
    }
  }

#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const size_t row = (size_t)i * BM + ty + TY * m;
#pragma unroll
    for (int n = 0; n < kTN; ++n) {
      const int col = j0 + tx + TX * n;
      if (col < n2) out[row * n2 + col] = from_f32<OutT>(acc[m][n]);
    }
  }
}

template <int BM, int TM, typename OutT>
static void launch(const float* tiles, const float* b, int nt, int n2,
                   const int* flat, const int* mode, float diag_scale,
                   void* out, cudaStream_t stream) {
  constexpr int NT = (BM / TM) * (kBN / kTN);
  dim3 grid((n2 + kBN - 1) / kBN, nt);
  sym_stream_kernel<BM, TM, OutT><<<grid, NT, 0, stream>>>(
      tiles, b, nt, n2, flat, mode, diag_scale, static_cast<OutT*>(out));
}

template <typename OutT>
static int dispatch_bm(int bm, const float* tiles, const float* b, int nt,
                       int n2, const int* flat, const int* mode,
                       float diag_scale, void* out, cudaStream_t s) {
  switch (bm) {
    case 8:
      launch<8, 1, OutT>(tiles, b, nt, n2, flat, mode, diag_scale, out, s);
      break;
    case 16:
      launch<16, 1, OutT>(tiles, b, nt, n2, flat, mode, diag_scale, out, s);
      break;
    case 32:
      launch<32, 2, OutT>(tiles, b, nt, n2, flat, mode, diag_scale, out, s);
      break;
    case 64:
      launch<64, 4, OutT>(tiles, b, nt, n2, flat, mode, diag_scale, out, s);
      break;
    case 128:
      launch<128, 8, OutT>(tiles, b, nt, n2, flat, mode, diag_scale, out, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// Plain C entry point (bound with ctypes).  tiles: (T, bm, bm) f32 with
// T = nt(nt+1)/2; b: (nt*bm, n2) row-major f32; flat/mode: (nt*nt,) int32
// device tables; out: (nt*bm, n2) f32 (out_bf16 = 0) or bf16 (1).
// Returns the launch's cudaGetLastError() (0 on success).
extern "C" int repro_sym_stream(int bm, const void* tiles, const void* b,
                                int nt, int n2, const void* flat,
                                const void* mode, float diag_scale,
                                void* out, int out_bf16, void* stream) {
  using namespace repro_torch;
  auto Tl = static_cast<const float*>(tiles);
  auto B = static_cast<const float*>(b);
  auto F = static_cast<const int*>(flat);
  auto M = static_cast<const int*>(mode);
  auto s = static_cast<cudaStream_t>(stream);
  if (nt <= 0 || n2 <= 0 || nt > 65535) return (int)cudaErrorInvalidValue;
  return out_bf16 ? dispatch_bm<__nv_bfloat16>(bm, Tl, B, nt, n2, F, M,
                                               diag_scale, out, s)
                  : dispatch_bm<float>(bm, Tl, B, nt, n2, F, M, diag_scale,
                                       out, s);
}
