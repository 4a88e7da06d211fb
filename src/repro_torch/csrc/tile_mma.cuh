// Shared mainloop of the two symmetric kernels (rank_update.cu,
// sym_stream.cu): f32-accurate products on the tensor cores, fed by a
// cp.async ring of shared-memory stages.
//
// What bounds an f32 product on an H100: FFMA runs at 67 TFLOP/s, which
// cuBLAS SGEMM already nearly reaches, while the tensor cores' TF32 rate
// is 495 TFLOP/s.  One TF32 product keeps 11 significant bits and cannot
// meet the port's f32 tolerance (2e-5), so every operand is split as
// x = big + small with big = tf32(x) rounded to nearest and small =
// x - big, of which the tensor cores read the top 19 bits (truncated to
// TF32: an error of at most 2^-21 |x|), and each product is big·big' +
// big·small' + small·big' (the small·small term, below f32 rounding, is
// dropped, as CUTLASS's 3xTF32 "fast accurate" mode does): three
// mma.sync.m16n8k8 TF32 instructions per fragment pair, accumulated in
// f32 registers, so 495/3 = 165 TFLOP/s of f32-accurate products at
// most.  The split happens when a fragment is loaded from shared memory
// into registers (split_tf32 below); nothing is stored twice.
//
// Why mma.sync and not wgmma: wgmma in tf32 takes both shared-memory
// operands K-major only, and SYMM's B is N-major and its transposed
// tiles M-major; both would need a transposing stage (ROADMAP B1/B2).
//
// The tensor cores add into their accumulator with truncation, not
// round-to-nearest, so a long sum of same-signed products (the diagonal
// of a Gram matrix) drifts low by up to an ulp per addition: 768
// additions over K = 2048 cost 2e-5 relative.  So each kBK-deep panel
// is summed in its own zeroed mma accumulator (12 additions of terms
// 1/64 of the total's size) and added to the f32 total with an IEEE
// add (add_panel).
//
// The pipeline: a ring of shared-memory stages, each filled by cp.async
// (16 B a thread where rows are 16 B-aligned, 4 B otherwise, zero-fill
// past the operand's edge).  While panel p is multiplied, the copies of
// panels p+1 .. p+STAGES-1 are in flight.  One __syncthreads per panel.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32), lane = 4*g + t:
//   A (16 x 8, row): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B (8 x 8, col):  b0 (k=t, n=g), b1 (k=t+4, n=g)
//   C (16 x 8):      c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

// contraction depth of one pipeline stage, in f32 words (both kernels;
// PANEL_K in kernels/trigrid.py)
constexpr int kBK = 32;

template <typename T>
__device__ __forceinline__ T from_f32(float x);

template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// ---------------------------------------------------------------- cp.async
// Copies of 16 or 4 bytes; with ok == false nothing is read and the
// destination is zero-filled (src-size 0), src must still be a valid
// address.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared-memory row of contraction index k (0..kBK-1) in a k-major
// ([k][*]) panel: the rows are stored in the order k % 8, k / 8, so that
// the rows 8t + j which lanes t = 0..3 read together are neighbours.
__device__ __forceinline__ int krow(int k) { return (k & 7) * 4 + (k >> 3); }

// Copy a rows x cols f32 block (row stride ld_src in global memory,
// ld_dst in shared memory) with nthreads threads; rows >= rows_ok or
// columns >= cols_ok are zero-filled.  VEC: 16 B copies (cols, ld_src,
// cols_ok multiples of 4 and src 16 B-aligned) or 4 B copies.  KROWS:
// row r lands in shared row krow(r) (ROWS == kBK).
template <bool VEC, int ROWS, int COLS, int NTHREADS, bool KROWS = false>
__device__ __forceinline__ void stage_block(float* dst, int ld_dst,
                                            const float* src, long ld_src,
                                            int rows_ok, int cols_ok,
                                            int tid) {
  constexpr int W = VEC ? 4 : 1;
  constexpr int CPR = COLS / W;             // copies per row
  constexpr int N = ROWS * CPR;
#pragma unroll
  for (int e = tid; e < N; e += NTHREADS) {
    const int r = e / CPR, c = (e % CPR) * W;
    const bool ok = r < rows_ok && c < cols_ok;
    const float* s = ok ? src + (long)r * ld_src + c : src;
    float* d = dst + (KROWS ? krow(r) : r) * ld_dst + c;
    if constexpr (VEC) {
      cp_async16(d, s, ok);
    } else {
      cp_async4(d, s, ok);
    }
  }
}

// The ring of STAGES stages: load(stage, panel) issues the cp.async
// copies (and any plain shared stores) of one panel, compute(stage,
// panel) multiplies it.
template <int STAGES, class Load, class Compute>
__device__ __forceinline__ void pipeline(int npanels, Load&& load,
                                         Compute&& compute) {
  static_assert(STAGES >= 2, "a ring needs two stages");
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < npanels) load(s, s);
    cp_async_commit();
  }
  for (int p = 0; p < npanels; ++p) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();        // panel p landed; panel p-1's stage is free
    const int nxt = p + STAGES - 1;
    if (nxt < npanels) load(nxt % STAGES, nxt);
    cp_async_commit();
    compute(p % STAGES, p);
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------- 3xTF32
// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties
// away from zero), as an integer add and mask: the split runs for every
// fragment element a warp reads, and by the CUDA throughput table a
// conversion issues 16 results a clock an SM, an integer add or logic op
// 64.  trigrid.tf32_round repeats this bit for bit.  For a NaN the add
// may carry the mantissa into the exponent or the sign (the card's 0/0,
// 0x7FFFFFFF, becomes -0): split_tf32 keeps the NaN in small instead.
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// small = x - big is not rounded: the tensor cores read its top 19 bits
// (trigrid.tf32_truncate).  So a NaN x, whatever big became, gives a
// NaN small (a float subtraction; the card's NaN keeps every mantissa
// bit, so its top 19 bits are a NaN too), and an inf x gives big = inf
// and small = inf - inf = NaN: a product that meets a non-finite operand
// is NaN, never finite.  Rounding small as well, or guarding the
// rounding against NaN, measured slower on the card (tools/kernel_ab.py,
// PERF.md).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = rna_tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));   // exact if finite
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragment k order.  A kBK = 32 panel is 4 k8 steps; in step s lane t
// takes k = 8t + 2s in fragment slot t and k = 8t + 2s + 1 in slot t+4
// (any fixed assignment of k to slots gives the same product, as long
// as A and B agree).  Over the panel a lane then reads k = 8t .. 8t+7 of
// a k-contiguous row: two 16 B loads for four steps.

__device__ __forceinline__ float4 lds128(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float pick(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// acc[n] += A(16 x 8) · B(8 x 8n..) for one m-tile in 3xTF32: a holds
// the four raw A fragment values, (bb, bs) the split B fragments.
template <int NT>
__device__ __forceinline__ void mma_row_3xtf32(float (&acc)[NT][4],
                                               const float (&a)[4],
                                               const uint32_t (&bb)[NT][2],
                                               const uint32_t (&bs)[NT][2]) {
  uint32_t ab[4], as[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(a[e], ab[e], as[e]);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    mma_tf32(acc[n], as, bb[n]);     // small terms first
    mma_tf32(acc[n], ab, bs[n]);
    mma_tf32(acc[n], ab, bb[n]);
  }
}

// The A fragment of step 2h + s2 from a k-contiguous ([row][k]) panel,
// rows r and r + 8: lo / hi are the 16 B loads at k = 8t + 4h.
__device__ __forceinline__ void frag_kmajor(const float4& lo,
                                            const float4& hi, int s2,
                                            float (&a)[4]) {
  a[0] = pick(lo, 2 * s2);
  a[1] = pick(hi, 2 * s2);
  a[2] = pick(lo, 2 * s2 + 1);
  a[3] = pick(hi, 2 * s2 + 1);
}

// acc += A · B^T over one kBK-deep panel with both operands k-contiguous
// in shared memory: A rows wm0 + 16m + g (+8), B rows wn0 + 8n + g, row
// stride LD words (LD = 4 mod 32: the 16 B loads of a quarter warp
// cover the 32 banks once).
template <int MT, int NT, int LD>
__device__ __forceinline__ void panel_kmajor(float (&acc)[MT][NT][4],
                                             const float* A, const float* B,
                                             int wm0, int wn0, int g,
                                             int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t bb[2][NT][2], bs[2][NT][2];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float4 v = lds128(B + (wn0 + 8 * n + g) * LD + 8 * t + 4 * h);
#pragma unroll
      for (int s2 = 0; s2 < 2; ++s2) {
        split_tf32(pick(v, 2 * s2), bb[s2][n][0], bs[s2][n][0]);
        split_tf32(pick(v, 2 * s2 + 1), bb[s2][n][1], bs[s2][n][1]);
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float* row = A + (wm0 + 16 * m + g) * LD + 8 * t + 4 * h;
      const float4 lo = lds128(row), hi = lds128(row + 8 * LD);
#pragma unroll
      for (int s2 = 0; s2 < 2; ++s2) {
        float a[4];
        frag_kmajor(lo, hi, s2, a);
        mma_row_3xtf32<NT>(acc[m], a, bb[s2], bs[s2]);
      }
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;
    }
  }
}

// total += panel, round-to-nearest f32 adds
template <int MT, int NT>
__device__ __forceinline__ void add_panel(float (&total)[MT][NT][4],
                                          const float (&panel)[MT][NT][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) total[m][n][i] += panel[m][n][i];
    }
  }
}

// Raise a kernel's dynamic shared-memory limit (needed above 48 KB) on
// the current device; set before every launch, so that any device the
// caller switches to has it.  Returns the CUDA error code.
template <class Kernel>
inline int allow_smem(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace repro_torch
