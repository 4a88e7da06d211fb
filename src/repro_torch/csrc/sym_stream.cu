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
// Two kernels behind two entry points; the wrapper picks by n2.  A
// stack of products (the Newton-Schulz chain of a stacked layer weight in
// Muon) is one launch of the wide kernel: grid z picks the matrix, each
// computed exactly as its own launch would, bit for bit.  The narrow
// kernel takes one matrix a launch; the wrapper loops over a stack.
//
// repro_sym_stream (n2 > 8): the Newton-Schulz products and seed.  Each
// 2048^2 x 2048^2 product does 17.2 GFLOP against ~41 MB, so it is bound by
// the tensor cores: 3 x 17.2 GFLOP / 495 TFLOP/s = 0.104 ms in 3xTF32
// (tile_mma.cuh).  A block owns a ROWS x BN output block whatever the packed
// format bm (8..128): 128 x 128, or 64 x 64 where 128 x 128 blocks would
// leave SMs idle (d = 1024: 256 blocks, not 64), and loops over 32-deep
// contraction panels through a cp.async ring. The panel of sym_s(A) (ROWS x
// 32) is assembled from h x w sub-tiles (h = min(bm, ROWS), w = min(bm,
// 32)), each with its own packed tile index and mode from a device table
// that trigrid.symm_subtiles builds from symm_lookup (mode 0 as stored, 1
// transposed, 2 diagonal, 3 past the matrix edge).  Every sub-tile is staged
// as it is stored, with straight cp.async: the rows of a mode-0 tile into AN
// ([row][k]), those of a mode-1 tile into AT ([k][row]), a diagonal tile
// into both, a mode-3 one as zeros into AN.  The mode is applied when the
// fragment is read: AN for modes 0 and 3, AT for mode 1, and for mode 2 AN
// on and below the diagonal, AT above it, with diag_scale on it.  The upper
// half of a diagonal tile is copied but only ever selected away, never
// multiplied by zero, so a NaN there cannot reach the output.  Panels whose
// sub-tiles all read one array (15 of 16 at the NS shapes) skip the
// per-element select: reading every panel through it measured about
// twice as slow on the card (tools/kernel_ab.py, PERF.md).  Rows
// past n1 and columns past n2 are zero-filled (4 B copies of B when its rows
// are not 16 B-aligned), so any n2 works.  On the H100 it reaches about a
// quarter of the tensor-core bound (PERF.md).
//
// repro_sym_stream_narrow (n2 <= 8, the per-request embedding W p): a
// matrix-vector product bound by reading the packed tiles once (8.9 MB
// at d = 2048: 2.7 us at 3.35 TB/s).  IEEE FFMA.  One block per packed
// tile (i, k) and 32-row slab reads its rows once, in 16 B pieces, and
// uses them twice: U = tile x_k for y_i and V = tile^T x_i for y_k; a
// diagonal tile is symmetrised from its lower half by the same selects
// (U from the lower half with diag_scale on the diagonal, V from the
// strict lower half).  U and the slabs' V go to a scratch of partials
// that the wrapper allocates, and a second small kernel sums them per
// output row block in a fixed order (y_i = sum_{k<=i} U(i,k) +
// sum_{j>=i} V(j,i)): no atomics, so a product is the same from run to
// run.
#include <cstdint>

#include "tile_mma.cuh"

namespace repro_torch {

constexpr int kLDN = kBK + 4;         // AN row: [ROWS][kBK + 4]
constexpr int kMaxSub = 64;           // sub-tiles per panel at bm = 8
constexpr int kStages = 3;            // pipeline depth

// ROWS x BN output blocks (SYMM_BLOCKS in kernels/trigrid.py): 32 x 32
// warp tiles, 64 x 32 at 128 x 128
template <int ROWS, int BN>
struct SymCfg {
  static constexpr int WN = BN / 32;                       // warps along
  static constexpr int WM = ROWS / 32 < 8 / WN ? ROWS / 32 : 8 / WN;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int MT = ROWS / WM / 16;
  static constexpr int NT = BN / WN / 8;
  static_assert(NT == 4, "one 16 B load of B feeds a lane's four n-tiles");
  static constexpr int LDT = ROWS + 8;          // AT row: [kBK][ROWS + 8]
  static constexpr int LDB = BN + 8;            // B row: [kBK][BN + 8]
  // per stage: AN, AT, B, then kMaxSub modes and the panel's summary
  static constexpr int StageWords =
      ROWS * kLDN + kBK * LDT + kBK * LDB + kMaxSub + 4;
  static constexpr int Smem = kStages * StageWords * 4;
};

template <int ROWS, int BN, bool VEC, typename OutT>
__global__ void __launch_bounds__(SymCfg<ROWS, BN>::kThreads)
sym_stream_kernel(const float* __restrict__ tiles,
                  const float* __restrict__ b, int n1, int n2, int log_bm,
                  const int* __restrict__ sub, float diag_scale,
                  OutT* __restrict__ out) {
  using C = SymCfg<ROWS, BN>;
  extern __shared__ __align__(16) float smem[];
  const int bm = 1 << log_bm, mask = bm - 1;
  {  // matrix blockIdx.z of a stack, computed exactly as alone
    const long z = blockIdx.z, nt = n1 >> log_bm;
    tiles += z * ((nt * (nt + 1) / 2) << (2 * log_bm));
    b += z * n1 * n2;
    out += z * n1 * n2;
  }
  constexpr int kLogRows = ROWS == 128 ? 7 : 6;
  const int log_h = log_bm < kLogRows ? log_bm : kLogRows;  // sub-tile
  const int log_w = log_bm < 5 ? log_bm : 5;                // h x w
  const int w = 1 << log_w;
  const int sc = kBK >> log_w;                       // sub-tiles per row
  const int nsub = (ROWS >> log_h) * sc;
  const int npanels = (n1 + kBK - 1) / kBK;
  const int I = blockIdx.y;
  const int R0 = I * ROWS, C0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp / C::WN) * (ROWS / C::WM);
  const int wn0 = (warp % C::WN) * (BN / C::WN);

  float acc[C::MT][C::NT][4], part[C::MT][C::NT][4];
  zero_acc(acc);

  auto load = [&](int s, int p) {
    float* AN = smem + s * C::StageWords;
    float* AT = AN + ROWS * kLDN;
    float* Bs = AT + kBK * C::LDT;
    int* md = reinterpret_cast<int*>(Bs + kBK * C::LDB);
    const int k0 = p * kBK;
    const int* codes = sub + ((long)I * npanels + p) * nsub;
    if (tid < nsub) md[tid] = __ldg(codes + tid) & 3;
    if (tid == 0) {          // 0: all read AN, 1: all read AT, 2: mixed
      int any_n = 0, any_t = 0;
      for (int e = 0; e < nsub; ++e) {
        const int m = __ldg(codes + e) & 3;
        any_n |= m != 1;
        any_t |= m == 1 || m == 2;
      }
      md[kMaxSub] = any_t ? (any_n ? 2 : 1) : 0;
    }
    if (sc == 1) {           // bm >= 32: whole-width bands of h rows
      const int q0 = k0 & mask, log_q = log_h - 2;   // h / 4 copies a row
      for (int band = 0; band < nsub; ++band) {
        const int code = __ldg(codes + band), mode = code & 3;
        const float* tile = tiles + ((long)(code >> 2) << (2 * log_bm));
        const int b0 = band << log_h, r0 = (R0 + b0) & mask;
        if (mode != 1) {     // rows b0 .. b0+h, k0 .. k0+32 as stored
          const bool ok = mode != 3;
          for (int e = tid; e < (8 << log_h); e += C::kThreads) {
            const int R = e >> 3, kc = (e & 7) * 4;
            cp_async16(AN + (b0 + R) * kLDN + kc,
                       ok ? tile + (long)(r0 + R) * bm + q0 + kc : tiles,
                       ok);
          }
        }
        if (mode == 1 || mode == 2) {   // stored rows k0 .. k0+32
          for (int e = tid; e < (kBK << log_q); e += C::kThreads) {
            const int kr = e >> log_q, Rc = (e & ((1 << log_q) - 1)) * 4;
            cp_async16(AT + krow(kr) * C::LDT + b0 + Rc,
                       tile + (long)(q0 + kr) * bm + r0 + Rc, true);
          }
        }
      }
    } else {                 // bm < 32: sub-tiles of h x w, per copy
      // AN: ROWS rows x kBK, 4-word copies
      for (int e = tid; e < ROWS * (kBK / 4); e += C::kThreads) {
        const int R = e / (kBK / 4), kc = (e % (kBK / 4)) * 4;
        const int cs = kc >> log_w;
        const int code = __ldg(codes + (R >> log_h) * sc + cs);
        const int mode = code & 3;
        if (mode == 1) continue;
        const bool ok = mode != 3;
        const int q = ((k0 + cs * w) & mask) + (kc & (w - 1));
        const float* src =
            ok ? tiles + ((long)(code >> 2) << (2 * log_bm)) +
                     (long)((R0 + R) & mask) * bm + q
               : tiles;
        cp_async16(AN + R * kLDN + kc, src, ok);
      }
      // AT: kBK rows (k) x ROWS (row of the output), 4-word copies
      for (int e = tid; e < kBK * (ROWS / 4); e += C::kThreads) {
        const int kr = e / (ROWS / 4), Rc = (e % (ROWS / 4)) * 4;
        const int cs = kr >> log_w;
        const int code = __ldg(codes + (Rc >> log_h) * sc + cs);
        const int mode = code & 3;
        if (mode != 1 && mode != 2) continue;
        const int q = ((k0 + cs * w) & mask) + (kr & (w - 1));
        cp_async16(AT + krow(kr) * C::LDT + Rc,
                   tiles + ((long)(code >> 2) << (2 * log_bm)) +
                       (long)q * bm + ((R0 + Rc) & mask),
                   true);
      }
    }
    stage_block<VEC, kBK, BN, C::kThreads, true>(
        Bs, C::LDB, b + (long)k0 * n2 + C0, n2, n1 - k0, n2 - C0, tid);
  };

  // Fragment reads (k order as in tile_mma.cuh: step s, lane t takes
  // k = 8t + 2s and 8t + 2s + 1).  B and AT are k-major with rows in
  // krow order, so the rows of lanes t = 0..3 are neighbours.  B's
  // columns are assigned so that a lane's four n-tiles are neighbours:
  // n-tile n, fragment column j is output column wn0 + 4j + n, and one
  // 16 B load gives a k's values for all four.
  auto compute = [&](int s, int p) {
    const float* AN = smem + s * C::StageWords;
    const float* AT = AN + ROWS * kLDN;
    const float* Bs = AT + kBK * C::LDT;
    const int* md = reinterpret_cast<const int*>(Bs + kBK * C::LDB);
    const int uniform = md[kMaxSub];
    const int kg0 = p * kBK;
    zero_acc(part);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t bb[2][C::NT][2], bs[2][C::NT][2];
#pragma unroll
      for (int s2 = 0; s2 < 2; ++s2) {
        const int ks = 8 * (2 * h + s2) + t;       // krow(8t + 2s)
        const float4 v0 = lds128(Bs + ks * C::LDB + wn0 + 4 * g);
        const float4 v1 = lds128(Bs + (ks + 4) * C::LDB + wn0 + 4 * g);
#pragma unroll
        for (int n = 0; n < C::NT; ++n) {
          split_tf32(pick(v0, n), bb[s2][n][0], bs[s2][n][0]);
          split_tf32(pick(v1, n), bb[s2][n][1], bs[s2][n][1]);
        }
      }
#pragma unroll
      for (int m = 0; m < C::MT; ++m) {
        const int R = wm0 + 16 * m + g;
        float a[2][4];
        if (uniform == 0) {              // all as stored (or zeros)
          const float* row = AN + R * kLDN + 8 * t + 4 * h;
          const float4 lo = lds128(row), hi = lds128(row + 8 * kLDN);
          frag_kmajor(lo, hi, 0, a[0]);
          frag_kmajor(lo, hi, 1, a[1]);
        } else if (uniform == 1) {       // all transposed
#pragma unroll
          for (int s2 = 0; s2 < 2; ++s2) {
            const float* r0 = AT + (8 * (2 * h + s2) + t) * C::LDT + R;
            a[s2][0] = r0[0];
            a[s2][1] = r0[8];
            a[s2][2] = r0[4 * C::LDT];
            a[s2][3] = r0[4 * C::LDT + 8];
          }
        } else {                          // per element, by sub-tile mode
#pragma unroll
          for (int s2 = 0; s2 < 2; ++s2) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = R + 8 * (e & 1);
              const int k = 8 * t + 2 * (2 * h + s2) + (e >> 1);
              const int mode = md[(r >> log_h) * sc + (k >> log_w)];
              const int rg = R0 + r, kg = kg0 + k;
              const bool lower =
                  mode == 0 || mode == 3 || (mode == 2 && rg >= kg);
              float v = lower ? AN[r * kLDN + k] : AT[krow(k) * C::LDT + r];
              if (mode == 2 && rg == kg) v *= diag_scale;
              a[s2][e] = v;
            }
          }
        }
#pragma unroll
        for (int s2 = 0; s2 < 2; ++s2) {
          mma_row_3xtf32<C::NT>(part[m], a[s2], bb[s2], bs[s2]);
        }
      }
    }
    add_panel(acc, part);
  };

  pipeline<kStages>(npanels, load, compute);

#pragma unroll
  for (int m = 0; m < C::MT; ++m) {
#pragma unroll
    for (int n = 0; n < C::NT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = R0 + wm0 + 16 * m + g + 8 * (i >> 1);
        const int c = C0 + wn0 + 4 * (2 * t + (i & 1)) + n;
        if (r < n1 && c < n2) {
          out[(long)r * n2 + c] = from_f32<OutT>(acc[m][n][i]);
        }
      }
    }
  }
}

// ------------------------------------------------------------ n2 <= 8
// Block (t, slab): rows slab*kSlab .. +kSlab (at most bm) of packed tile
// t, 128 threads, each loading its rows' 16 B pieces before using them
// (up to 8 loads in flight a thread).
constexpr int kNarrowThreads = 128;
constexpr int kSlab = 32;

__host__ __device__ constexpr int slab_rows(int bm) {
  return bm < kSlab ? bm : kSlab;
}

// part: (T, 1 + slabs, bm, n2): [t][0] = U = tile x_k (rows of y_i),
// [t][1 + slab] = that slab's share of V = tile^T x_i (rows of y_k)
template <int NC>
__global__ void __launch_bounds__(kNarrowThreads)
symv_partial_kernel(const float* __restrict__ tiles,
                    const float* __restrict__ x, int n2, int log_bm,
                    const int* __restrict__ imap,
                    const int* __restrict__ jmap, float diag_scale,
                    float* __restrict__ part) {
  __shared__ float xi[kSlab * NC], xk[128 * NC];
  __shared__ float red[4 * kNarrowThreads * NC];
  const long t = blockIdx.x;
  const int i = imap[t], k = jmap[t];
  const int bm = 1 << log_bm, sr = slab_rows(bm), slabs = bm / sr;
  const int r_lo = blockIdx.y * sr;
  const int tid = threadIdx.x;
  const bool diag = i == k;
  for (int e = tid; e < bm * NC; e += kNarrowThreads) {
    const int r = e / NC, c = e % NC;
    xk[e] = c < n2 ? x[((long)k * bm + r) * n2 + c] : 0.f;
    if (r < sr) {
      xi[e] = c < n2 ? x[((long)i * bm + r_lo + r) * n2 + c] : 0.f;
    }
  }

  // thread (rg, ch): columns q0 .. q0+3 of rows r_lo + rg + rpp * p
  const int cpr = bm / 4, rpp = kNarrowThreads / cpr;
  const int ch = tid % cpr, rg = tid / cpr, q0 = 4 * ch;
  const float* tile = tiles + (t << (2 * log_bm));
  constexpr int kPass = kSlab / (kNarrowThreads / 32);  // rows a thread
                                                        // reads at bm 128
  float4 w[kPass];
#pragma unroll
  for (int p = 0; p < kPass; ++p) {
    const int r = rg + rpp * p;
    w[p] = r < sr ? *reinterpret_cast<const float4*>(
                        tile + (long)(r_lo + r) * bm + q0)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();                        // x slices staged

  float xkr[4][NC], v[4][NC];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      xkr[j][c] = xk[(q0 + j) * NC + c];
      v[j][c] = 0.f;
    }
  }
  float* pu = part + ((t * (1 + slabs)) << log_bm) * n2;
  float* pv = part + ((t * (1 + slabs) + 1 + blockIdx.y) << log_bm) * n2;
#pragma unroll
  for (int p = 0; p < kPass; ++p) {
    const int rl = rg + rpp * p;            // row within the slab
    const bool live = rl < sr;
    const int r = r_lo + rl;                // row within the tile
    const float wv[4] = {w[p].x, w[p].y, w[p].z, w[p].w};
    float au[4], av[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = q0 + j;
      // selects, never products with the upper half of a diagonal tile
      au[j] = !diag || r > q ? wv[j] : (r == q ? diag_scale * wv[j] : 0.f);
      av[j] = !diag || r > q ? wv[j] : 0.f;
    }
    float u[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      u[c] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) u[c] = fmaf(au[j], xkr[j][c], u[c]);
    }
    if (live) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float xr = xi[rl * NC + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j][c] = fmaf(av[j], xr, v[j][c]);
      }
    }
    for (int off = cpr / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        u[c] += __shfl_xor_sync(0xffffffffu, u[c], off);
      }
    }
    if (live && ch == 0) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (c < n2) pu[(long)r * n2 + c] = u[c];
      }
    }
  }
  // V: sum the row groups' partials of each column q, in a fixed order
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int c = 0; c < NC; ++c) red[(rg * bm + q0 + j) * NC + c] = v[j][c];
  }
  __syncthreads();
  const int groups = rpp < sr ? rpp : sr;
  for (int e = tid; e < bm * NC; e += kNarrowThreads) {
    float sum = 0.f;
    for (int gi = 0; gi < groups; ++gi) sum += red[gi * bm * NC + e];
    const int q = e / NC, c = e % NC;
    if (c < n2) pv[(long)q * n2 + c] = sum;
  }
}

// Block i sums the partials of output row block i: thread (x, y) takes
// elements x, x + 128, ... of the block's bm x n2 and every 8th of their
// L = (i + 1) + (nt - i) * slabs partials from y on; the 8 row sums are
// then added in order of y.  The same order every run.
constexpr int kSumX = 128, kSumY = 8;

template <typename OutT>
__global__ void __launch_bounds__(kSumX * kSumY)
symv_reduce_kernel(const float* __restrict__ part, int nt, int log_bm,
                   int n2, OutT* __restrict__ out) {
  __shared__ float red[kSumY][kSumX];
  const int i = blockIdx.x, x = threadIdx.x, y = threadIdx.y;
  const int bm = 1 << log_bm, slabs = bm / slab_rows(bm);
  const long stride = 1 + slabs;
  const int L = (i + 1) + (nt - i) * slabs;
  const int E = bm * n2;
  for (int e0 = 0; e0 < E; e0 += kSumX) {
    const int e = e0 + x;
    float s = 0.f;
    if (e < E) {
#pragma unroll 4
      for (int l = y; l < L; l += kSumY) {
        long slot;                         // (tile, part) of partial l
        if (l <= i) {                      // U(i, l)
          slot = ((long)i * (i + 1) / 2 + l) * stride;
        } else {                           // V(j, i), slab sl
          const int j = i + (l - i - 1) / slabs;
          const int sl = 1 + (l - i - 1) % slabs;
          slot = ((long)j * (j + 1) / 2 + i) * stride + sl;
        }
        s += part[(slot << log_bm) * n2 + e];
      }
    }
    red[y][x] = s;
    __syncthreads();
    if (y == 0 && e < E) {
      float tot = 0.f;
#pragma unroll
      for (int k = 0; k < kSumY; ++k) tot += red[k][x];
      out[((long)i << log_bm) * n2 + e] = from_f32<OutT>(tot);
    }
    __syncthreads();
  }
}

template <int ROWS, int BN, bool VEC, typename OutT>
static int launch_wide(const float* tiles, const float* b, int n1, int n2,
                       int batch, int log_bm, const int* sub, float ds,
                       void* out, cudaStream_t s) {
  using C = SymCfg<ROWS, BN>;
  auto kernel = sym_stream_kernel<ROWS, BN, VEC, OutT>;
  const int rc = allow_smem(kernel, C::Smem);
  if (rc != 0) return rc;
  dim3 grid((n2 + BN - 1) / BN, (n1 + ROWS - 1) / ROWS, batch);
  kernel<<<grid, C::kThreads, C::Smem, s>>>(tiles, b, n1, n2, log_bm, sub,
                                            ds, static_cast<OutT*>(out));
  return (int)cudaGetLastError();
}

template <int ROWS, int BN, typename OutT>
static int launch_wide_vec(bool vec, const float* tiles, const float* b,
                           int n1, int n2, int batch, int log_bm,
                           const int* sub, float ds, void* out,
                           cudaStream_t s) {
  return vec ? launch_wide<ROWS, BN, true, OutT>(tiles, b, n1, n2, batch,
                                                 log_bm, sub, ds, out, s)
             : launch_wide<ROWS, BN, false, OutT>(tiles, b, n1, n2, batch,
                                                  log_bm, sub, ds, out, s);
}

template <typename OutT>
static int dispatch_wide(int rows, int bn, bool vec, const float* tiles,
                         const float* b, int n1, int n2, int batch,
                         int log_bm, const int* sub, float ds, void* out,
                         cudaStream_t s) {
  if (rows == 128 && bn == 128) {
    return launch_wide_vec<128, 128, OutT>(vec, tiles, b, n1, n2, batch,
                                           log_bm, sub, ds, out, s);
  }
  if (rows == 64 && bn == 64) {
    return launch_wide_vec<64, 64, OutT>(vec, tiles, b, n1, n2, batch,
                                         log_bm, sub, ds, out, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <int NC>
static void launch_partial(long T, const float* tiles, const float* x,
                           int n2, int log_bm, const int* imap,
                           const int* jmap, float ds, float* part,
                           cudaStream_t s) {
  const int bm = 1 << log_bm;
  dim3 grid((unsigned)T, bm / slab_rows(bm));
  symv_partial_kernel<NC><<<grid, kNarrowThreads, 0, s>>>(
      tiles, x, n2, log_bm, imap, jmap, ds, part);
}

static int log2_tile(int bm) {
  int l = 0;
  while ((1 << l) < bm) ++l;
  return (bm >= 8 && bm <= 128 && (1 << l) == bm) ? l : -1;
}

}  // namespace repro_torch

// Plain C entry points (bound with ctypes).  tiles: (T, bm, bm) f32,
// T = nt(nt+1)/2, 16 B-aligned; b: (nt*bm, n2) row-major f32; out:
// (nt*bm, n2) f32 (out_bf16 = 0) or bf16 (1).  Each returns the CUDA
// error code of its launches (0 on success).
//
// bn: output columns per block, 128 or 64.  sub: the sub-tile table of
// trigrid.symm_subtiles(nt, bm), int32 (flat << 2 | mode) per (128-row
// block, 32-deep panel, sub-tile).  batch: a stack of that many
// (tiles, b, out) triples, contiguous, in one launch (grid z).
extern "C" int repro_sym_stream(int bm, int rows, int bn, const void* tiles,
                                const void* b, int nt, int n2, int batch,
                                const void* sub, float diag_scale, void* out,
                                int out_bf16, void* stream) {
  using namespace repro_torch;
  auto Tl = static_cast<const float*>(tiles);
  auto B = static_cast<const float*>(b);
  auto S = static_cast<const int*>(sub);
  auto s = static_cast<cudaStream_t>(stream);
  const int log_bm = log2_tile(bm);
  const long n1 = (long)nt * bm;
  if (log_bm < 0 || nt <= 0 || n2 <= 0 || n1 > 64L * 65535 ||
      batch <= 0 || batch > 65535 ||
      reinterpret_cast<uintptr_t>(Tl) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const bool vec = n2 % 4 == 0 && reinterpret_cast<uintptr_t>(B) % 16 == 0;
  return out_bf16 ? dispatch_wide<__nv_bfloat16>(rows, bn, vec, Tl, B, n1,
                                                 n2, batch, log_bm, S,
                                                 diag_scale, out, s)
                  : dispatch_wide<float>(rows, bn, vec, Tl, B, n1, n2,
                                         batch, log_bm, S, diag_scale, out,
                                         s);
}

// n2 <= 8: imap/jmap: (T,) int32 tile coordinates (trigrid.tri_coords);
// part: (T, 1 + bm / min(bm, 32), bm, n2) f32 scratch.  Two launches:
// partials, then their sums.
extern "C" int repro_sym_stream_narrow(int bm, const void* tiles,
                                       const void* b, int nt, int n2,
                                       const void* imap, const void* jmap,
                                       float diag_scale, void* part,
                                       void* out, int out_bf16,
                                       void* stream) {
  using namespace repro_torch;
  auto Tl = static_cast<const float*>(tiles);
  auto X = static_cast<const float*>(b);
  auto I = static_cast<const int*>(imap);
  auto J = static_cast<const int*>(jmap);
  auto P = static_cast<float*>(part);
  auto s = static_cast<cudaStream_t>(stream);
  const int log_bm = log2_tile(bm);
  if (log_bm < 0 || nt <= 0 || n2 <= 0 || n2 > 8 ||
      reinterpret_cast<uintptr_t>(Tl) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long T = (long)nt * (nt + 1) / 2;
  if (n2 == 1) {
    launch_partial<1>(T, Tl, X, n2, log_bm, I, J, diag_scale, P, s);
  } else if (n2 == 2) {
    launch_partial<2>(T, Tl, X, n2, log_bm, I, J, diag_scale, P, s);
  } else if (n2 <= 4) {
    launch_partial<4>(T, Tl, X, n2, log_bm, I, J, diag_scale, P, s);
  } else {
    launch_partial<8>(T, Tl, X, n2, log_bm, I, J, diag_scale, P, s);
  }
  const cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  const dim3 threads(kSumX, kSumY);
  if (out_bf16) {
    symv_reduce_kernel<__nv_bfloat16><<<nt, threads, 0, s>>>(
        P, nt, log_bm, n2, static_cast<__nv_bfloat16*>(out));
  } else {
    symv_reduce_kernel<float><<<nt, threads, 0, s>>>(
        P, nt, log_bm, n2, static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}
