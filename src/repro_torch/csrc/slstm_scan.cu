// slstm_scan.cu — the fused, stabilised sLSTM recurrence for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/slstm.py::slstm_scan
// (_slstm_kernel).  For every (b, channel) chain it runs, over t = 0..S-1,
//
//     m_t = max(f_t + m_{t-1}, i_t)
//     c_t = e^{f_t+m_{t-1}-m_t}·c_{t-1} + e^{i_t-m_t}·tanh(z_t)
//     n_t = e^{f_t+m_{t-1}-m_t}·n_{t-1} + e^{i_t-m_t}
//     y_t = σ(o_t)·c_t / max(n_t, 1)
//
// and writes y (B, S, d) and the final state (3, B, d) = (c1, n1, m1),
// all f32.  The gates are f32 or bf16 (upcast in registers, which is
// exact).  The algebra, and its order of operations, is that of
// models/ssm._slstm_seq, but for y's one division (steps() below).
//
// What bounds it on an H100.  Every gate is read once and every y written
// once: 4·4 + 4 bytes a step with f32 gates, 4·2 + 4 with bf16, so at the
// reference's traffic shape (16, 4096, 1024) the memory bound is 0.40 ms
// (f32) or 0.24 ms (bf16) at 3.35 TB/s.  A step issues some 90 SASS
// instructions (three expf, a tanhf, an IEEE division, its copy), about
// 0.18 ms of issue there at 1980 MHz.  The steps of one chain depend on
// each other, and at that shape the 16,384 chains are one warp per
// scheduler: a load latency per step (the first port) took 2.4 ms, and
// one step's chain of dependent instructions at a time 0.68 ms.
//
// Design.
// * One thread per chain keeps c, n, m in registers; a block holds 128
//   neighbouring channels of one batch row (ragged d masked), so the
//   loads and stores of a step are coalesced.  One pass over S: at the
//   serving shapes and at the reference's traffic shape a split of the
//   time axis (more chains, but every gate read twice) measured slower.
// * The mixer's layout: the four gates are the d-major views of one
//   (B, S, d, 4) tensor (channel stride 4), so one step of a chain is one
//   16-byte (f32) or 8-byte (bf16) quad (z, i, f, o).  Each thread streams
//   its own quads with cp.async through a ring of kRing = 32 slots in
//   shared memory (64 KB a block with f32, 32 KB with bf16), 24 steps
//   ahead of its arithmetic: 6.3 MB (f32) / 3.1 MB (bf16) in flight over
//   the card at (16, 4096, 1024), above the ~2.3 MB that 3.35 TB/s at
//   ~0.7 µs latency asks for (tools/kernel_ab.py times other depths).
//   A thread reads only the slots it filled itself, so no barrier is
//   needed; the copies are issued without a branch (a zero fill past the
//   end).  Any other views take the general path: four loads a step at
//   their own strides.
// * A thread works on kGroup = 8 steps at a time, part by part, and reads
//   the next group while it finishes this one (steps() below): with one
//   warp per scheduler only the warp's own independent instructions hide
//   latency, and each IEEE division's slow-path branch ends the
//   compiler's scheduling region.
// * Precise expf / tanhf and IEEE division (no --use_fast_math): the
//   reference holds y to 2e-5.
//
// Plain C interface, bound with ctypes (repro_torch/kernels/native.py).

#include <cuda_runtime.h>

namespace {

constexpr int kChannels = 128;  // threads (chains) per block
constexpr int kRing = 32;       // steps in a thread's ring of gate quads
constexpr int kGroup = 8;       // steps a thread works on side by side

// The four gates: pointers and element strides (b, t, channel).  On the
// quad path only p[0] (the (B, S, d, 4) tensor) and s[0] are read.
struct Gates {
  const void* p[4];
  long long s[4][3];
};

struct Args {
  Gates g;
  const float* c0;
  const float* n0;
  const float* m0;
  float* y;      // (B, S, d)
  float* state;  // (3, B, d): c1, n1, m1
  int B, S, d;
};

struct F32 {
  using Elem = float;
  using Quad = float4;
  __device__ static float4 unpack(float4 q) { return q; }
  __device__ static float one(const float* p) { return __ldg(p); }
};

struct BF16 {  // bf16 bits; the upcast is a shift
  using Elem = unsigned short;
  using Quad = uint2;
  __device__ static float4 unpack(uint2 q) {
    return make_float4(__uint_as_float(q.x << 16),
                       __uint_as_float(q.x & 0xFFFF0000u),
                       __uint_as_float(q.y << 16),
                       __uint_as_float(q.y & 0xFFFF0000u));
  }
  __device__ static float one(const unsigned short* p) {
    return __uint_as_float(static_cast<unsigned>(__ldg(p)) << 16);
  }
};

// A copy of kBytes (4, 8 or 16), or, with ok == false, a zero fill that
// reads nothing (src must still be a valid address): no branch.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(ok ? 16 : 0) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(src), "n"(kBytes), "r"(ok ? kBytes : 0) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One chain's gates over steps 0 .. S-1: fetch<K>(j, q) puts steps
// j .. j+K-1 (K <= kGroup) as (z, i, f, o) into q, called for j = 0, K,
// ... in order, each group's fetch (after the first) preceded by one
// refill<K>(); a fetch may reach up to kGroup steps past S-1 (zeros, or
// step S-1 again).
template <class G, bool kQuad>
struct Stream;

template <class G>
struct Stream<G, true> {
  using Q = typename G::Quad;
  // a fetch reads its K slots, the refill refills slots of steps already
  // read
  static constexpr int kAhead = kRing - kGroup;
  const typename G::Elem* src;   // step 0
  const typename G::Elem* next;  // step `issued`
  long long step;
  Q* ring;
  int n, issued = 0;

  __device__ Stream(const Gates& g, long long b, int ch, int n_, Q* ring_)
      : src(static_cast<const typename G::Elem*>(g.p[0]) + b * g.s[0][0] +
            4LL * ch),
        next(src), step(g.s[0][1]), ring(ring_ + threadIdx.x), n(n_) {
    if (n > 0) {
      for (int j = 0; j < kAhead; ++j) issue();
    }
  }
  __device__ __forceinline__ void issue() {  // the next step, or nothing
    const bool ok = issued < n;
    cp_async<sizeof(Q)>(ring + (issued & (kRing - 1)) * kChannels,
                        ok ? next : src, ok);
    next += step;
    ++issued;
    cp_async_commit();
  }
  template <int K>
  __device__ __forceinline__ void fetch(int j, float4 (&q)[K]) {
    cp_async_wait<kAhead - K>();  // steps j .. j+K-1 have landed
#pragma unroll
    for (int u = 0; u < K; ++u) {
      q[u] = G::unpack(ring[((j + u) & (kRing - 1)) * kChannels]);
    }
  }
  template <int K>
  __device__ __forceinline__ void refill() {
#pragma unroll
    for (int u = 0; u < K; ++u) issue();
  }
};

template <class G>
struct Stream<G, false> {
  const typename G::Elem* p[4];
  long long st[4];
  int last;  // steps past it read it again

  __device__ Stream(const Gates& g, long long b, int ch, int n,
                    typename G::Quad*)
      : last(max(n - 1, 0)) {
    for (int k = 0; k < 4; ++k) {
      st[k] = g.s[k][1];
      p[k] = static_cast<const typename G::Elem*>(g.p[k]) + b * g.s[k][0] +
             ch * g.s[k][2];
    }
  }
  template <int K>
  __device__ __forceinline__ void fetch(int j, float4 (&q)[K]) {
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const long long t = min(j + u, last);
      q[u] = make_float4(G::one(p[0] + t * st[0]), G::one(p[1] + t * st[1]),
                         G::one(p[2] + t * st[2]), G::one(p[3] + t * st[3]));
    }
  }
  template <int K>
  __device__ __forceinline__ void refill() {}
};

template <class G, bool kQuad>
constexpr int ring_bytes() {
  return kQuad ? kRing * kChannels * int(sizeof(typename G::Quad)) : 0;
}

// The part of K steps that does not depend on the state: tanh(z) and
// 1 + e^{-o} (y = σ(o)·c / max(n, 1) is computed as
// c / ((1 + e^{-o})·max(n, 1)): one IEEE division a step instead of the
// plain version's two (sigmoid, then y), a few ulps from it).
template <int K>
struct Free {
  float th[K], den[K];
  __device__ __forceinline__ void of(const float4 (&q)[K]) {
#pragma unroll
    for (int u = 0; u < K; ++u) {
      th[u] = tanhf(q[u].x);
      den[u] = 1.0f + expf(-q[u].w);
    }
  }
};

// The state's part of K steps from (c, n, m), each part for all K steps
// before the next (the m chain; the exponentials; the c, n chain; y), so
// that the K steps' independent work sits side by side.  ahead() runs
// between the c, n chain and the divisions, whose slow-path branches end
// the compiler's scheduling regions: there the next group's reads and
// Free part fill the wait on the chain (software pipelining), and only
// the chain, which needs nothing from memory, opens the next group.
template <int K, class Ahead>
__device__ __forceinline__ void steps(const float4 (&q)[K], Free<K> fr,
                                      float& c, float& nn, float& m,
                                      float* y, long long ystep,
                                      Ahead ahead) {
  float mm[K + 1];
  mm[0] = m;
#pragma unroll
  for (int u = 0; u < K; ++u) mm[u + 1] = fmaxf(q[u].z + mm[u], q[u].y);
  m = mm[K];
  float cy[K];
#pragma unroll
  for (int u = 0; u < K; ++u) {
    const float e_f = expf(q[u].z + mm[u] - mm[u + 1]);
    const float e_i = expf(q[u].y - mm[u + 1]);
    c = e_f * c + e_i * fr.th[u];
    nn = e_f * nn + e_i;
    fr.den[u] *= fmaxf(nn, 1.0f);
    cy[u] = c;
  }
  ahead();
#pragma unroll
  for (int u = 0; u < K; ++u) y[u * ystep] = cy[u] / fr.den[u];
}

// grid (⌈d/128⌉, B): one block per 128 channels of one batch row.
template <class G, bool kQuad>
__global__ void __launch_bounds__(kChannels) slstm_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];  // the ring
  typename G::Quad* ring = reinterpret_cast<typename G::Quad*>(smem);
  const int ch = blockIdx.x * kChannels + threadIdx.x;
  if (ch >= a.d) return;
  const long long b = blockIdx.y;
  const long long bd = static_cast<long long>(a.B) * a.d, idx = b * a.d + ch;
  const int n = a.S;
  Stream<G, kQuad> gate(a.g, b, ch, n, ring);
  float c = a.c0[idx], nn = a.n0[idx], m = a.m0[idx];
  float* yp = a.y + b * a.S * a.d + ch;
  const long long ys = a.d;
  int j = 0;
  if (n >= kGroup) {  // groups of kGroup steps, each reading the next
    float4 q[kGroup];
    Free<kGroup> fr;
    gate.template fetch<kGroup>(0, q);
    fr.of(q);
    for (;;) {
      float4 qn[kGroup];
      Free<kGroup> frn;
      steps(q, fr, c, nn, m, yp + j * ys, ys, [&] {
        gate.template refill<kGroup>();
        gate.template fetch<kGroup>(j + kGroup, qn);
        frn.of(qn);
      });
      j += kGroup;
      if (j + kGroup > n) break;
#pragma unroll
      for (int u = 0; u < kGroup; ++u) q[u] = qn[u];
      fr = frn;
    }
  }
  for (; j < n; ++j) {  // the last steps one at a time
    float4 q[1];
    Free<1> fr;
    gate.template fetch<1>(j, q);
    fr.of(q);
    steps(q, fr, c, nn, m, yp + j * ys, ys,
          [&] { gate.template refill<1>(); });
  }
  a.state[idx] = c;
  a.state[bd + idx] = nn;
  a.state[2 * bd + idx] = m;
}

template <class G, bool kQuad>
int launch(const Args& a, void* stream) {
  constexpr int smem = ring_bytes<G, kQuad>();
  if constexpr (smem > 48 * 1024) {  // dynamic shared memory past 48 KB
    static const cudaError_t opted_in = cudaFuncSetAttribute(
        slstm_kernel<G, kQuad>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (opted_in != cudaSuccess) return static_cast<int>(opted_in);
  }
  const int gx = (a.d + kChannels - 1) / kChannels;
  slstm_kernel<G, kQuad><<<dim3(gx, a.B), kChannels, smem,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The mixer's layout: the gates are the views (.., 0..3) of one (B, S, d,
// 4) tensor at `base` (f32, or bf16 with bf16 != 0), b and t strides sb,
// st in elements (multiples of 4; base 16-byte (f32) or 8-byte (bf16)
// aligned).  c0/n0/m0: contiguous (B, d) f32; y: contiguous (B, S, d) f32;
// state: contiguous (3, B, d) f32.  Launches on `stream`; returns
// cudaGetLastError() after the launch.
extern "C" int repro_slstm_scan_quad(int bf16, const void* base,
                                     long long sb, long long st,
                                     const float* c0, const float* n0,
                                     const float* m0, float* y, float* state,
                                     int B, int S, int d, void* stream) {
  Args a{};
  a.g.p[0] = base;
  a.g.s[0][0] = sb;
  a.g.s[0][1] = st;
  a.g.s[0][2] = 4;
  a.c0 = c0, a.n0 = n0, a.m0 = m0, a.y = y, a.state = state;
  a.B = B, a.S = S, a.d = d;
  return bf16 ? launch<BF16, true>(a, stream) : launch<F32, true>(a, stream);
}

// Any other views: z/ig/fg/og (B, S, d) with element strides (b, t,
// channel) each; the rest as above.
extern "C" int repro_slstm_scan(
    int bf16, const void* z, long long zb, long long zt, long long zc,
    const void* ig, long long ib, long long it, long long ic,
    const void* fg, long long fb, long long ft, long long fc,
    const void* og, long long ob, long long ot, long long oc,
    const float* c0, const float* n0, const float* m0, float* y,
    float* state, int B, int S, int d, void* stream) {
  Args a{};
  const void* p[4] = {z, ig, fg, og};
  const long long s[4][3] = {{zb, zt, zc}, {ib, it, ic}, {fb, ft, fc},
                             {ob, ot, oc}};
  for (int g = 0; g < 4; ++g) {
    a.g.p[g] = p[g];
    for (int x = 0; x < 3; ++x) a.g.s[g][x] = s[g][x];
  }
  a.c0 = c0, a.n0 = n0, a.m0 = m0, a.y = y, a.state = state;
  a.B = B, a.S = S, a.d = d;
  return bf16 ? launch<BF16, false>(a, stream)
              : launch<F32, false>(a, stream);
}

// The ring's shared memory a block of the quad path uses with f32 (bf16
// == 0) or bf16 gates (dynamic, so ptxas reports 0 for it).
extern "C" int repro_slstm_ring_bytes(int bf16) {
  return bf16 ? ring_bytes<BF16, true>() : ring_bytes<F32, true>();
}
