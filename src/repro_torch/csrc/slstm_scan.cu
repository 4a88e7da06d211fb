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
// Training's forward (the quad path with a stash) also writes c_t, n_t,
// m_t of every step, and slstm_bwd_kernel (below) is its backward: the
// port's own, for the Pallas kernel has no VJP (the reference trains
// through its jnp mixer).
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

#include <cuda_bf16.h>
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
  float* stash;  // (3, B, S, d): c_t, n_t, m_t of every step, or nullptr
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
//
// With kStash, each step's c, n and m also go to the stash (planes
// `plane` apart, at y's strides): the training forward, whose backward
// (slstm_bwd_kernel) reads them.  y's arithmetic is the same either way.
template <int K, bool kStash, class Ahead>
__device__ __forceinline__ void steps(const float4 (&q)[K], Free<K> fr,
                                      float& c, float& nn, float& m,
                                      float* y, long long ystep, float* sp,
                                      long long plane, Ahead ahead) {
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
    if constexpr (kStash) {
      sp[u * ystep] = c;
      sp[plane + u * ystep] = nn;
      sp[2 * plane + u * ystep] = mm[u + 1];
    }
  }
  ahead();
#pragma unroll
  for (int u = 0; u < K; ++u) y[u * ystep] = cy[u] / fr.den[u];
}

// grid (⌈d/128⌉, B): one block per 128 channels of one batch row.
template <class G, bool kQuad, bool kStash>
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
  // the stash's plane stride and this chain's step 0 (unused without it)
  const long long plane = bd * a.S;
  float* sp = kStash ? a.stash + b * a.S * a.d + ch : nullptr;
  int j = 0;
  if (n >= kGroup) {  // groups of kGroup steps, each reading the next
    float4 q[kGroup];
    Free<kGroup> fr;
    gate.template fetch<kGroup>(0, q);
    fr.of(q);
    for (;;) {
      float4 qn[kGroup];
      Free<kGroup> frn;
      steps<kGroup, kStash>(q, fr, c, nn, m, yp + j * ys, ys,
                            sp + j * ys, plane, [&] {
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
    steps<1, kStash>(q, fr, c, nn, m, yp + j * ys, ys, sp + j * ys, plane,
                     [&] { gate.template refill<1>(); });
  }
  a.state[idx] = c;
  a.state[bd + idx] = nn;
  a.state[2 * bd + idx] = m;
}

template <class G, bool kQuad, bool kStash = false>
int launch(const Args& a, void* stream) {
  constexpr int smem = ring_bytes<G, kQuad>();
  if constexpr (smem > 48 * 1024) {  // dynamic shared memory past 48 KB
    static const cudaError_t opted_in = cudaFuncSetAttribute(
        slstm_kernel<G, kQuad, kStash>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (opted_in != cudaSuccess) return static_cast<int>(opted_in);
  }
  const int gx = (a.d + kChannels - 1) / kChannels;
  slstm_kernel<G, kQuad, kStash><<<dim3(gx, a.B), kChannels, smem,
                                   static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The backward: slstm_bwd_kernel
// ---------------------------------------------------------------------------
// One thread per (b, channel) chain, as the forward, walking t from S-1
// down to 0 with the gradients it carries (gc, gn, gm: of c_t, n_t,
// m_t).  It reads step t's gate quad, gy_t and the stash at t-1 (c0, n0,
// m0 at t = 0), and keeps the stash at t from the step before (at t =
// S-1 it reads it).  With a = f + m_{t-1} (the forward's own sum, so m_t
// = max(a, i) ties exactly where the forward's did), î = e^{i-m_t},
// f̂ = e^{a-m_t}, h = tanh z, s = σ(o), N = max(n_t, 1):
//
//     gc += gy·s/N
//     gn += -gy·s·c_t/N² · [n_t > 1]        (half at n_t = 1)
//     do  = gy·c_t/N · s(1-s)
//     g_f̂ = gc·c_{t-1} + gn·n_{t-1},  g_î = gc·h + gn
//     dz  = gc·î·(1-h²)
//     gm_t = gm - g_f̂·f̂ - g_î·î
//     df = g_a = g_f̂·f̂ + gm_t·[a > i],  di = g_î·î + gm_t·[i > a]
//                                       (gm_t half to each at a tie)
//     then gc·f̂, gn·f̂ and gm = g_a carry to step t-1.
//
// That is jax.grad of models/ssm._slstm_seq: jnp.maximum gives each side
// half of the gradient at a tie.  d(pre) is written as one quad per step
// in the gates' dtype (rounded once, to nearest even, from f32).
//
// What bounds it.  A step reads the quad (8 or 16 bytes), three stashed
// f32 and gy, and writes the quad: 40 bytes a step with bf16 gates, so
// 2.6 µs at 3.35 TB/s for the training shape (8, 256, 1024).  There the
// 8192 chains are a quarter of the card's schedulers, each running 256
// dependent steps of ~40 flops and 4 transcendentals: latency, not
// bytes, sets its time.  So a thread loads kBwdGroup steps' operands at
// once (all independent of the chain) before it runs their arithmetic.

constexpr int kBwdGroup = 8;

template <class G>
struct Back {
  using Q = typename G::Quad;
  const Q* pre;        // this chain's quad at step 0 (step stride d)
  Q* dpre;
  const float* gy;     // this chain's gy at step 0 (step stride d)
  const float* sc;     // stash plane c at step 0; n, m planes `plane` on
  long long d, plane;
  float c0, n0, m0;    // the state before step 0
};

__device__ __forceinline__ unsigned short bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store_quad(float4* p, float4 v) { *p = v; }
__device__ __forceinline__ void store_quad(uint2* p, float4 v) {
  *p = make_uint2(bf16_bits(v.x) | unsigned(bf16_bits(v.y)) << 16,
                  bf16_bits(v.z) | unsigned(bf16_bits(v.w)) << 16);
}

// K steps t0, t0-1, ..., t0-K+1 (all >= 0): the loads first, then the
// chain.  (c, n, m) is the state after step t0 on entry and after step
// t0-K on return (the stash at t0-K, or c0/n0/m0).
template <int K, class G>
__device__ __forceinline__ void back_steps(const Back<G>& k, long long t0,
                                           float& c, float& n, float& m,
                                           float& gc, float& gn,
                                           float& gm) {
  float4 q[K];
  float g[K], cp[K], np_[K], mp[K];
#pragma unroll
  for (int u = 0; u < K; ++u) {
    const long long t = t0 - u;
    q[u] = G::unpack(__ldg(k.pre + t * k.d));
    g[u] = __ldg(k.gy + t * k.d);
    if (t > 0) {
      const float* s = k.sc + (t - 1) * k.d;
      cp[u] = __ldg(s);
      np_[u] = __ldg(s + k.plane);
      mp[u] = __ldg(s + 2 * k.plane);
    } else {
      cp[u] = k.c0, np_[u] = k.n0, mp[u] = k.m0;
    }
  }
#pragma unroll
  for (int u = 0; u < K; ++u) {
    const float z = q[u].x, i = q[u].y, f = q[u].z, o = q[u].w;
    const float a = f + mp[u];
    const float ie = expf(i - m);
    const float fe = expf(a - m);
    const float h = tanhf(z);
    const float s = 1.0f / (1.0f + expf(-o));
    const float big_n = fmaxf(n, 1.0f);
    gc += g[u] * s / big_n;
    const float wn = n > 1.0f ? 1.0f : (n == 1.0f ? 0.5f : 0.0f);
    gn -= g[u] * s * c / (big_n * big_n) * wn;
    const float d_o = g[u] * c / big_n * (s * (1.0f - s));
    const float g_fe = gc * cp[u] + gn * np_[u];
    const float g_ie = gc * h + gn;
    const float d_z = gc * ie * (1.0f - h * h);
    const float gm_t = gm - g_fe * fe - g_ie * ie;
    const float wa = a > i ? 1.0f : (a == i ? 0.5f : 0.0f);
    const float g_a = g_fe * fe + gm_t * wa;
    const float d_i = g_ie * ie + gm_t * (1.0f - wa);
    store_quad(k.dpre + (t0 - u) * k.d, make_float4(d_z, d_i, g_a, d_o));
    gc *= fe;
    gn *= fe;
    gm = g_a;
    c = cp[u], n = np_[u], m = mp[u];
  }
}

struct BwdArgs {
  const void* pre;    // (B, S, d, 4) gates, contiguous
  const float* stash; // (3, B, S, d)
  const float* c0;
  const float* n0;
  const float* m0;
  const float* gy;    // (B, S, d)
  const float* gc1;   // (B, d) each, or nullptr (zero)
  const float* gn1;
  const float* gm1;
  void* dpre;         // (B, S, d, 4), the gates' dtype
  float* dstate;      // (3, B, d): dc0, dn0, dm0
  int B, S, d;
};

// grid (⌈d/128⌉, B), as the forward.
template <class G>
__global__ void __launch_bounds__(kChannels) slstm_bwd_kernel(
    const BwdArgs a) {
  using Q = typename G::Quad;
  const int ch = blockIdx.x * kChannels + threadIdx.x;
  if (ch >= a.d) return;
  const long long b = blockIdx.y;
  const long long bd = static_cast<long long>(a.B) * a.d, idx = b * a.d + ch;
  const long long row = b * a.S * a.d + ch;  // (b, t = 0, ch)
  Back<G> k;
  k.pre = static_cast<const Q*>(a.pre) + row;
  k.dpre = static_cast<Q*>(a.dpre) + row;
  k.gy = a.gy + row;
  k.sc = a.stash + row;
  k.d = a.d;
  k.plane = bd * a.S;
  k.c0 = a.c0[idx], k.n0 = a.n0[idx], k.m0 = a.m0[idx];
  float gc = a.gc1 ? a.gc1[idx] : 0.0f;
  float gn = a.gn1 ? a.gn1[idx] : 0.0f;
  float gm = a.gm1 ? a.gm1[idx] : 0.0f;
  long long t = a.S - 1;
  float c = 0.0f, n = 0.0f, m = 0.0f;
  if (t >= 0) {
    const float* s = k.sc + t * k.d;
    c = s[0], n = s[k.plane], m = s[2 * k.plane];
  }
  for (; t >= kBwdGroup - 1; t -= kBwdGroup) {
    back_steps<kBwdGroup>(k, t, c, n, m, gc, gn, gm);
  }
  for (; t >= 0; --t) back_steps<1>(k, t, c, n, m, gc, gn, gm);
  a.dstate[idx] = gc;
  a.dstate[bd + idx] = gn;
  a.dstate[2 * bd + idx] = gm;
}

template <class G>
int launch_bwd(const BwdArgs& a, void* stream) {
  const int gx = (a.d + kChannels - 1) / kChannels;
  slstm_bwd_kernel<G><<<dim3(gx, a.B), kChannels, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The mixer's layout: the gates are the views (.., 0..3) of one (B, S, d,
// 4) tensor at `base` (f32, or bf16 with bf16 != 0), b and t strides sb,
// st in elements (multiples of 4; base 16-byte (f32) or 8-byte (bf16)
// aligned).  c0/n0/m0: contiguous (B, d) f32; y: contiguous (B, S, d) f32;
// state: contiguous (3, B, d) f32; stash: contiguous (3, B, S, d) f32, or
// nullptr for none (serving).  Launches on `stream`; returns
// cudaGetLastError() after the launch.
extern "C" int repro_slstm_scan_quad(int bf16, const void* base,
                                     long long sb, long long st,
                                     const float* c0, const float* n0,
                                     const float* m0, float* y, float* state,
                                     float* stash, int B, int S, int d,
                                     void* stream) {
  Args a{};
  a.g.p[0] = base;
  a.g.s[0][0] = sb;
  a.g.s[0][1] = st;
  a.g.s[0][2] = 4;
  a.c0 = c0, a.n0 = n0, a.m0 = m0, a.y = y, a.state = state;
  a.stash = stash;
  a.B = B, a.S = S, a.d = d;
  if (stash) {
    return bf16 ? launch<BF16, true, true>(a, stream)
                : launch<F32, true, true>(a, stream);
  }
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

// The backward of the quad path: pre contiguous (B, S, d, 4) (f32, or
// bf16 with bf16 != 0), stash (3, B, S, d), c0/n0/m0 (B, d), gy (B, S,
// d), gc1/gn1/gm1 (B, d) or nullptr (zero), all f32 and contiguous;
// writes dpre (B, S, d, 4) in pre's dtype and dstate (3, B, d) f32.
// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int repro_slstm_scan_bwd(int bf16, const void* pre,
                                    const float* stash, const float* c0,
                                    const float* n0, const float* m0,
                                    const float* gy, const float* gc1,
                                    const float* gn1, const float* gm1,
                                    void* dpre, float* dstate, int B, int S,
                                    int d, void* stream) {
  const BwdArgs a{pre, stash, c0, n0, m0, gy, gc1, gn1, gm1, dpre, dstate,
                  B, S, d};
  return bf16 ? launch_bwd<BF16>(a, stream) : launch_bwd<F32>(a, stream);
}
