// slstm_scan.cu — the fused, stabilised sLSTM recurrence for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/slstm.py::slstm_scan
// (_slstm_kernel).  For every (b, channel) it runs, over t = 0..S-1,
//
//     m_t = max(f_t + m_{t-1}, i_t)
//     c_t = e^{f_t+m_{t-1}-m_t}·c_{t-1} + e^{i_t-m_t}·tanh(z_t)
//     n_t = e^{f_t+m_{t-1}-m_t}·n_{t-1} + e^{i_t-m_t}
//     y_t = σ(o_t)·c_t / max(n_t, 1)
//
// and writes y (B, S, d) and the final state c1, n1, m1 (B, d), all f32.
// The algebra, and its order of operations, is that of
// models/ssm._slstm_seq.
//
// What bounds it on an H100.  Every gate is read once and every y
// written once: (5·B·S·d + 6·B·d)·4 bytes, so at the reference's traffic
// shape (16, 4096, 1024) the memory bound is 0.40 ms at 3.35 TB/s.  The
// S steps of one channel depend on each other, so S also sets a latency
// floor: each step waits for its own gate loads and then for a chain of
// about five dependent operations (add, max, sub, exp, fma).
//
// Design.  The TPU kernel keeps a (1, S, 128) gate tile in VMEM and
// loops over S inside one grid step.  Here there is no sequence tile:
// one thread owns one (b, channel) pair and keeps c, n and m in
// registers across the time loop; a block holds 128 neighbouring
// channels of one batch row (grid (B, ⌈d/128⌉), ragged d masked), so the
// loads of step t are coalesced across the block's channels.  The loads
// of a step depend only on t, never on the state, so the unrolled loop
// can issue the loads of several steps before their arithmetic.  Each
// gate tensor comes with its own (b, t, channel) strides: the serving
// mixer hands in the four strided views of its (B, S, d, 4)
// pre-activation (channel stride 4) without copying them apart; their
// loads share cache lines through L1.  Precise expf / tanhf and IEEE
// division (no --use_fast_math): the reference holds y to 2e-5.
//
// Plain C interface, bound with ctypes (repro_torch/kernels/native.py).

#include <cuda_runtime.h>

namespace {

constexpr int kChannels = 128;   // threads (channels) per block

__global__ void __launch_bounds__(kChannels)
slstm_scan_kernel(const float* __restrict__ z, long long zb, long long zt,
                  long long zc,
                  const float* __restrict__ ig, long long ib, long long it,
                  long long ic,
                  const float* __restrict__ fg, long long fb, long long ft,
                  long long fc,
                  const float* __restrict__ og, long long ob, long long ot,
                  long long oc,
                  const float* __restrict__ c0,
                  const float* __restrict__ n0,
                  const float* __restrict__ m0,
                  float* __restrict__ y, float* __restrict__ c1,
                  float* __restrict__ n1, float* __restrict__ m1,
                  int S, int d) {
  const long long b = blockIdx.x;
  const int ch = blockIdx.y * kChannels + threadIdx.x;
  if (ch >= d) return;
  const long long s_idx = b * d + ch;
  float c = c0[s_idx];
  float n = n0[s_idx];
  float m = m0[s_idx];
  const float* zp = z + b * zb + ch * zc;
  const float* ip = ig + b * ib + ch * ic;
  const float* fp = fg + b * fb + ch * fc;
  const float* op = og + b * ob + ch * oc;
  float* yp = y + b * S * (long long)d + ch;
#pragma unroll 4
  for (int t = 0; t < S; ++t) {
    const float z_t = __ldg(zp + t * zt);
    const float i_t = __ldg(ip + t * it);
    const float f_t = __ldg(fp + t * ft);
    const float o_t = __ldg(op + t * ot);
    const float m_new = fmaxf(f_t + m, i_t);
    const float e_f = expf(f_t + m - m_new);
    const float e_i = expf(i_t - m_new);
    c = e_f * c + e_i * tanhf(z_t);
    n = e_f * n + e_i;
    const float sig = 1.0f / (1.0f + expf(-o_t));
    yp[t * (long long)d] = sig * c / fmaxf(n, 1.0f);
    m = m_new;
  }
  c1[s_idx] = c;
  n1[s_idx] = n;
  m1[s_idx] = m;
}

}  // namespace

// z/ig/fg/og: (B, S, d) f32 with element strides (b, t, channel) each;
// c0/n0/m0 and c1/n1/m1: contiguous (B, d) f32; y: contiguous (B, S, d)
// f32.  Launches on `stream`; returns cudaGetLastError() of the launch.
extern "C" int repro_slstm_scan(
    const float* z, long long zb, long long zt, long long zc,
    const float* ig, long long ib, long long it, long long ic,
    const float* fg, long long fb, long long ft, long long fc,
    const float* og, long long ob, long long ot, long long oc,
    const float* c0, const float* n0, const float* m0,
    float* y, float* c1, float* n1, float* m1,
    int B, int S, int d, void* stream) {
  const dim3 grid(B, (d + kChannels - 1) / kChannels);
  slstm_scan_kernel<<<grid, kChannels, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      z, zb, zt, zc, ig, ib, it, ic, fg, fb, ft, fc, og, ob, ot, oc,
      c0, n0, m0, y, c1, n1, m1, S, d);
  return static_cast<int>(cudaGetLastError());
}
