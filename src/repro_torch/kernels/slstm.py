"""The fused sLSTM recurrence's wrapper and its plain versions.

Port of :mod:`repro.kernels.slstm`.  ``slstm_scan`` launches the
hand-written CUDA kernel ``csrc/slstm_scan.cu`` on CUDA tensors and runs
its plain PyTorch version, a loop over t with exactly the algebra of the
reference's ``models/ssm._slstm_seq``, on CPU tensors.  A CUDA tensor
never falls back: the kernel launches or the wrapper raises.

The gates may be f32 or bf16 (the reference's wrapper takes any dtype and
casts to f32; here the kernel upcasts in registers, and the CPU path
upcasts before its plain version).  The serving mixer hands in the four
d-major views of its bf16 (B, S, d, 4) pre-activation, which the kernel
reads as one quad per step.

Training goes through :class:`SlstmScan`, an autograd operator on the
whole (B, S, d, 4) pre-activation: its forward is the same kernel with
``stash=True`` (it also writes c_t, n_t, m_t for every t, (3, B, S, d)
f32), its backward the hand-written ``slstm_scan_bwd`` (CUDA C++ in the
same source), which walks each chain from t = S-1 down to 0.  The
reference's Pallas kernel has no VJP; its training differentiates the
jnp mixer, so ``slstm_scan_bwd`` replaces no TPU kernel and computes
``jax.grad`` of the reference's recurrence, ties included:
``jnp.maximum`` gives each side half of the gradient at a tie, and so do
the plain versions here (``torch.maximum``, never ``torch.clamp``).

``slstm_scan.launches`` and ``slstm_scan_bwd.launches`` count wrapper
calls that launched the kernel, incremented only there
(``kernels.counts`` reads and resets them).  Each launch also adds its
flops and bytes (:func:`scan_cost`) to the active op counters
(``analysis.op_cost``).  On the meta device (the dry run) both wrappers
are shape functions: outputs shaped by the kernel's contract and the
kernel's cost recorded, never the plain version's loop over S.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from ..analysis import op_cost
from . import native

Result = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

#: gate dtypes the kernel reads; the state and y are always f32
GATE_DTYPES = (torch.float32, torch.bfloat16)


def _slstm_scan_plain(z, ig, fg, og, c0, n0, m0, stash: bool = False):
    """The stabilised recurrence one step at a time (gates (B, S, d),
    state (B, d), f32), in the order of operations of ``_slstm_seq``;
    ``max(n, 1)`` is ``torch.maximum``, whose gradient at n = 1 is
    ``jnp.maximum``'s (half).  With ``stash`` a fifth result: c_t, n_t,
    m_t of every step, (3, B, S, d)."""
    c, n, m = c0, n0, m0
    one = n0.new_ones(())
    ys, states = [], []
    for t in range(z.shape[1]):
        zt, it, ft, ot = z[:, t], ig[:, t], fg[:, t], og[:, t]
        m_new = torch.maximum(ft + m, it)
        i_ = torch.exp(it - m_new)
        f_ = torch.exp(ft + m - m_new)
        c = f_ * c + i_ * torch.tanh(zt)
        n = f_ * n + i_
        ys.append(torch.sigmoid(ot) * c / torch.maximum(n, one))
        m = m_new
        if stash:
            states.append(torch.stack((c, n, m)))
    y = torch.stack(ys, dim=1) if ys else torch.empty_like(z)
    if not stash:
        return y, c, n, m
    b, s, d = z.shape
    st = torch.stack(states, dim=2) if states else z.new_empty((3, b, 0, d))
    return y, c, n, m, st


def _slstm_scan_bwd_plain(pre, stash, c0, n0, m0, gy, gc1=None, gn1=None,
                          gm1=None) -> Result:
    """``slstm_scan_bwd``'s plain version: the gradient of the scan at
    the pre-activation quads ``pre`` (B, S, d, 4) and the state (c0, n0,
    m0), from gy (B, S, d) and the final state's gradients (None: zero),
    walking t from S-1 down to 0 with the algebra of the kernel (the
    comment above ``slstm_bwd_kernel`` in ``csrc/slstm_scan.cu``): f32
    throughout, d(pre) rounded once to pre's dtype.  Returns (d(pre),
    dc0, dn0, dm0)."""
    q = pre.float()
    b, s, d, _ = q.shape
    zero = torch.zeros_like(c0)
    gc = zero if gc1 is None else gc1.float()
    gn = zero if gn1 is None else gn1.float()
    gm = zero if gm1 is None else gm1.float()
    dq = torch.empty_like(q)
    one = q.new_ones(())
    for t in range(s - 1, -1, -1):
        z, i, f, o = q[:, t].unbind(-1)
        c, n, m = stash[:, :, t]
        if t:
            cp, np_, mp = stash[:, :, t - 1]
        else:
            cp, np_, mp = c0, n0, m0
        g = gy[:, t]
        a = f + mp
        ie = torch.exp(i - m)
        fe = torch.exp(a - m)
        h = torch.tanh(z)
        sg = torch.sigmoid(o)
        big_n = torch.maximum(n, one)
        gc = gc + g * sg / big_n
        wn = torch.where(n > 1, 1.0, torch.where(n == 1, 0.5, 0.0))
        gn = gn - g * sg * c / (big_n * big_n) * wn
        do = g * c / big_n * (sg * (1 - sg))
        g_fe = gc * cp + gn * np_
        g_ie = gc * h + gn
        dz = gc * ie * (1 - h * h)
        gm_t = gm - g_fe * fe - g_ie * ie
        wa = torch.where(a > i, 1.0, torch.where(a == i, 0.5, 0.0))
        ga = g_fe * fe + gm_t * wa
        di = g_ie * ie + gm_t * (1 - wa)
        dq[:, t] = torch.stack((dz, di, ga, do), dim=-1)
        gc, gn, gm = gc * fe, gn * fe, ga
    return dq.to(pre.dtype), gc, gn, gm


def _quad_base(gates: Sequence[torch.Tensor]) -> Optional[int]:
    """The address of the (B, S, d, 4) tensor whose views (.., 0..3) the
    four gates are, with b and t strides multiples of 4 and the base
    aligned to a quad (the kernel's quad loads); else None."""
    z = gates[0]
    st = z.stride()
    if st[2] != 4 or st[0] % 4 or st[1] % 4:
        return None
    e = z.element_size()

    def ptr(g):                 # a meta tensor's address is its offset
        return g.storage_offset() * e if g.is_meta else g.data_ptr()
    p = ptr(z)
    if p % (4 * e):
        return None
    for k in (1, 2, 3):
        if gates[k].stride() != st or ptr(gates[k]) != p + k * e:
            return None
    return p


def _upcast(gates: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
    """f32 gates for the plain version: the views of the f32 copy of
    their (B, S, d, 4) tensor where they are its quad views (as the
    mixer's f32 pre-activation was), else each gate's f32 copy."""
    z = gates[0]
    if z.dtype == torch.float32:
        return gates
    if _quad_base(gates) is not None:
        b, s, d = z.shape
        quads = z.as_strided((b, s, d, 4), (*z.stride()[:2], 4, 1))
        return quads.float().unbind(-1)
    return [g.float() for g in gates]


def _check(gates, state) -> Tuple[int, int, int]:
    z = gates[0]
    if z.dim() != 3:
        raise ValueError(f"gates must be (B, S, d), got {tuple(z.shape)}")
    shape, dtype, dev = z.shape, z.dtype, z.device
    b, s, d = shape
    if dtype not in GATE_DTYPES:
        raise TypeError(f"slstm_scan takes float32 or bfloat16 gates, got "
                        f"{dtype}")
    for name, g in zip(("z", "ig", "fg", "og"), gates):
        if g.shape != shape:
            raise ValueError(f"{name} {tuple(g.shape)} != {(b, s, d)}")
        if g.dtype != dtype:
            raise TypeError(f"{name} is {g.dtype}, z is {dtype}")
        if g.device != dev:
            raise ValueError("slstm_scan's operands must be on one device")
    for name, x in zip(("c0", "n0", "m0"), state):
        if x.shape != (b, d):
            raise ValueError(f"{name} {tuple(x.shape)} != {(b, d)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.dtype != torch.float32:
            raise TypeError(f"the state is float32, {name} is {x.dtype}")
        if x.device != dev:
            raise ValueError("slstm_scan's operands must be on one device")
    return b, s, d


_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
    lambda index: torch.cuda.current_stream(index).cuda_stream)
_FUNCS = {}


def _launch(funcs, gates, state, b: int, s: int, d: int,
            stash: bool = False):
    """Allocate y and the state (and with ``stash`` the (3, B, S, d)
    states of every step, a fifth result) and launch through ``funcs``
    (the bound C entry points) on the current stream; raises on a launch
    error.  Not counted: ``slstm_scan`` is the wrapper
    (``tools/kernel_ab.py`` calls this with the entry points of its
    source variants)."""
    z = gates[0]
    dev = z.device
    y = torch.empty((b, s, d), dtype=torch.float32, device=dev)
    out = torch.empty((3, b, d), dtype=torch.float32, device=dev)
    st = torch.empty((3, b, s, d), dtype=torch.float32, device=dev) \
        if stash else None
    bf16 = int(z.dtype == torch.bfloat16)
    tail = (state[0].data_ptr(), state[1].data_ptr(), state[2].data_ptr(),
            y.data_ptr(), out.data_ptr())
    dims = (b, s, d)
    base = _quad_base(gates)
    assert base is not None or not stash, "the stash needs the quad views"
    if base is not None:
        zs = z.stride()
        fn, args = funcs["repro_slstm_scan_quad"], (
            bf16, base, zs[0], zs[1], *tail,
            0 if st is None else st.data_ptr(), *dims)
    else:
        fn, args = funcs["repro_slstm_scan"], (bf16,)
        for g in gates:
            args += (g.data_ptr(), *g.stride())
        args += tail + dims
    _call(fn, args, dev, f"slstm_scan[{b}x{s}x{d}]")
    return (y, *out.unbind(0)) + ((st,) if stash else ())


def _call(fn, args, dev: torch.device, what: str) -> None:
    """Launch a C entry point on ``dev``'s current stream."""
    if dev.index == torch.cuda.current_device():
        rc = fn(*args, _raw_stream(dev.index))
    else:                       # entering a device context costs host time
        with torch.cuda.device(dev):
            rc = fn(*args, _raw_stream(dev.index))
    native.check(rc, what)


#: f32 operations per (b, t, channel) step of the recurrence and of its
#: backward (adds, subtractions, maxima, compares, multiplies and
#: divisions, an FMA counting 2, each transcendental once: the counts
#: ``chip_smoke.py`` bounds the kernels by); of each step's, 4 are
#: transcendentals (exp × 2, tanh, sigmoid)
SLSTM_OPS_PER_STEP = 20
SLSTM_BWD_OPS_PER_STEP = 45
SLSTM_TRANSCENDENTALS = 4


def scan_cost(b: int, s: int, d: int, gate_bytes: int, stash: bool = False,
              backward: bool = False) -> Tuple[float, float]:
    """(f32 flops, HBM bytes) of one launch: the forward reads the 4
    gates and the (B, d) state and writes y and the final state (and
    with ``stash`` the 3 f32 states of every step); the backward reads
    the 4 gates, the stash, y's gradient and the state, and writes the 4
    gates' gradients and the state's."""
    steps = b * s * d
    state = 6 * b * d * 4
    if backward:
        return (float(SLSTM_BWD_OPS_PER_STEP * steps),
                float(steps * (8 * gate_bytes + 4 * 4) + state))
    return (float(SLSTM_OPS_PER_STEP * steps),
            float(steps * (4 * gate_bytes + 4 + (12 if stash else 0))
                  + state))


def _record(name: str, b: int, s: int, d: int, gate_bytes: int,
            stash: bool = False, backward: bool = False) -> None:
    """Add one launch's cost to the active op counters
    (``analysis.op_cost``)."""
    flops, nbytes = scan_cost(b, s, d, gate_bytes, stash, backward)
    op_cost.add_kernel_cost(name, {"float32": flops}, nbytes,
                            transcendentals=SLSTM_TRANSCENDENTALS * b * s * d)


def _meta_scan(z: torch.Tensor, b: int, s: int, d: int, stash: bool):
    """``slstm_scan`` on the meta device: outputs shaped by the kernel's
    contract and the kernel's cost recorded.  A shape function, not a
    fallback: a meta tensor carries no data, and the plain version (a
    Python loop over S) never runs here."""
    f32 = torch.float32
    out = z.new_empty((3, b, d), dtype=f32)
    res = (z.new_empty((b, s, d), dtype=f32), *out.unbind(0))
    _record("slstm_scan", b, s, d, z.element_size(), stash)
    return res + ((z.new_empty((3, b, s, d), dtype=f32),) if stash else ())


def _kernel_device(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one
    (run the plain version); raises for any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    if not _FUNCS:
        _FUNCS.update(native.load())
    return True


def slstm_scan(z: torch.Tensor, ig: torch.Tensor, fg: torch.Tensor,
               og: torch.Tensor, c0: torch.Tensor, n0: torch.Tensor,
               m0: torch.Tensor, stash: bool = False):
    """z/ig/fg/og: (B, S, d) f32 or bf16 (one dtype), any strides;
    c0/n0/m0: (B, d) f32, contiguous.  Returns (y (B, S, d), c1, n1, m1),
    f32 and contiguous — the TPU kernel's contract (c1, n1, m1 are the
    rows of one (3, B, d) tensor).  With ``stash`` (the gates the quad
    views of one (B, S, d, 4) tensor) also the (3, B, S, d) f32 c_t,
    n_t, m_t of every step, written by the same launch, y bit for bit
    the launch without it."""
    gates, state = (z, ig, fg, og), (c0, n0, m0)
    b, s, d = _check(gates, state)
    if stash and _quad_base(gates) is None:
        raise ValueError("slstm_scan(stash=True) takes the quad views of "
                         "one (B, S, d, 4) tensor")
    if z.is_meta:
        return _meta_scan(z, b, s, d, stash)
    if not _kernel_device(z):
        return _slstm_scan_plain(*_upcast(gates), *state, stash=stash)
    if b == 0 or d == 0:
        raise ValueError(f"slstm_scan needs B, d > 0, got {(b, s, d)}")
    out = _launch(_FUNCS, gates, state, b, s, d, stash=stash)
    native.count_launch(slstm_scan)
    _record("slstm_scan", b, s, d, z.element_size(), stash)
    return out


slstm_scan.launches = 0


def slstm_scan_bwd(pre: torch.Tensor, stash: torch.Tensor,
                   c0: torch.Tensor, n0: torch.Tensor, m0: torch.Tensor,
                   gy: torch.Tensor, gc1: Optional[torch.Tensor] = None,
                   gn1: Optional[torch.Tensor] = None,
                   gm1: Optional[torch.Tensor] = None) -> Result:
    """The scan's gradient: ``pre`` the (B, S, d, 4) f32 or bf16 quads,
    contiguous; ``stash`` the (3, B, S, d) f32 states that
    ``slstm_scan(stash=True)`` wrote; c0/n0/m0 (B, d) f32; gy (B, S, d)
    f32, the gradient of y; gc1/gn1/gm1 (B, d) f32 those of the final
    state, or None (zero).  Returns (d(pre) (B, S, d, 4) in pre's dtype,
    dc0, dn0, dm0 (B, d) f32)."""
    if pre.dim() != 4 or pre.shape[-1] != 4 or not pre.is_contiguous():
        raise ValueError(f"pre must be a contiguous (B, S, d, 4) tensor, "
                         f"got {tuple(pre.shape)}")
    b, s, d, _ = pre.shape
    gates = pre.unbind(-1)
    _check(gates, (c0, n0, m0))
    carried = [g for g in (gc1, gn1, gm1) if g is not None]
    for name, x, shape in (("stash", stash, (3, b, s, d)),
                           ("gy", gy, (b, s, d)),
                           *(("final state grad", g, (b, d))
                             for g in carried)):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} {tuple(x.shape)} != {shape}")
        if x.dtype != torch.float32 or x.device != pre.device:
            raise TypeError(f"{name} must be float32 on {pre.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if pre.is_meta:             # a shape function, as ``_meta_scan``
        _record("slstm_scan_bwd", b, s, d, pre.element_size(),
                backward=True)
        dstate = c0.new_empty((3, b, d))
        return (torch.empty_like(pre), *dstate.unbind(0))
    if not _kernel_device(pre):
        return _slstm_scan_bwd_plain(pre, stash, c0, n0, m0, gy, gc1, gn1,
                                     gm1)
    if b == 0 or d == 0:
        raise ValueError(f"slstm_scan_bwd needs B, d > 0, got {(b, s, d)}")
    if pre.data_ptr() % (4 * pre.element_size()):
        raise ValueError("pre must be aligned to a quad")
    dpre = torch.empty_like(pre)
    dstate = torch.empty((3, b, d), dtype=torch.float32, device=pre.device)

    def ptr(x):
        return 0 if x is None else x.data_ptr()
    args = (int(pre.dtype == torch.bfloat16), pre.data_ptr(),
            stash.data_ptr(), c0.data_ptr(), n0.data_ptr(), m0.data_ptr(),
            gy.data_ptr(), ptr(gc1), ptr(gn1), ptr(gm1), dpre.data_ptr(),
            dstate.data_ptr(), b, s, d)
    _call(_FUNCS["repro_slstm_scan_bwd"], args, pre.device,
          f"slstm_scan_bwd[{b}x{s}x{d}]")
    native.count_launch(slstm_scan_bwd)
    _record("slstm_scan_bwd", b, s, d, pre.element_size(), backward=True)
    return (dpre, *dstate.unbind(0))


slstm_scan_bwd.launches = 0


class SlstmScan(torch.autograd.Function):
    """The scan under autograd: ``SlstmScan.apply(pre, c0, n0, m0)`` with
    ``pre`` the whole (B, S, d, 4) pre-activation (so its gradient is one
    tensor, not four views' scattered back) returns (y, c1, n1, m1).  The
    forward is ``slstm_scan(stash=True)``, the backward
    ``slstm_scan_bwd``: each the kernel on CUDA tensors and its plain
    version on CPU ones."""

    @staticmethod
    def forward(ctx, pre, c0, n0, m0):
        pre = pre.contiguous()
        y, c1, n1, m1, st = slstm_scan(*pre.unbind(-1), c0, n0, m0,
                                       stash=True)
        ctx.save_for_backward(pre, st, c0, n0, m0)
        ctx.set_materialize_grads(False)
        return y, c1, n1, m1

    @staticmethod
    def backward(ctx, gy, gc1, gn1, gm1):
        pre, st, c0, n0, m0 = ctx.saved_tensors
        if gy is None:
            gy = torch.zeros(pre.shape[:3], dtype=torch.float32,
                             device=pre.device)
        grads = slstm_scan_bwd(
            pre, st, c0, n0, m0, gy.float().contiguous(),
            *(None if g is None else g.float().contiguous()
              for g in (gc1, gn1, gm1)))
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def hbm_traffic_bytes(b: int, s: int, d: int) -> dict:
    """Analytic HBM traffic: fused kernel vs associative-scan lowering
    (a copy of the reference's, for reports)."""
    elem = 4
    fused = 5 * b * s * d * elem + 6 * b * d * elem
    # assoc form: 3 scans (m, c‖n fused, shifted-m) × ~2·log2(s) level
    # passes × read+write
    levels = max(int(math.ceil(math.log2(max(s, 2)))), 1)
    assoc = 3 * 2 * levels * b * s * d * elem
    return {"fused_bytes": fused, "assoc_bytes": assoc,
            "saving": assoc / fused}
