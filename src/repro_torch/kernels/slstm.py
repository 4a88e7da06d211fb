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

``slstm_scan.launches`` counts wrapper calls that launched the kernel,
incremented only there (``kernels.counts`` reads and resets it).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from . import native

Result = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

#: gate dtypes the kernel reads; the state and y are always f32
GATE_DTYPES = (torch.float32, torch.bfloat16)


def _slstm_scan_plain(z, ig, fg, og, c0, n0, m0) -> Result:
    """The stabilised recurrence one step at a time (gates (B, S, d),
    state (B, d), f32), in the order of operations of ``_slstm_seq``."""
    c, n, m = c0, n0, m0
    ys = []
    for t in range(z.shape[1]):
        zt, it, ft, ot = z[:, t], ig[:, t], fg[:, t], og[:, t]
        m_new = torch.maximum(ft + m, it)
        i_ = torch.exp(it - m_new)
        f_ = torch.exp(ft + m - m_new)
        c = f_ * c + i_ * torch.tanh(zt)
        n = f_ * n + i_
        ys.append(torch.sigmoid(ot) * c / torch.clamp(n, min=1.0))
        m = m_new
    y = torch.stack(ys, dim=1) if ys else torch.empty_like(z)
    return y, c, n, m


def _quad_base(gates: Sequence[torch.Tensor]) -> Optional[int]:
    """The address of the (B, S, d, 4) tensor whose views (.., 0..3) the
    four gates are, with b and t strides multiples of 4 and the base
    aligned to a quad (the kernel's quad loads); else None."""
    z = gates[0]
    st = z.stride()
    if st[2] != 4 or st[0] % 4 or st[1] % 4:
        return None
    p, e = z.data_ptr(), z.element_size()
    if p % (4 * e):
        return None
    for k in (1, 2, 3):
        if gates[k].stride() != st or gates[k].data_ptr() != p + k * e:
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


def _launch(funcs, gates, state, b: int, s: int, d: int) -> Result:
    """Allocate y and the state and launch through ``funcs`` (the bound C
    entry points) on the current stream; raises on a launch error.  Not
    counted: ``slstm_scan`` is the wrapper (``tools/kernel_ab.py`` calls
    this with the entry points of its source variants)."""
    z = gates[0]
    dev = z.device
    y = torch.empty((b, s, d), dtype=torch.float32, device=dev)
    out = torch.empty((3, b, d), dtype=torch.float32, device=dev)
    bf16 = int(z.dtype == torch.bfloat16)
    tail = (state[0].data_ptr(), state[1].data_ptr(), state[2].data_ptr(),
            y.data_ptr(), out.data_ptr(), b, s, d)
    base = _quad_base(gates)
    if base is not None:
        st = z.stride()
        fn, args = funcs["repro_slstm_scan_quad"], (bf16, base, st[0],
                                                    st[1], *tail)
    else:
        fn, args = funcs["repro_slstm_scan"], (bf16,)
        for g in gates:
            args += (g.data_ptr(), *g.stride())
        args += tail
    if dev.index == torch.cuda.current_device():
        rc = fn(*args, _raw_stream(dev.index))
    else:                       # entering a device context costs host time
        with torch.cuda.device(dev):
            rc = fn(*args, _raw_stream(dev.index))
    native.check(rc, f"slstm_scan[{b}x{s}x{d}]")
    return (y, *out.unbind(0))


def slstm_scan(z: torch.Tensor, ig: torch.Tensor, fg: torch.Tensor,
               og: torch.Tensor, c0: torch.Tensor, n0: torch.Tensor,
               m0: torch.Tensor) -> Result:
    """z/ig/fg/og: (B, S, d) f32 or bf16 (one dtype), any strides;
    c0/n0/m0: (B, d) f32, contiguous.  Returns (y (B, S, d), c1, n1, m1),
    f32 and contiguous — the TPU kernel's contract (c1, n1, m1 are the
    rows of one (3, B, d) tensor)."""
    gates, state = (z, ig, fg, og), (c0, n0, m0)
    b, s, d = _check(gates, state)
    if z.device.type == "cpu":
        return _slstm_scan_plain(*_upcast(gates), *state)
    if z.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {z.device}")
    if b == 0 or d == 0:
        raise ValueError(f"slstm_scan needs B, d > 0, got {(b, s, d)}")
    if not _FUNCS:
        _FUNCS.update(native.load())
    out = _launch(_FUNCS, gates, state, b, s, d)
    native.count_launch(slstm_scan)
    return out


slstm_scan.launches = 0


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
