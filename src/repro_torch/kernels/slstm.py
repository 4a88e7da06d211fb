"""The fused sLSTM recurrence's wrapper and its plain version.

Port of :mod:`repro.kernels.slstm`.  ``slstm_scan`` launches the
hand-written CUDA kernel ``csrc/slstm_scan.cu`` on CUDA tensors and runs
its plain PyTorch version, a loop over t with exactly the algebra of the
reference's ``models/ssm._slstm_seq``, on CPU tensors.  A CUDA tensor
never falls back: the kernel launches or the wrapper raises.

``slstm_scan.launches`` counts kernel launches, incremented only where
the kernel is launched (``kernels.counts`` reads and resets it).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from . import native


def _slstm_scan_plain(z, ig, fg, og, c0, n0, m0
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
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


def slstm_scan(z: torch.Tensor, ig: torch.Tensor, fg: torch.Tensor,
               og: torch.Tensor, c0: torch.Tensor, n0: torch.Tensor,
               m0: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """z/ig/fg/og: (B, S, d) f32, any strides; c0/n0/m0: (B, d) f32,
    contiguous.  Returns (y (B, S, d), c1, n1, m1), f32 and contiguous —
    the TPU kernel's contract."""
    gates, state = (z, ig, fg, og), (c0, n0, m0)
    if z.dim() != 3:
        raise ValueError(f"gates must be (B, S, d), got {tuple(z.shape)}")
    b, s, d = z.shape
    for name, g in zip(("z", "ig", "fg", "og"), gates):
        if tuple(g.shape) != (b, s, d):
            raise ValueError(f"{name} {tuple(g.shape)} != {(b, s, d)}")
    for name, x in zip(("c0", "n0", "m0"), state):
        if tuple(x.shape) != (b, d):
            raise ValueError(f"{name} {tuple(x.shape)} != {(b, d)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for x in gates + state:
        if x.dtype != torch.float32:
            raise TypeError(f"slstm_scan takes float32, got {x.dtype}")
        if x.device != z.device:
            raise ValueError("slstm_scan's operands must be on one device")
    if z.device.type == "cpu":
        return _slstm_scan_plain(z, ig, fg, og, c0, n0, m0)
    if z.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {z.device}")
    if b == 0 or d == 0:
        raise ValueError(f"slstm_scan needs B, d > 0, got {(b, s, d)}")

    fn = native.load()["repro_slstm_scan"]
    y = torch.empty((b, s, d), dtype=torch.float32, device=z.device)
    c1, n1, m1 = (torch.empty((b, d), dtype=torch.float32, device=z.device)
                  for _ in range(3))
    args = []
    for g in gates:
        args += [g.data_ptr(), *g.stride()]
    with torch.cuda.device(z.device):
        rc = fn(*args, c0.data_ptr(), n0.data_ptr(), m0.data_ptr(),
                y.data_ptr(), c1.data_ptr(), n1.data_ptr(), m1.data_ptr(),
                b, s, d, torch.cuda.current_stream(z.device).cuda_stream)
    native.check(rc, f"slstm_scan[{b}x{s}x{d}]")
    native.count_launch(slstm_scan)
    return y, c1, n1, m1


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
