"""Packed Gram statistics and Newton–Schulz whitening on the symmetric
BLAS (port of the single-device half of :mod:`repro.optim.gram`).

``packed_gram`` is one ``blas.syrk(fill="packed")`` (the rank-update
kernel on the GPU), ``decorrelation_penalty`` a differentiable loss on
that packed triangle (its backward is the SYMM of the packed
cotangent), ``GramMonitor`` keeps a packed EMA per name (f32
arithmetic, optionally bf16 storage) with its summaries, and
``whitening_from_packed`` / ``whitening_factor`` compute
(sym(G) + eps·I)^{-1/2} by the coupled Newton–Schulz iteration on
routed ``blas.symm`` / ``blas.syrk`` calls, with the dense eigh oracle
beside it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import blas
from ..blas.routing import plan_route
from ..core.dispatch import choose_algorithm
from ..core.packing import PackedTriangle, TriTiles, tril_size, unpack_tril


def packed_gram(x: torch.Tensor, chunk: Optional[int] = None,
                out_dtype=None, kernel: bool = False) -> torch.Tensor:
    """Packed lower triangle of X·Xᵀ / n for X (d, n), f32 accumulation.

    ``out_dtype`` narrows only the stored triangle (the SYRK epilogue
    casts); ``chunk`` streams column chunks through the beta=1
    accumulate epilogue, casting on the last chunk only.  ``kernel``
    forces the kernel route (see :func:`repro_torch.blas.syrk`)."""
    _, n = x.shape
    if chunk is None or chunk >= n:
        packed = blas.syrk(x, fill="packed", out_dtype=out_dtype,
                           kernel=kernel)
    else:
        packed = None
        for lo in range(0, n, chunk):
            last = lo + chunk >= n
            packed = blas.syrk(x[:, lo:lo + chunk], fill="packed", c=packed,
                               out_dtype=out_dtype if last else None,
                               kernel=kernel)
    return packed * torch.tensor(1.0 / n, dtype=packed.dtype,
                                 device=packed.device)


def decorrelation_penalty(x: torch.Tensor,
                          kernel: bool = False) -> torch.Tensor:
    """½·Σ_{i>j} G_ij² for G = X·Xᵀ/n, X (d, n): a feature-decorrelation
    loss on the packed triangle.  The forward is one
    ``blas.syrk(fill="packed")``; the backward, through
    :mod:`repro_torch.blas.grad`, the SYMM of the packed cotangent.
    Scalar f32."""
    d, n = x.shape[-2], x.shape[-1]
    packed = blas.syrk(x, fill="packed", kernel=kernel) / n
    mask = np.ones(tril_size(d), np.float32)
    i = np.arange(d)
    mask[i * (i + 3) // 2] = 0.0          # drop the diagonal slots
    off = packed * torch.as_tensor(mask, device=packed.device)
    return 0.5 * torch.sum(off * off)


@dataclass
class GramMonitor:
    """EMA'd packed Grams and scalar summaries per tracked name.

    ``chunk``: stream the Gram update over token chunks of that size
    through the SYRK's beta-accumulate epilogue (:func:`packed_gram`).
    ``out_dtype`` is the storage dtype of the packed state (default
    f32); the EMA arithmetic runs in f32 and only the stored triangle is
    narrowed."""
    decay: float = 0.99
    chunk: Optional[int] = None
    out_dtype: Optional[torch.dtype] = None
    _state: Dict[str, torch.Tensor] = field(default_factory=dict)
    _dims: Dict[str, int] = field(default_factory=dict)

    def update(self, name: str, x: torch.Tensor) -> None:
        """x: (d, n) features; the fresh Gram enters the EMA in f32."""
        g = packed_gram(x, chunk=self.chunk)
        store = self.out_dtype or torch.float32
        if name not in self._state:
            self._state[name] = g.to(store)
            self._dims[name] = x.shape[0]
        else:
            ema = self.decay * self._state[name].float() \
                + (1.0 - self.decay) * g
            self._state[name] = ema.to(store)

    def state_dict(self) -> Dict[str, PackedTriangle]:
        """The EMA'd Grams as typed packed leaves (each carries its n)."""
        return {name: PackedTriangle(v, self._dims[name])
                for name, v in self._state.items()}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Inverse of :meth:`state_dict`; also takes raw packed vectors
        (n inferred from the triangle length)."""
        for name, leaf in sd.items():
            if isinstance(leaf, PackedTriangle):
                vec, d = leaf.vec, leaf.n
            else:
                vec = torch.as_tensor(leaf)
                d = int((np.sqrt(8 * vec.shape[-1] + 1) - 1) / 2)
                if tril_size(d) != vec.shape[-1]:
                    raise ValueError(
                        f"{name}: length {vec.shape[-1]} is not a "
                        "triangle number")
            self._state[name] = vec.to(self.out_dtype or torch.float32)
            self._dims[name] = d

    def tritiles(self, name: str, bm: int = 128) -> TriTiles:
        """The EMA'd packed Gram as TriTiles (one gather, stored dtype
        kept): ready for ``blas.symm`` without densifying."""
        return TriTiles.from_packed(self._state[name], self._dims[name],
                                    bm)

    def regime(self, name: str, n_tokens: int, P_: int) -> str:
        """Which of the paper's algorithm families is optimal for this
        Gram update (Thm 9)."""
        d = self._dims[name]
        return f"case {choose_algorithm(d, n_tokens, P_, m=1).case}"

    def summaries(self, name: str) -> Dict[str, float]:
        """trace / frobenius / effective rank (exp of the spectral
        entropy) from the packed EMA; the dense rebuild happens only
        here."""
        d = self._dims[name]
        dense = unpack_tril(self._state[name].float(), d, diag=True,
                            symmetric=True)
        evs = torch.clamp(torch.linalg.eigvalsh(dense), min=0.0)
        p = evs / torch.clamp(torch.sum(evs), min=1e-30)
        ent = -torch.sum(torch.where(p > 0, p * torch.log(p),
                                     torch.zeros_like(p)))
        return {
            "trace": float(torch.sum(evs)),
            "fro": float(torch.sqrt(torch.sum(evs ** 2))),
            "effective_rank": float(torch.exp(ent)),
            "packed_words": tril_size(d),
            "dense_words": d * d,
        }


def packed_diag_slots(d: int) -> np.ndarray:
    """Packed row-major offsets of the d diagonal entries: i(i+3)/2."""
    i = np.arange(d, dtype=np.int64)
    return (i * (i + 3) // 2).astype(np.int32)


def _diag_index(d: int, device) -> torch.Tensor:
    return torch.as_tensor(packed_diag_slots(d).astype(np.int64),
                           device=device)


def packed_add_diag(p: torch.Tensor, d: int, eps) -> torch.Tensor:
    """G + eps·I on the packed triangle — d scattered adds, no dense."""
    if isinstance(eps, float) and eps == 0.0:
        return p
    idx = _diag_index(d, p.device)
    return p.index_add(0, idx, torch.as_tensor(eps, dtype=p.dtype,
                                               device=p.device)
                       .expand(d).contiguous())


def packed_fro_norm(p: torch.Tensor, d: int) -> torch.Tensor:
    """Frobenius norm of sym(G) from the packed triangle: off-diagonal
    slots count twice, so ||G||_F² = 2·Σp² − Σ_diag p²."""
    diag = p[_diag_index(d, p.device)]
    return torch.sqrt(torch.clamp(
        2.0 * torch.sum(p * p) - torch.sum(diag * diag), min=1e-30))


def whitening_from_packed(packed: torch.Tensor, d: int, *,
                          eps: float = 1e-5, method: str = "ns",
                          iters: int = 30, bm: int = 32,
                          kernel: bool = False) -> torch.Tensor:
    """W = (sym(G) + eps·I)^{-1/2} from a packed lower triangle.

    ``method="ns"`` runs the coupled Newton–Schulz iteration
    X₀ = I, M₀ = (G + εI)/c, T = ½(3I − M), X ← X·T, M ← T²·M with
    c = ‖G + εI‖_F from the packed words; T² is a SYRK and the two
    products SYMMs, all routed through :mod:`repro_torch.blas`.  On the
    kernel route the Gram enters once, as TriTiles (bm tiles) densified
    through the SYMM kernel (A·I); on the dense route it is unpacked
    once.  bf16/f16 storage widens the diagonal shift to eps + u·‖G‖_F
    (u the storage dtype's machine eps), which keeps a quantized
    low-rank Gram positive definite.  ``method="eigh"`` is the dense
    oracle: rsqrt(max(λ, 0) + eps).  ``kernel`` forces the kernel route
    (the reference's ``interpret=True``)."""
    p32 = packed.float()
    if method == "eigh":
        dense = unpack_tril(p32, d, diag=True, symmetric=True)
        evs, vecs = torch.linalg.eigh(dense)
        inv_sqrt = torch.rsqrt(torch.clamp(evs, min=0.0) + eps)
        return (vecs * inv_sqrt[None]) @ vecs.T
    if method != "ns":
        raise ValueError(f"method must be 'ns' or 'eigh', got {method!r}")

    u = float(torch.finfo(packed.dtype).eps) \
        if packed.dtype.is_floating_point else 0.0
    if u > 2.0 ** -20:                    # bf16 / f16 storage
        shift = eps + u * packed_fro_norm(p32, d)
        p32 = packed_add_diag(p32, d, shift)
    else:
        p32 = packed_add_diag(p32, d, eps)
    c = packed_fro_norm(p32, d)
    pn = p32 / c
    route = plan_route("symm", d, d, device=packed.device, kernel=kernel)
    eye = torch.eye(d, dtype=torch.float32, device=packed.device)
    if route.path == "dense":
        m = unpack_tril(pn, d, diag=True, symmetric=True)
    else:
        a_op = TriTiles.from_packed(pn, d, min(bm, max(8, -(-d // 8) * 8)))
        m = blas.symm(a_op, eye, kernel=kernel)
    x = eye
    for _ in range(iters):
        t = 0.5 * (3.0 * eye - m)
        x = blas.symm(x, t, kernel=kernel)               # X·T
        t2 = blas.syrk(t, fill="full", kernel=kernel)    # T²
        m = blas.symm(t2, m, kernel=kernel)              # T²·M
        x, m = 0.5 * (x + x.T), 0.5 * (m + m.T)
    return x * torch.rsqrt(c)


def whitening_factor(monitor: GramMonitor, name: str, eps: float = 1e-5,
                     *, method: str = "ns", iters: int = 30,
                     kernel: bool = False) -> torch.Tensor:
    """W = (G + eps·I)^{-1/2} from the monitor's EMA'd packed Gram (a
    K-FAC-style factor); see :func:`whitening_from_packed`."""
    return whitening_from_packed(monitor._state[name], monitor._dims[name],
                                 eps=eps, method=method, iters=iters,
                                 kernel=kernel)
