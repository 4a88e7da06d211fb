"""Muon: momentum plus Newton–Schulz (NS) orthogonalization on the
symmetric BLAS (port of the single-device half of
:mod:`repro.optim.muon`, reference mode).

Each NS iteration of X (m × n, m ≤ n) computes

    S  = X·Xᵀ                (SYRK)
    X ← a·X + (b·S + c·S²)·X (SYMM chain: S², then symmetric·X)

On the card every Gram is a ``rank_update`` launch and both products
``sym_stream`` launches.  A stacked parameter (the reference's
``(n_periods, m, n)`` leaves) goes through as one stack: each blas call
takes the whole stack in one launch, where the reference vmaps the same
chain over the flattened stack.  Norms are per matrix (over the last two
dims) and every matrix of a stack works on its short side.

``orthogonalize_1d`` (the 1D mesh schedule behind ``mode="syrk-1d"``)
waits for the mesh slice; without a mesh the reference takes the
reference branch in that mode too, and so does the port.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from .. import blas
from ..core.packing import PackedTriangle, tril_size

Tree = Dict[Any, torch.Tensor]

# quintic Newton–Schulz coefficients (Jordan et al., Muon)
NS_COEFFS = (3.4445, -4.7750, 2.0315)


class MuonState(NamedTuple):
    step: int
    momentum: Tree
    #: optional per-matrix Gram EMA of the momentum (PackedTriangle
    #: leaves; an empty placeholder where a leaf is not a 2-D matrix);
    #: None unless ``Muon.gram_decay`` is set
    gram: Optional[Dict[Any, Any]] = None


# ---------------------------------------------------------------------------
# Newton–Schulz cores
# ---------------------------------------------------------------------------
def ns_iteration_reference(x: torch.Tensor,
                           gram_chunk: Optional[int] = None) -> torch.Tensor:
    """One NS step of x (..., m, n) on the blas surface: the Gram is a
    SYRK, both products SYMMs, each one call for the whole stack.

    ``gram_chunk`` streams the Gram over column chunks of that size
    through the SYRK's beta-accumulate epilogue (``c=s, beta=1``)."""
    a, b, c = NS_COEFFS
    n = x.shape[-1]
    if gram_chunk is None or gram_chunk >= n:
        s = blas.syrk(x, fill="full")                         # S = X·Xᵀ
    else:
        s = None
        for lo in range(0, n, gram_chunk):
            s = blas.syrk(x[..., lo:lo + gram_chunk], fill="full", c=s)
    y = b * s + c * blas.symm(s, s)                           # S² (sym·S)
    return a * x + blas.symm(y, x)                            # sym(Y)·X


def orthogonalize_reference(g: torch.Tensor, steps: int = 5,
                            gram_chunk: Optional[int] = None) -> torch.Tensor:
    """NS orthogonalization of g (..., m, n) on the short side of its
    matrices; returns approximately semi-orthogonal matrices in g's
    dtype.  Each matrix of a stack is scaled by its own norm."""
    transpose = g.shape[-2] > g.shape[-1]
    x = (g.mT if transpose else g).float().contiguous()
    x = x / (torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True) + 1e-7)
    for _ in range(steps):
        x = ns_iteration_reference(x, gram_chunk)
    return (x.mT if transpose else x).to(g.dtype)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
def _is_matrix(p: torch.Tensor) -> bool:
    """Muon applies to matrices: ``ndim >= 2`` and both trailing dims
    at least 8.  As in the reference, a stacked (n_periods, d) leaf (the
    norms' scales and biases) counts once n_periods >= 8 and is then
    orthogonalized as one n_periods × d matrix."""
    return p.ndim >= 2 and min(p.shape[-2:]) >= 8


@dataclass(frozen=True)
class Muon:
    """Momentum + NS orthogonalization for matrix params, signSGD with
    momentum for the rest.

    mode: 'reference' (the NS chain on the blas surface) or 'syrk-1d',
    which without a mesh takes the same branch (the 1D mesh schedule
    waits for the mesh slice)."""
    lr: float = 2e-2
    momentum: float = 0.95
    ns_steps: int = 5
    weight_decay: float = 0.0
    mode: str = "reference"
    fallback_lr: float = 3e-4
    #: stream NS Grams over column chunks of this size (None: one shot)
    gram_chunk: Optional[int] = None
    #: EMA decay of a packed momentum-Gram per 2-D matrix param (the
    #: short-side ``blas.syrk(fill="packed")``); None disables it
    gram_decay: Optional[float] = None

    def _gram_zero(self, p: torch.Tensor):
        if _is_matrix(p) and p.ndim == 2:
            m = min(p.shape)
            return PackedTriangle(torch.zeros((tril_size(m),),
                                              dtype=torch.float32,
                                              device=p.device), m)
        return torch.zeros((0,), dtype=torch.float32, device=p.device)

    def init(self, params: Tree) -> MuonState:
        gram = None
        if self.gram_decay is not None:
            gram = {k: self._gram_zero(p) for k, p in params.items()}
        return MuonState(step=0, momentum={
            k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}, gram=gram)

    def _orthogonalize(self, m2: torch.Tensor) -> torch.Tensor:
        """m2: (..., m, n) f32 momentum, stacks included."""
        if self.mode not in ("reference", "syrk-1d"):
            raise ValueError(f"mode {self.mode!r}")
        return orthogonalize_reference(m2, self.ns_steps, self.gram_chunk)

    @torch.no_grad()
    def update(self, grads: Tree, state: MuonState, params: Tree,
               lr_scale: float = 1.0) -> Tuple[Tree, MuonState]:
        step = state.step + 1
        mom = {k: self.momentum * state.momentum[k] + g.float()
               for k, g in grads.items()}

        def upd(p, mm):
            if _is_matrix(p):
                o = self._orthogonalize(mm)
                scale = math.sqrt(max(1.0, p.shape[-2] / p.shape[-1]))
                delta = o * scale + self.weight_decay * p.float()
                return (p.float() - self.lr * lr_scale * delta).to(p.dtype)
            return (p.float() - self.fallback_lr * lr_scale
                    * torch.sign(mm)).to(p.dtype)

        new_params = {k: upd(p, mom[k]) for k, p in params.items()}

        gram = state.gram
        if self.gram_decay is not None and gram is not None:
            d = self.gram_decay

            def upd_gram(gm, mm):
                if not isinstance(gm, PackedTriangle):
                    return gm
                x = mm if mm.shape[0] <= mm.shape[1] else mm.T
                g = blas.syrk(x.float().contiguous(),
                              fill="packed") / x.shape[-1]
                ema = d * gm.vec.float() + (1.0 - d) * g
                return PackedTriangle(ema.to(gm.dtype), gm.n)

            gram = {k: upd_gram(gm, mom[k]) for k, gm in gram.items()}
        return new_params, MuonState(step=step, momentum=mom, gram=gram)


def state_dict(state: MuonState) -> dict:
    """MuonState as a stable-keyed dict (``gram``: PackedTriangle
    leaves, which a checkpoint layer stores packed)."""
    return {"step": state.step, "momentum": state.momentum,
            "gram": state.gram}


def load_state_dict(d: dict) -> MuonState:
    """Inverse of :func:`state_dict` (``gram`` optional)."""
    return MuonState(step=d["step"], momentum=d["momentum"],
                     gram=d.get("gram"))
