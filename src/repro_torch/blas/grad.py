"""Autodiff for :mod:`repro_torch.blas`: one ``torch.autograd.Function``
per op, whose backward passes are again symmetric-BLAS calls (port of
the single-device half of :mod:`repro.blas.grad`).

Math (f32 cotangent Ḡ; ``sym(M) = tril(M) + strict_tril(M)ᵀ`` is what
``blas.symm`` reads; ``C = α·op(A[,B]) + β·C₀``):

  SYRK   C = α·A·Aᵀ + β·C₀        dA = α·(Ḡ + Ḡᵀ)·A        — one SYMM
  SYR2K  C = α·(A·Bᵀ + B·Aᵀ)+β·C₀ dA = α·(Ḡ + Ḡᵀ)·B,
                                  dB = α·(Ḡ + Ḡᵀ)·A        — two SYMMs
  SYMM   C = sym(A)·B             dB = sym(A)·Ḡ             — one SYMM
                                  dA = tril(Ḡ·Bᵀ + B·Ḡᵀ), diag halved
                                                 — a tril-projected SYR2K
  and dC₀ = β·(fill-projection of Ḡ), elementwise.

A "tril"/"packed" primal exposes only the lower triangle, so its
cotangent L enters the SYMM as the tril-valid operand with the diagonal
doubled (sym(L + diag L) = L + Lᵀ); a "full" primal contributes
tril(Ḡ) + triu(Ḡ)ᵀ.  On the kernel route a packed cotangent stays
packed: one gather into TriTiles, then the SYMM kernel with
``diag_scale=2.0`` in its prologue; the SYMM backward's halving is the
SYR2K epilogue's ``diag_scale=0.5``.  Elsewhere the scaling is one
elementwise pass (:func:`scale_matrix_diag`).

The residuals are the operands only.  The backward ops run under
:func:`~repro_torch.blas.routing.pinned` with the forward's Route, so a
kernel-routed call is differentiated on the kernels and a dense one
densely.  Leading batch dims pass through every rule.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.packing import TriTiles, tril_size, unpack_tril
from . import routing

#: backward ops per forward op: (cotangent name, blas op that computes it)
COTANGENT_OPS = {
    "syrk": (("A", "symm"),),
    "syr2k": (("A", "symm"), ("B", "symm")),
    "symm": (("A", "syr2k"), ("B", "symm")),
}


# --------------------------------------------------------------------------
# cotangent shape algebra
# --------------------------------------------------------------------------
def _packed_diag_scale(n1: int, value: float, dtype, device) -> torch.Tensor:
    """Packed-tril mask: ``value`` on the diagonal slots, 1 off, in the
    cotangent's dtype (a bf16 cotangent is not upcast by the multiply)."""
    scale = np.ones(tril_size(n1), np.float32)
    i = np.arange(n1)
    scale[i * (i + 3) // 2] = value
    return torch.as_tensor(scale, device=device).to(dtype)


def scale_matrix_diag(x: torch.Tensor, fill: str, n1: int,
                      scale: float) -> torch.Tensor:
    """``x`` with its matrix-diagonal entries scaled: the one elementwise
    diagonal scale of every route without a fused kernel prologue or
    epilogue.  ``fill="packed"`` scales the packed diagonal slots, any
    other fill the eye."""
    if scale == 1.0:
        return x
    if fill == "packed":
        return x * _packed_diag_scale(n1, scale, x.dtype, x.device)
    eye = torch.eye(n1, dtype=x.dtype, device=x.device)
    return x * (1.0 + (scale - 1.0) * eye)


def sym_cotangent(g: torch.Tensor, fill: str, n1: int) -> torch.Tensor:
    """Fill-shaped cotangent -> tril-valid L̂ with sym(L̂) = dL/d(full
    symmetric C); tril / packed primals project the upper triangle away
    and double the diagonal."""
    if fill == "full":
        return torch.tril(g) + torch.triu(g).mT
    if fill == "packed":
        return scale_matrix_diag(unpack_tril(g, n1, diag=True,
                                             symmetric=False),
                                 "tril", n1, 2.0)
    return scale_matrix_diag(torch.tril(g), "tril", n1, 2.0)


def _c_cotangent(g: torch.Tensor, fill: str, beta: float) -> torch.Tensor:
    """dC₀: beta times the fill-projection of Ḡ (only tril(C₀) is read;
    a "full" primal exposes each off-diagonal entry through both
    mirrors)."""
    g = g.float()
    if fill == "packed":
        return beta * g
    if fill == "tril":
        return beta * torch.tril(g)
    return beta * (torch.tril(g) + torch.tril(g.mT, -1))


def _scale(x: torch.Tensor, alpha: float) -> torch.Tensor:
    return x if alpha == 1.0 else alpha * x


def _cotangent_tiles(g: torch.Tensor, n1: int,
                     route: routing.Route) -> TriTiles:
    """Packed cotangent on the kernel route: one gather into TriTiles at
    the forward's bm; the SYMM kernel doubles its diagonal."""
    bm = route.tiles[0] if route.tiles else 128
    return TriTiles.from_packed(g, n1, bm)


# --------------------------------------------------------------------------
# backward rules (blas calls under the forward's pin)
# --------------------------------------------------------------------------
def _rank_bwd(g: torch.Tensor, others, *, fill: str, alpha: float,
              route: routing.Route, kernel: bool,
              diag_scale: float = 1.0):
    """dA (SYRK: others = (A,)) or (dA, dB) (SYR2K: others = (B, A)):
    one SYMM of the symmetrised cotangent per operand."""
    from . import api
    n1 = others[0].shape[-2]
    g = scale_matrix_diag(g.float(), fill, n1, diag_scale)
    with routing.pinned(route):
        if fill == "packed" and route.path == "kernel":
            at = _cotangent_tiles(g, n1, route)
            return tuple(_scale(api.symm(at, o, kernel=kernel,
                                         _diag_scale=2.0), alpha)
                         for o in others)
        lhat = sym_cotangent(g, fill, n1)
        return tuple(_scale(api.symm(lhat, o, kernel=kernel), alpha)
                     for o in others)


def _symm_bwd(g: torch.Tensor, a, b: torch.Tensor, *, route: routing.Route,
              kernel: bool, diag_scale: float = 1.0):
    """(dA, dB) for a dense tril-valid A, or (d tiles, dB) for a
    TriTiles A."""
    from . import api
    g = g.float()
    with routing.pinned(route):
        db = api.symm(a, g, kernel=kernel, _diag_scale=diag_scale)
        # only tril(A) is read, so dA lives in the lower triangle; its
        # diagonal is exposed once (off-diagonal pairs twice): the
        # halving runs in the SYR2K epilogue on the kernel route
        if isinstance(a, TriTiles):
            dp = api.syr2k(g, b, fill="packed", kernel=kernel,
                           _diag_scale=diag_scale / 2)
            return TriTiles.from_packed(dp, a.n, a.bm).tiles, db
        da = api.syr2k(g, b, fill="tril", kernel=kernel,
                       _diag_scale=diag_scale / 2)
    return da, db


# --------------------------------------------------------------------------
# autograd Functions (called by api.py with the planned Route)
# --------------------------------------------------------------------------
class _Syrk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a32, c32, fill, alpha, beta, route, kernel, out_dtype):
        from . import api
        ctx.save_for_backward(a32)
        ctx.args = (fill, alpha, beta, route, kernel)
        return api._execute_syrk(a32, c32, fill=fill, alpha=alpha,
                                 beta=beta, route=route, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, g):
        a32, = ctx.saved_tensors
        fill, alpha, beta, route, kernel = ctx.args
        da = dc = None
        if ctx.needs_input_grad[0]:
            da, = _rank_bwd(g, (a32,), fill=fill, alpha=alpha, route=route,
                            kernel=kernel)
        if ctx.needs_input_grad[1]:
            dc = _c_cotangent(g, fill, beta)
        return da, dc, None, None, None, None, None, None


class _Syr2k(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a32, b32, c32, fill, alpha, beta, route, kernel,
                out_dtype, diag_scale):
        from . import api
        ctx.save_for_backward(a32, b32)
        ctx.args = (fill, alpha, beta, route, kernel, diag_scale)
        return api._execute_syr2k(a32, b32, c32, fill=fill, alpha=alpha,
                                  beta=beta, route=route,
                                  out_dtype=out_dtype, diag_scale=diag_scale)

    @staticmethod
    def backward(ctx, g):
        a32, b32 = ctx.saved_tensors
        fill, alpha, beta, route, kernel, diag_scale = ctx.args
        da = db = dc = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            da, db = _rank_bwd(g, (b32, a32), fill=fill, alpha=alpha,
                               route=route, kernel=kernel,
                               diag_scale=diag_scale)
        if ctx.needs_input_grad[2]:
            dc = _c_cotangent(g, fill, beta)
        return (da, db, dc) + (None,) * 7


class _Symm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a32, b32, route, kernel, out_dtype, diag_scale):
        from . import api
        ctx.save_for_backward(a32, b32)
        ctx.args = (route, kernel, diag_scale)
        return api._execute_symm(a32, b32, route=route, out_dtype=out_dtype,
                                 diag_scale=diag_scale)

    @staticmethod
    def backward(ctx, g):
        a32, b32 = ctx.saved_tensors
        route, kernel, diag_scale = ctx.args
        da, db = _symm_bwd(g, a32, b32, route=route, kernel=kernel,
                           diag_scale=diag_scale)
        return da, db, None, None, None, None


class _SymmTiles(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tiles, n1, bm, b32, route, kernel, out_dtype,
                diag_scale):
        from . import api
        ctx.save_for_backward(tiles, b32)
        ctx.args = (n1, bm, route, kernel, diag_scale)
        return api._execute_symm_tiles(tiles, n1, bm, b32, route=route,
                                       out_dtype=out_dtype,
                                       diag_scale=diag_scale)

    @staticmethod
    def backward(ctx, g):
        tiles, b32 = ctx.saved_tensors
        n1, bm, route, kernel, diag_scale = ctx.args
        dt, db = _symm_bwd(g, TriTiles(tiles, n1, bm), b32, route=route,
                           kernel=kernel, diag_scale=diag_scale)
        return dt, None, None, db, None, None, None, None


def _tracked(*xs) -> bool:
    """Whether autograd records this call: outside it (serving, the
    optimizer's NS chain) the executors run directly, without a Function
    node's host cost."""
    return torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in xs)


def syrk_call(a32, c32, *, fill: str, alpha: float, beta: float,
              route: routing.Route, kernel: bool, out_dtype=None):
    if not _tracked(a32, c32):
        from . import api
        return api._execute_syrk(a32, c32, fill=fill, alpha=alpha,
                                 beta=beta, route=route, out_dtype=out_dtype)
    return _Syrk.apply(a32, c32, fill, alpha, beta, route, kernel,
                       out_dtype)


def syr2k_call(a32, b32, c32, *, fill: str, alpha: float, beta: float,
               route: routing.Route, kernel: bool, out_dtype=None,
               diag_scale: float = 1.0):
    if not _tracked(a32, b32, c32):
        from . import api
        return api._execute_syr2k(a32, b32, c32, fill=fill, alpha=alpha,
                                  beta=beta, route=route,
                                  out_dtype=out_dtype, diag_scale=diag_scale)
    return _Syr2k.apply(a32, b32, c32, fill, alpha, beta, route, kernel,
                        out_dtype, diag_scale)


def symm_call(a32, b32, *, route: routing.Route, kernel: bool,
              out_dtype=None, diag_scale: float = 1.0):
    """Dense tril-valid ``a32``; ``diag_scale`` is the fused cotangent
    prologue (sym_s(A)·B)."""
    if not _tracked(a32, b32):
        from . import api
        return api._execute_symm(a32, b32, route=route, out_dtype=out_dtype,
                                 diag_scale=diag_scale)
    return _Symm.apply(a32, b32, route, kernel, out_dtype, diag_scale)


def symm_tiles_call(tiles, n1: int, bm: int, b32, *, route: routing.Route,
                    kernel: bool, out_dtype=None, diag_scale: float = 1.0):
    """TriTiles A (its ``tiles`` tensor): its gradient comes back in the
    same packed tile layout."""
    if not _tracked(tiles, b32):
        from . import api
        return api._execute_symm_tiles(tiles, n1, bm, b32, route=route,
                                       out_dtype=out_dtype,
                                       diag_scale=diag_scale)
    return _SymmTiles.apply(tiles, n1, bm, b32, route, kernel, out_dtype,
                            diag_scale)
