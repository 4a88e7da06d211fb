"""Autodiff for :mod:`repro_torch.blas`: one ``torch.autograd.Function``
per op, whose backward passes are again symmetric-BLAS calls (port of
:mod:`repro.blas.grad`).

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
SYR2K epilogue's ``diag_scale=0.5``.  On a mesh route a packed
cotangent stays packed too: its diagonal doubled by one elementwise
pass, it goes straight onto the packed wire of the backward SYMM's
route (:func:`_packed_mesh_symm`).  Elsewhere the scaling is one
elementwise pass (:func:`scale_matrix_diag`).

The residuals are the operands only.  The backward ops run under
:func:`~repro_torch.blas.routing.pinned` with the forward's Route, so a
kernel-routed call is differentiated on the kernels, a dense one
densely and a mesh call on its forward's mesh route.  Leading batch
dims pass through every rule.

On a mesh every rank runs the same backward (SPMD): the loss must be
the same on every rank, as a replicated output's is.  A
``fill="sharded"`` output's cotangent is its ShardedTriTiles; a local
one's shards are gathered (each of the c(c+1) shards once), so its
gradient is that of the sum of the shards' losses.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.packing import ShardedTriTiles, TriTiles, tril_size, unpack_tril
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


def _packed_mesh_symm(g_packed: torch.Tensor, others, n1: int,
                      route: routing.Route, mesh):
    """Packed cotangent × each operand on a mesh: the packed diagonal
    doubled, then straight onto the packed wire the backward SYMM plans
    (the 1D all-gather, the ring slots, or this rank's 2d / 3d block
    gathered by rows), never dense.  None when that SYMM plans dense."""
    from . import api
    o = others[0]
    br = routing.plan_route("symm", n1, o.shape[-1], device=o.device,
                            batch=o.ndim > 2, mesh=mesh, axis=route.axis)
    if not api._on_mesh(br):
        return None
    lp = scale_matrix_diag(g_packed, "packed", n1, 2.0)
    return tuple(api._mesh_symm_packed(lp, x, n1, br, mesh) for x in others)


# --------------------------------------------------------------------------
# backward rules (blas calls under the forward's pin)
# --------------------------------------------------------------------------
def _bwd_kwargs(route: routing.Route, kernel: bool, mesh) -> dict:
    """What lets a backward blas call re-enter ``plan_route`` on the
    forward call's terms: the kernel request, and the mesh and axis of a
    mesh route (the route itself comes from the pin)."""
    return dict(kernel=kernel, mesh=mesh, axis=route.axis)


def _rank_bwd(g: torch.Tensor, others, *, fill: str, alpha: float,
              route: routing.Route, kernel: bool, mesh=None,
              diag_scale: float = 1.0):
    """dA (SYRK: others = (A,)) or (dA, dB) (SYR2K: others = (B, A)):
    one SYMM of the symmetrised cotangent per operand."""
    from . import api
    n1 = others[0].shape[-2]
    g = scale_matrix_diag(g.float(), fill, n1, diag_scale)
    with routing.pinned(route):
        if fill == "packed" and mesh is not None:
            out = _packed_mesh_symm(g, others, n1, route, mesh)
            if out is not None:
                return tuple(_scale(x, alpha) for x in out)
        if fill == "packed" and route.path == "kernel":
            at = _cotangent_tiles(g, n1, route)
            return tuple(_scale(api.symm(at, o, kernel=kernel,
                                         _diag_scale=2.0), alpha)
                         for o in others)
        lhat = sym_cotangent(g, fill, n1)
        kw = _bwd_kwargs(route, kernel, mesh)
        return tuple(_scale(api.symm(lhat, o, **kw), alpha)
                     for o in others)


def _symm_bwd(g: torch.Tensor, a, b: torch.Tensor, *, route: routing.Route,
              kernel: bool, mesh=None, diag_scale: float = 1.0):
    """(dA, dB) for a dense tril-valid A; (d tiles, dB) for a TriTiles
    A; ((d off, d diag), dB) for a ShardedTriTiles A."""
    from . import api
    g = g.float()
    kw = _bwd_kwargs(route, kernel, mesh)
    with routing.pinned(route):
        db = api.symm(a, g, _diag_scale=diag_scale, **kw)
        # only tril(A) is read, so dA lives in the lower triangle; its
        # diagonal is exposed once (off-diagonal pairs twice): the
        # halving runs in the SYR2K epilogue on the kernel route
        if isinstance(a, (TriTiles, ShardedTriTiles)):
            dp = api.syr2k(g, b, fill="packed", _diag_scale=diag_scale / 2,
                           **kw)
            if isinstance(a, TriTiles):
                return TriTiles.from_packed(dp, a.n, a.bm).tiles, db
            da = ShardedTriTiles.from_packed(dp, a.n, a.c, a.mesh, a.axis)
            return (da.off, da.diag), db
        da = api.syr2k(g, b, fill="tril", _diag_scale=diag_scale / 2, **kw)
    return da, db


# --------------------------------------------------------------------------
# autograd Functions (called by api.py with the planned Route)
# --------------------------------------------------------------------------
def _outputs(res, meta: list):
    """A Function's outputs: a ShardedTriTiles leaves as (off, diag),
    its layout kept in ``meta``."""
    if isinstance(res, ShardedTriTiles):
        meta.append((res.n, res.c, res.mesh, res.axis))
        return res.off, res.diag
    return res


def _cotangent(grads, meta: list, fill: str):
    """The output cotangent and the fill its algebra reads: a sharded
    output's (off, diag) cotangents as their packed words."""
    if not meta:
        return grads[0], fill
    n, c, mesh, axis = meta[0]
    like = meta[1]
    g_off = grads[0] if grads[0] is not None else torch.zeros_like(like[0])
    g_diag = grads[1] if grads[1] is not None else torch.zeros_like(like[1])
    return ShardedTriTiles(g_off, g_diag, n, c, mesh, axis).to_packed(), \
        "packed"


def _wrap(out, meta: list):
    if meta:
        n, c, mesh, axis = meta[0]
        return ShardedTriTiles(out[0], out[1], n, c, mesh, axis)
    return out


class _Syrk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a32, c32, fill, alpha, beta, route, kernel, mesh,
                out_dtype, meta):
        from . import api
        ctx.save_for_backward(a32)
        ctx.args = (fill, alpha, beta, route, kernel, mesh, meta)
        out = _outputs(api._execute_syrk(a32, c32, fill=fill, alpha=alpha,
                                         beta=beta, route=route, mesh=mesh,
                                         out_dtype=out_dtype), meta)
        if meta:
            meta.append(out)
        return out

    @staticmethod
    def backward(ctx, *grads):
        a32, = ctx.saved_tensors
        fill, alpha, beta, route, kernel, mesh, meta = ctx.args
        g, gfill = _cotangent(grads, meta, fill)
        da = dc = None
        if ctx.needs_input_grad[0]:
            da, = _rank_bwd(g, (a32,), fill=gfill, alpha=alpha, route=route,
                            kernel=kernel, mesh=mesh)
        if ctx.needs_input_grad[1]:
            dc = _c_cotangent(g, fill, beta)
        return (da, dc) + (None,) * 8


class _Syr2k(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a32, b32, c32, fill, alpha, beta, route, kernel, mesh,
                out_dtype, diag_scale, meta):
        from . import api
        ctx.save_for_backward(a32, b32)
        ctx.args = (fill, alpha, beta, route, kernel, mesh, diag_scale, meta)
        out = _outputs(api._execute_syr2k(
            a32, b32, c32, fill=fill, alpha=alpha, beta=beta, route=route,
            mesh=mesh, out_dtype=out_dtype, diag_scale=diag_scale), meta)
        if meta:
            meta.append(out)
        return out

    @staticmethod
    def backward(ctx, *grads):
        a32, b32 = ctx.saved_tensors
        fill, alpha, beta, route, kernel, mesh, diag_scale, meta = ctx.args
        g, gfill = _cotangent(grads, meta, fill)
        da = db = dc = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            da, db = _rank_bwd(g, (b32, a32), fill=gfill, alpha=alpha,
                               route=route, kernel=kernel, mesh=mesh,
                               diag_scale=diag_scale)
        if ctx.needs_input_grad[2]:
            dc = _c_cotangent(g, fill, beta)
        return (da, db, dc) + (None,) * 9


class _Symm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a32, b32, route, kernel, mesh, out_dtype, diag_scale):
        from . import api
        ctx.save_for_backward(a32, b32)
        ctx.args = (route, kernel, mesh, diag_scale)
        return api._execute_symm(a32, b32, route=route, mesh=mesh,
                                 out_dtype=out_dtype, diag_scale=diag_scale)

    @staticmethod
    def backward(ctx, g):
        a32, b32 = ctx.saved_tensors
        route, kernel, mesh, diag_scale = ctx.args
        da, db = _symm_bwd(g, a32, b32, route=route, kernel=kernel,
                           mesh=mesh, diag_scale=diag_scale)
        return da, db, None, None, None, None, None


class _SymmTiles(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tiles, n1, bm, b32, route, kernel, mesh, out_dtype,
                diag_scale):
        from . import api
        ctx.save_for_backward(tiles, b32)
        ctx.args = (n1, bm, route, kernel, mesh, diag_scale)
        return api._execute_symm_tiles(tiles, n1, bm, b32, route=route,
                                       mesh=mesh, out_dtype=out_dtype,
                                       diag_scale=diag_scale)

    @staticmethod
    def backward(ctx, g):
        tiles, b32 = ctx.saved_tensors
        n1, bm, route, kernel, mesh, diag_scale = ctx.args
        dt, db = _symm_bwd(g, TriTiles(tiles, n1, bm), b32, route=route,
                           kernel=kernel, mesh=mesh, diag_scale=diag_scale)
        return dt, None, None, db, None, None, None, None, None


class _SymmSharded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, off, diag, b32, layout, route, kernel, mesh, out_dtype,
                diag_scale):
        from . import api
        ctx.save_for_backward(off, diag, b32)
        ctx.args = (layout, route, kernel, mesh, diag_scale)
        st = ShardedTriTiles(off, diag, *layout)
        return api._execute_symm_sharded(st, b32, route=route, mesh=mesh,
                                         out_dtype=out_dtype,
                                         diag_scale=diag_scale)

    @staticmethod
    def backward(ctx, g):
        off, diag, b32 = ctx.saved_tensors
        layout, route, kernel, mesh, diag_scale = ctx.args
        (d_off, d_diag), db = _symm_bwd(
            g, ShardedTriTiles(off, diag, *layout), b32, route=route,
            kernel=kernel, mesh=mesh, diag_scale=diag_scale)
        return (d_off, d_diag, db) + (None,) * 6


def _tracked(*xs) -> bool:
    """Whether autograd records this call: outside it (serving, the
    optimizer's NS chain) the executors run directly, without a Function
    node's host cost."""
    return torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in xs)


def syrk_call(a32, c32, *, fill: str, alpha: float, beta: float,
              route: routing.Route, kernel: bool, mesh=None,
              out_dtype=None):
    if not _tracked(a32, c32):
        from . import api
        return api._execute_syrk(a32, c32, fill=fill, alpha=alpha,
                                 beta=beta, route=route, mesh=mesh,
                                 out_dtype=out_dtype)
    meta: list = []
    out = _Syrk.apply(a32, c32, fill, alpha, beta, route, kernel, mesh,
                      out_dtype, meta)
    return _wrap(out, meta)


def syr2k_call(a32, b32, c32, *, fill: str, alpha: float, beta: float,
               route: routing.Route, kernel: bool, mesh=None,
               out_dtype=None, diag_scale: float = 1.0):
    if not _tracked(a32, b32, c32):
        from . import api
        return api._execute_syr2k(a32, b32, c32, fill=fill, alpha=alpha,
                                  beta=beta, route=route, mesh=mesh,
                                  out_dtype=out_dtype, diag_scale=diag_scale)
    meta: list = []
    out = _Syr2k.apply(a32, b32, c32, fill, alpha, beta, route, kernel, mesh,
                       out_dtype, diag_scale, meta)
    return _wrap(out, meta)


def symm_call(a32, b32, *, route: routing.Route, kernel: bool, mesh=None,
              out_dtype=None, diag_scale: float = 1.0):
    """Dense tril-valid ``a32``; ``diag_scale`` is the fused cotangent
    prologue (sym_s(A)·B)."""
    if not _tracked(a32, b32):
        from . import api
        return api._execute_symm(a32, b32, route=route, mesh=mesh,
                                 out_dtype=out_dtype, diag_scale=diag_scale)
    return _Symm.apply(a32, b32, route, kernel, mesh, out_dtype, diag_scale)


def symm_tiles_call(tiles, n1: int, bm: int, b32, *, route: routing.Route,
                    kernel: bool, mesh=None, out_dtype=None,
                    diag_scale: float = 1.0):
    """TriTiles A (its ``tiles`` tensor): its gradient comes back in the
    same packed tile layout."""
    if not _tracked(tiles, b32):
        from . import api
        return api._execute_symm_tiles(tiles, n1, bm, b32, route=route,
                                       mesh=mesh, out_dtype=out_dtype,
                                       diag_scale=diag_scale)
    return _SymmTiles.apply(tiles, n1, bm, b32, route, kernel, mesh,
                            out_dtype, diag_scale)


def symm_sharded_call(st: ShardedTriTiles, b32, *, route: routing.Route,
                      kernel: bool, mesh=None, out_dtype=None,
                      diag_scale: float = 1.0):
    """ShardedTriTiles A: its gradient comes back as (off, diag) in the
    same layout."""
    if not _tracked(st.off, st.diag, b32):
        from . import api
        return api._execute_symm_sharded(st, b32, route=route, mesh=mesh,
                                         out_dtype=out_dtype,
                                         diag_scale=diag_scale)
    layout = (st.n, st.c, st.mesh, st.axis)
    return _SymmSharded.apply(st.off, st.diag, b32, layout, route, kernel,
                              mesh, out_dtype, diag_scale)
