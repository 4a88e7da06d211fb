"""The public symmetric-BLAS surface: ``syrk`` / ``syr2k`` / ``symm``,
and ``explain``.

Port of :mod:`repro.blas.api`.  Each call is routed by
:func:`repro_torch.blas.routing.plan_route`:

  dense    — IEEE-f32 ``torch.matmul`` (small shapes, CPU);
  kernel   — the triangular flat-grid Hopper kernels
             (``kernels/trigrid.py``), tiles from the heuristic;
  1d / ring / 2d / 3d / 3d-limited — the paper's schedules on a
             :class:`~repro_torch.distributed.mesh.Mesh` of
             ``torch.distributed`` ranks (``blas/meshpath.py``), when
             ``mesh=`` is given.

Contracts (those of the reference):
  * accumulation is always f32; ``out_dtype=None`` returns f32;
  * leading batch dims are supported, shared by all operands: on the
    kernel route a stack is one kernel launch (the reference vmaps its
    Pallas kernels, which adds one grid axis);
  * SYRK/SYR2K ``fill``: "tril" (default), "full" (symmetrised dense),
    "packed" (row-major packed lower triangle) or "sharded" (a
    :class:`ShardedTriTiles`: on a 2d / 3d route this rank's extended
    triangle block, no gather made; elsewhere every device's blocks);
  * SYMM reads only the lower triangle of its symmetric operand, which
    may be dense, a :class:`TriTiles` (straight into the kernel or onto
    the packed mesh wire, no densification), a :class:`PackedTriangle`
    (re-tiled by one gather) or a :class:`ShardedTriTiles` (the grid
    routes use a local shard in place);
  * on a mesh every rank passes the same operands (SPMD) and gets the
    same result, but for ``fill="sharded"``;
  * SYRK/SYR2K take ``c``/``beta``/``alpha``:
    ``C_out = alpha·op(A[,B]) + beta·C`` with ``c`` in the output's fill
    (only its lower triangle is read); on the kernel route the
    scale-and-accumulate runs in the kernel epilogue;
  * every call is differentiable (``blas/grad.py``): the backward ops
    are again SYRK / SYR2K / SYMM calls on the forward's route.

Waiting for a later slice: the measured ``tile="auto"`` cache, and the
reference's ``b_layout`` (a GSPMD placement hint for B, which has no
counterpart when every rank holds its operands).
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..core.packing import (PackedTriangle, ShardedTriTiles, TriTiles,
                            pack_tril, pack_tril_tiles, packed_to_tiles,
                            pad2d, tiles_to_packed, tril_size, unpack_tril,
                            unpack_tril_tiles)
from ..kernels.symm import symm_tiles
from ..kernels.syr2k import syr2k_tiles
from ..kernels.syrk import syrk_tiles
from . import grad, meshpath
from .routing import MESH_PATHS, Route, pinned, plan_route

_FILLS = ("tril", "full", "packed", "sharded")
GRID_PATHS = ("2d", "3d", "3d-limited")


def _check_fill(fill: str) -> None:
    if fill not in _FILLS:
        raise ValueError(f"fill must be one of {_FILLS}, got {fill!r}")


def _check_sharded_fill(batch: bool, c) -> None:
    """fill="sharded" returns the mesh-resident layout: no batch stack
    and no accumulator on that exit (as the reference)."""
    if batch:
        raise ValueError('fill="sharded" does not support leading batch '
                         "dims")
    if c is not None:
        raise ValueError('fill="sharded" does not support an accumulator '
                         "c")


def _sharded_grid_c(route: Route) -> int:
    """Grid of a ShardedTriTiles built off the grid routes: the planned
    c when it names a real triangle grid, else the smallest."""
    if route.choice is not None and route.choice.c >= 2:
        return route.choice.c
    return 2


def _on_mesh(route: Route) -> bool:
    return route.P > 1 and route.path in MESH_PATHS


def _check_rank(*xs: torch.Tensor) -> None:
    for x in xs:
        if x.ndim < 2:
            raise ValueError("repro_torch.blas takes (..., n1, n2) "
                             f"operands, got {tuple(x.shape)}")


def _out(x: torch.Tensor, out_dtype) -> torch.Tensor:
    return x if out_dtype is None else x.to(out_dtype)


# --------------------------------------------------------------------------
# fill conversions (leading dims pass through)
# --------------------------------------------------------------------------
def _tril_to_fill(tril: torch.Tensor, fill: str) -> torch.Tensor:
    if fill == "tril":
        return tril
    if fill == "full":
        return tril + torch.tril(tril, -1).mT
    return pack_tril(tril)


def _packed_to_fill(packed: torch.Tensor, n1: int,
                    fill: str) -> torch.Tensor:
    if fill == "packed":
        return packed
    return unpack_tril(packed, n1, diag=True, symmetric=(fill == "full"))


def _scale_diag_blocks(st: ShardedTriTiles, s: float) -> ShardedTriTiles:
    """A ShardedTriTiles with its matrix diagonal scaled: the diagonal
    entries live only on the diagonal blocks' own diagonals."""
    if s == 1.0:
        return st
    eye = torch.eye(st.nb, dtype=st.diag.dtype, device=st.diag.device)
    return ShardedTriTiles(st.off, st.diag * (1.0 + (s - 1.0) * eye), st.n,
                           st.c, st.mesh, st.axis)


def _scale_sharded(st: ShardedTriTiles, alpha: float) -> ShardedTriTiles:
    if alpha == 1.0:
        return st
    return ShardedTriTiles(alpha * st.off, alpha * st.diag, st.n, st.c,
                           st.mesh, st.axis)


def _tiles_to_fill(tiles: torch.Tensor, n1: int, bm: int,
                   fill: str) -> torch.Tensor:
    """Kernel-emitted packed tiles (diagonal masked in-epilogue) to the
    requested fill: "packed" is one gather, "tril"/"full" one scatter."""
    if fill == "packed":
        return tiles_to_packed(tiles, n1)
    npad = -(-n1 // bm) * bm
    dense = unpack_tril_tiles(tiles, npad, bm, symmetric=(fill == "full"))
    return dense[..., :n1, :n1]


def _fill_to_tiles(c: torch.Tensor, n1: int, bm: int,
                   fill: str) -> torch.Tensor:
    """Fill-format C -> packed (..., T, bm, bm) tiles for the in-kernel
    beta-accumulate (lower triangle only; the epilogue masks after)."""
    if fill == "packed":
        return packed_to_tiles(c, n1, bm).contiguous()
    return pack_tril_tiles(pad2d(c, bm, bm), bm).contiguous()


def _combine_fill(base: torch.Tensor, c: Optional[torch.Tensor],
                  alpha: float, beta: float, fill: str) -> torch.Tensor:
    """Dense-route epilogue: ``alpha·base + beta·tril-projection(c)``."""
    if alpha != 1.0:
        base = alpha * base
    if c is None or beta == 0.0:
        return base
    if fill == "packed":
        return base + beta * c
    if fill == "tril":
        return base + beta * torch.tril(c)
    return base + beta * (torch.tril(c) + torch.tril(c, -1).mT)


# --------------------------------------------------------------------------
# executors (the primal bodies; grad.py wraps them in autograd Functions)
# --------------------------------------------------------------------------
def _syrk_dense(a32: torch.Tensor, fill: str) -> torch.Tensor:
    g = a32 @ a32.mT
    return g if fill == "full" else _tril_to_fill(torch.tril(g), fill)


def _syr2k_dense(a32: torch.Tensor, b32: torch.Tensor,
                 fill: str) -> torch.Tensor:
    g = a32 @ b32.mT
    g = g + g.mT
    return g if fill == "full" else _tril_to_fill(torch.tril(g), fill)


def _symm_dense(a32: torch.Tensor, b32: torch.Tensor) -> torch.Tensor:
    sym = torch.tril(a32) + torch.tril(a32, -1).mT
    return sym @ b32


def _rank_kernel(body: str, a32, b32, c32, fill: str,
                 tiles: Tuple[int, int], alpha: float, beta: float,
                 out_dtype, diag_scale: float = 1.0) -> torch.Tensor:
    bm, bk = tiles
    n1 = a32.shape[-2]
    ap = pad2d(a32, bm, bk).contiguous()
    c0 = _fill_to_tiles(c32, n1, bm, fill) \
        if c32 is not None and beta != 0.0 else None
    if body == "syrk":
        packed = syrk_tiles(ap, bm=bm, c0=c0, alpha=alpha, beta=beta,
                            out_dtype=out_dtype)
    else:
        bp = pad2d(b32, bm, bk).contiguous()
        packed = syr2k_tiles(ap, bp, bm=bm, c0=c0, alpha=alpha, beta=beta,
                             out_dtype=out_dtype, diag_scale=diag_scale)
    return _tiles_to_fill(packed, n1, bm, fill)


def _symm_kernel(a32, b32, tiles: Tuple[int, int],
                 out_dtype) -> torch.Tensor:
    """Dense tril-valid A: tile-pack its lower triangle (strictly-upper
    grid tiles are never gathered, diagonal tiles are symmetrised from
    their lower halves in the kernel)."""
    bm, bn = tiles
    n1, n2 = b32.shape[-2:]
    packed = pack_tril_tiles(pad2d(a32, bm, bm), bm).contiguous()
    bp = pad2d(b32, bm, bn).contiguous()
    return symm_tiles(packed, bp, bm=bm, out_dtype=out_dtype)[..., :n1, :n2]


def _symm_kernel_tiles(a_tiles: torch.Tensor, n1: int, bm: int, b32,
                       bn: int, out_dtype,
                       diag_scale: float = 1.0) -> torch.Tensor:
    """Pre-packed A: its tiles flow straight into the kernel, with the
    diagonal scaled in the kernel's prologue."""
    n2 = b32.shape[-1]
    bp = pad2d(b32, bm, bn).contiguous()
    return symm_tiles(a_tiles.contiguous(), bp, bm=bm, out_dtype=out_dtype,
                      diag_scale=diag_scale)[..., :n1, :n2]


def _mesh_rank_update(body: str, a32, b32, route: Route, mesh):
    """A SYRK / SYR2K on a mesh route: the packed triangle (…, L) on
    every rank (1d, ring), or this rank's ShardedTriTiles (grid routes)."""
    ch, ax = route.choice, route.axis
    if route.path == "1d":
        return meshpath.syrk_1d_packed(a32, mesh, ax) if body == "syrk" \
            else meshpath.syr2k_1d_packed(a32, b32, mesh, ax)
    if route.path == "ring":
        return meshpath.syrk_ring_packed(a32, mesh, ax) if body == "syrk" \
            else meshpath.syr2k_ring_packed(a32, b32, mesh, ax)
    if route.path == "2d":
        return meshpath.syrk_2d_sharded(a32, ch.c, mesh, ax) \
            if body == "syrk" else \
            meshpath.syr2k_2d_sharded(a32, b32, ch.c, mesh, ax)
    if route.path == "3d":
        return meshpath.syrk_3d_sharded(a32, ch.c, ch.p2, mesh, ax) \
            if body == "syrk" else \
            meshpath.syr2k_3d_sharded(a32, b32, ch.c, ch.p2, mesh, ax)
    return meshpath.syrk_3d_limited_sharded(a32, ch.c, ch.p2, ch.b, mesh,
                                            ax) if body == "syrk" else \
        meshpath.syr2k_3d_limited_sharded(a32, b32, ch.c, ch.p2, ch.b, mesh,
                                          ax)


def _execute_rank_update(body: str, a32, b32, c32, *, fill: str,
                         alpha: float, beta: float, route: Route, mesh,
                         out_dtype=None, diag_scale: float = 1.0):
    """SYRK (``b32`` None) or SYR2K on any route.  A diag_scale runs in
    the kernel epilogue on the kernel route, as one elementwise pass
    elsewhere."""
    n1 = a32.shape[-2]
    if fill == "sharded":
        if _on_mesh(route):
            out = _mesh_rank_update(body, a32, b32, route, mesh)
            if route.path in GRID_PATHS:
                return _scale_sharded(_scale_diag_blocks(out, diag_scale),
                                      alpha)
            packed = alpha * out if alpha != 1.0 else out
            packed = grad.scale_matrix_diag(packed, "packed", n1, diag_scale)
        else:
            packed = _execute_rank_update(
                body, a32, b32, None, fill="packed", alpha=alpha, beta=0.0,
                route=route, mesh=mesh, out_dtype=out_dtype,
                diag_scale=diag_scale)
        # off the grid routes: every device's blocks of the packed result
        return ShardedTriTiles.from_packed(packed, n1, _sharded_grid_c(route))
    if _on_mesh(route):
        out = _mesh_rank_update(body, a32, b32, route, mesh)
        packed = out.to_packed() if isinstance(out, ShardedTriTiles) else out
        res = _combine_fill(_packed_to_fill(packed, n1, fill), c32, alpha,
                            beta, fill)
    elif route.path == "kernel":
        return _rank_kernel(body, a32, b32, c32, fill, route.tiles, alpha,
                            beta, out_dtype or torch.float32, diag_scale)
    else:
        dense = _syrk_dense(a32, fill) if body == "syrk" else \
            _syr2k_dense(a32, b32, fill)
        res = _combine_fill(dense, c32, alpha, beta, fill)
    return grad.scale_matrix_diag(res, fill, n1, diag_scale)


def _execute_syrk(a32, c32, *, fill: str, alpha: float, beta: float,
                  route: Route, mesh=None, out_dtype=None):
    return _execute_rank_update("syrk", a32, None, c32, fill=fill,
                                alpha=alpha, beta=beta, route=route,
                                mesh=mesh, out_dtype=out_dtype)


def _execute_syr2k(a32, b32, c32, *, fill: str, alpha: float, beta: float,
                   route: Route, mesh=None, out_dtype=None,
                   diag_scale: float = 1.0):
    return _execute_rank_update("syr2k", a32, b32, c32, fill=fill,
                                alpha=alpha, beta=beta, route=route,
                                mesh=mesh, out_dtype=out_dtype,
                                diag_scale=diag_scale)


def _mesh_symm_packed(p: torch.Tensor, b32, n1: int, route: Route, mesh):
    """A packed symmetric operand (…, L) onto the mesh route's wire."""
    ch, ax = route.choice, route.axis
    if route.path == "1d":
        return meshpath.symm_1d_packed_a(p, b32, n1, mesh, ax)
    if route.path == "ring":
        return meshpath.symm_ring_packed_a(p, b32, n1, mesh, ax)
    if route.path == "2d":
        return meshpath.symm_2d_packed_a(p, b32, ch.c, mesh, ax)
    if route.path == "3d":
        return meshpath.symm_3d_packed_a(p, b32, ch.c, ch.p2, mesh, ax)
    return meshpath.symm_3d_limited_packed_a(p, b32, ch.c, ch.p2, ch.b,
                                             mesh, ax)


def _execute_symm(a32: torch.Tensor, b32: torch.Tensor, *, route: Route,
                  mesh=None, out_dtype=None,
                  diag_scale: float = 1.0) -> torch.Tensor:
    """Dense tril-valid A; a diag_scale is one elementwise pass on it."""
    a32 = grad.scale_matrix_diag(a32, "tril", a32.shape[-1], diag_scale)
    if _on_mesh(route):
        return _mesh_symm_packed(pack_tril(a32), b32, a32.shape[-1], route,
                                 mesh)
    if route.path == "kernel":
        return _symm_kernel(a32, b32, route.tiles,
                            out_dtype or torch.float32)
    return _symm_dense(a32, b32)


def _execute_symm_tiles(a_tiles: torch.Tensor, n1: int, bm: int, b32, *,
                        route: Route, mesh=None, out_dtype=None,
                        diag_scale: float = 1.0) -> torch.Tensor:
    """Packed A (``TriTiles.tiles``): straight into the kernel, the
    diagonal scale in its prologue; onto the packed wire on a mesh
    route; the dense route rebuilds sym(A)."""
    if route.path == "kernel":
        return _symm_kernel_tiles(a_tiles, n1, bm, b32, route.tiles[1],
                                  out_dtype or torch.float32, diag_scale)
    if _on_mesh(route):
        p = grad.scale_matrix_diag(tiles_to_packed(a_tiles, n1), "packed",
                                   n1, diag_scale)
        return _mesh_symm_packed(p, b32, n1, route, mesh)
    full = TriTiles(a_tiles, n1, bm).to_full()
    return grad.scale_matrix_diag(full, "full", n1, diag_scale) @ b32


def _execute_symm_sharded(st: ShardedTriTiles, b32: torch.Tensor, *,
                          route: Route, mesh=None, out_dtype=None,
                          diag_scale: float = 1.0) -> torch.Tensor:
    """SYMM of a ShardedTriTiles: the grid routes use this rank's shard
    in place (a layout of another grid goes through the packed
    triangle), the other routes take its packed words."""
    st = _scale_diag_blocks(st, diag_scale)
    ch, ax = route.choice, route.axis
    if _on_mesh(route) and route.path in GRID_PATHS:
        if route.path == "2d":
            return meshpath.symm_2d_sharded_a(st, b32, ch.c, mesh, ax)
        if route.path == "3d":
            return meshpath.symm_3d_sharded_a(st, b32, ch.c, ch.p2, mesh, ax)
        return meshpath.symm_3d_limited_sharded_a(st, b32, ch.c, ch.p2,
                                                  ch.b, mesh, ax)
    if _on_mesh(route):
        return _mesh_symm_packed(st.to_packed(), b32, st.n, route, mesh)
    if route.path == "kernel":
        bm = route.tiles[0] if route.tiles else 128
        return _execute_symm_tiles(st.to_tritiles(bm).tiles, st.n, bm, b32,
                                   route=route, out_dtype=out_dtype)
    return st.to_full() @ b32


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------
def _resolve_beta(c, beta) -> float:
    """``beta=None`` means 1.0 when an accumulator is given, else 0.0."""
    if beta is None:
        return 1.0 if c is not None else 0.0
    beta = float(beta)
    if beta != 0.0 and c is None:
        raise ValueError("beta != 0 requires an accumulator c")
    return beta


def _check_c(c, fill: str, n1: int, lead: Tuple[int, ...]) -> None:
    if c is None:
        return
    want = lead + ((tril_size(n1),) if fill == "packed" else (n1, n1))
    if tuple(c.shape) != want:
        raise ValueError(f"accumulator c for fill={fill!r} must have "
                         f"shape {want}, got {tuple(c.shape)}")


def syrk(a: torch.Tensor, *, out_dtype=None, fill: str = "tril", tile=None,
         kernel: bool = False, c: Optional[torch.Tensor] = None,
         alpha: float = 1.0, beta: Optional[float] = None, mesh=None,
         axis: Optional[str] = None, M="auto"):
    """C = alpha·A·Aᵀ + beta·C₀ for A (..., n1, n2), f32 accumulation.

    ``c`` is an accumulator in the output's fill (lower triangle read);
    ``beta`` defaults to 1.0 when it is given.  ``tile=(bm, bk)`` or
    ``kernel=True`` forces the kernel route.  ``mesh`` / ``axis`` run
    the call on a :class:`~repro_torch.distributed.mesh.Mesh` (every
    rank passes the same ``a``); ``M`` is the per-device memory budget
    in f32 words for the §IX regime.  ``fill="sharded"`` returns a
    :class:`ShardedTriTiles`.  Differentiable: the backward is a SYMM on
    the same route (:mod:`repro_torch.blas.grad`).
    """
    _check_fill(fill)
    _check_rank(a)
    n1, n2 = a.shape[-2:]
    if fill == "sharded":
        _check_sharded_fill(a.ndim > 2, c)
    beta = _resolve_beta(c, beta)
    _check_c(c, fill, n1, tuple(a.shape[:-2]))
    route = plan_route("syrk", n1, n2, device=a.device, batch=a.ndim > 2,
                       tile=tile, kernel=kernel, mesh=mesh, axis=axis, M=M)
    c32 = None if c is None else c.float()
    return _out(grad.syrk_call(a.float(), c32, fill=fill, alpha=alpha,
                               beta=beta, route=route, kernel=kernel,
                               mesh=mesh, out_dtype=out_dtype), out_dtype)


def syr2k(a: torch.Tensor, b: torch.Tensor, *, out_dtype=None,
          fill: str = "tril", tile=None, kernel: bool = False,
          c: Optional[torch.Tensor] = None, alpha: float = 1.0,
          beta: Optional[float] = None, mesh=None,
          axis: Optional[str] = None, M="auto",
          _diag_scale: float = 1.0):
    """C = alpha·(A·Bᵀ + B·Aᵀ) + beta·C₀ for A, B (..., n1, n2); the
    ``fill`` / accumulator / ``mesh`` / ``M`` contract of :func:`syrk`.

    ``_diag_scale`` (internal, used by the SYMM backward) scales the
    matrix diagonal of the output: in the kernel's epilogue on the
    kernel route, one elementwise pass elsewhere; it does not combine
    with an accumulator ``c``."""
    _check_fill(fill)
    _check_rank(a, b)
    if a.shape != b.shape:
        raise ValueError(f"syr2k operands must match: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    if _diag_scale != 1.0 and c is not None:
        raise ValueError("_diag_scale is incompatible with an "
                         "accumulator c")
    n1, n2 = a.shape[-2:]
    if fill == "sharded":
        _check_sharded_fill(a.ndim > 2, c)
    beta = _resolve_beta(c, beta)
    _check_c(c, fill, n1, tuple(a.shape[:-2]))
    route = plan_route("syr2k", n1, n2, device=a.device, batch=a.ndim > 2,
                       tile=tile, kernel=kernel, mesh=mesh, axis=axis, M=M)
    c32 = None if c is None else c.float()
    return _out(grad.syr2k_call(a.float(), b.float(), c32, fill=fill,
                                alpha=alpha, beta=beta, route=route,
                                kernel=kernel, mesh=mesh,
                                out_dtype=out_dtype,
                                diag_scale=_diag_scale), out_dtype)


def symm(a_sym: Union[torch.Tensor, TriTiles, PackedTriangle,
                      ShardedTriTiles],
         b: torch.Tensor, *, out_dtype=None, tile=None,
         kernel: bool = False, mesh=None, axis: Optional[str] = None,
         M="auto", _diag_scale: float = 1.0) -> torch.Tensor:
    """C = sym(A)·B for tril-valid A (..., n1, n1) and B (..., n1, n2).

    ``a_sym`` is a dense tensor (only its lower triangle is read), a
    :class:`TriTiles` (fed to the kernel, or the packed mesh wire, as it
    is), a :class:`PackedTriangle` (re-tiled by one gather, then as
    TriTiles) or a :class:`ShardedTriTiles` (no batch dims; a grid route
    uses a local shard in place).  ``mesh`` / ``axis`` / ``M`` as in
    :func:`syrk`.  ``_diag_scale`` (internal, the packed cotangent's
    prologue) computes sym_s(A)·B with the matrix diagonal of sym(A)
    scaled by s.  Differentiable: dB is a SYMM and dA a tril-projected
    SYR2K on the same route (dA comes back in A's layout)."""
    _check_rank(b)
    n1, n2 = b.shape[-2:]
    lead = tuple(b.shape[:-2])
    if isinstance(a_sym, PackedTriangle):
        bm = tile[0] if tile else min(128, max(8, -(-a_sym.n // 8) * 8))
        a_sym = TriTiles.from_packed(a_sym.vec, a_sym.n, bm)
    route = plan_route("symm", n1, n2, device=b.device, batch=b.ndim > 2,
                       tile=tile, kernel=kernel, mesh=mesh, axis=axis, M=M)
    b32 = b.float()
    kw = dict(route=route, kernel=kernel, mesh=mesh, out_dtype=out_dtype,
              diag_scale=_diag_scale)
    if isinstance(a_sym, ShardedTriTiles):
        if a_sym.n != n1 or lead or a_sym.batch_shape:
            raise ValueError(f"symm shapes: ShardedTriTiles(n={a_sym.n}) "
                             f"vs b {tuple(b.shape)} (no batch dims)")
        return _out(grad.symm_sharded_call(a_sym.to(torch.float32), b32,
                                           **kw), out_dtype)
    if isinstance(a_sym, TriTiles):
        if a_sym.n != n1 or a_sym.batch_shape != lead:
            raise ValueError(f"symm shapes: TriTiles(n={a_sym.n}, "
                             f"batch={a_sym.batch_shape}) vs b "
                             f"{tuple(b.shape)}")
        out = grad.symm_tiles_call(a_sym.tiles.float(), a_sym.n, a_sym.bm,
                                   b32, **kw)
        return _out(out, out_dtype)
    _check_rank(a_sym)
    if tuple(a_sym.shape) != lead + (n1, n1):
        raise ValueError(f"symm shapes: a {tuple(a_sym.shape)} vs b "
                         f"{tuple(b.shape)}")
    return _out(grad.symm_call(a_sym.float(), b32, **kw), out_dtype)


def explain(op: str, n1: int, n2: int, *, device=None, mesh=None,
            axis: Optional[str] = None, grad: bool = False,
            M="auto") -> str:
    """Human-readable routing decision for (op, n1, n2) on ``device``
    (default: the card when one is present, else the CPU), or on
    ``mesh``: the ring's ``ring P=… nb=… shifts=…``, the grids' ``c``,
    ``p1``, ``p2`` and, on the §IX route, the chunk ``b`` and its
    predicted words (pass a small ``M`` to see it take over).  With
    ``grad=True``, one more line per backward-pass op: the route each
    cotangent takes when autograd flows through the call, planned under
    the forward Route's pin as the backward plans it."""
    from .grad import COTANGENT_OPS
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    r = plan_route(op, n1, n2, device=dev, mesh=mesh, axis=axis, M=M)
    if not grad:
        return r.describe()
    lines = [r.describe()]
    for wrt, bop in COTANGENT_OPS[op]:
        with pinned(r):
            br = plan_route(bop, n1, n2, device=dev, mesh=mesh,
                            axis=r.axis)
        lines.append(f"  d{wrt}: {br.describe()}")
    return "\n".join(lines)
