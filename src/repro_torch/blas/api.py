"""The public symmetric-BLAS surface: ``syrk`` / ``syr2k`` / ``symm``.

Port of the single-device forward half of :mod:`repro.blas.api`.  Each
call is routed by :func:`repro_torch.blas.routing.plan_route`:

  dense  — IEEE-f32 ``torch.matmul`` (small shapes, CPU);
  kernel — the triangular flat-grid Hopper kernels
           (``kernels/trigrid.py``), tiles from the heuristic.

Contracts (those of the reference):
  * accumulation is always f32; ``out_dtype=None`` returns f32;
  * SYRK/SYR2K ``fill``: "tril" (default), "full" (symmetrised dense) or
    "packed" (row-major packed lower triangle);
  * SYMM reads only the lower triangle of its symmetric operand, which
    may be dense, a :class:`TriTiles` (straight into the kernel, no
    densification) or a :class:`PackedTriangle` (re-tiled by one gather);
  * SYRK/SYR2K take ``c``/``beta``/``alpha``:
    ``C_out = alpha·op(A[,B]) + beta·C`` with ``c`` in the output's fill
    (only its lower triangle is read); on the kernel route the
    scale-and-accumulate runs in the kernel epilogue.

Waiting for later slices: autodiff (``blas/grad.py``), leading batch
dims, the mesh routes and ``fill="sharded"``.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..core.packing import (PackedTriangle, TriTiles, pack_tril,
                            pack_tril_tiles, packed_to_tiles, pad2d,
                            tiles_to_packed, tril_size, unpack_tril_tiles)
from ..kernels.symm import symm_tiles
from ..kernels.syr2k import syr2k_tiles
from ..kernels.syrk import syrk_tiles
from .routing import plan_route

_FILLS = ("tril", "full", "packed")


def _check_fill(fill: str) -> None:
    if fill not in _FILLS:
        raise ValueError(f"fill must be one of {_FILLS}, got {fill!r}")


def _check_2d(*xs: torch.Tensor) -> None:
    for x in xs:
        if x.ndim != 2:
            raise ValueError("repro_torch.blas takes 2-D operands (leading "
                             f"batch dims are not ported yet), got "
                             f"{tuple(x.shape)}")


def _out(x: torch.Tensor, out_dtype) -> torch.Tensor:
    return x if out_dtype is None else x.to(out_dtype)


# --------------------------------------------------------------------------
# fill conversions
# --------------------------------------------------------------------------
def _tril_to_fill(tril: torch.Tensor, fill: str) -> torch.Tensor:
    if fill == "tril":
        return tril
    if fill == "full":
        return tril + torch.tril(tril, -1).T
    return pack_tril(tril)


def _tiles_to_fill(tiles: torch.Tensor, n1: int, bm: int,
                   fill: str) -> torch.Tensor:
    """Kernel-emitted packed tiles (diagonal masked in-epilogue) to the
    requested fill: "packed" is one gather, "tril"/"full" one scatter."""
    if fill == "packed":
        return tiles_to_packed(tiles, n1)
    npad = -(-n1 // bm) * bm
    dense = unpack_tril_tiles(tiles, npad, bm, symmetric=(fill == "full"))
    return dense[:n1, :n1]


def _fill_to_tiles(c: torch.Tensor, n1: int, bm: int,
                   fill: str) -> torch.Tensor:
    """Fill-format C -> packed (T, bm, bm) tiles for the in-kernel
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
    return base + beta * (torch.tril(c) + torch.tril(c, -1).T)


# --------------------------------------------------------------------------
# executors
# --------------------------------------------------------------------------
def _syrk_dense(a32: torch.Tensor, fill: str) -> torch.Tensor:
    g = a32 @ a32.T
    return g if fill == "full" else _tril_to_fill(torch.tril(g), fill)


def _syr2k_dense(a32: torch.Tensor, b32: torch.Tensor,
                 fill: str) -> torch.Tensor:
    g = a32 @ b32.T
    g = g + g.T
    return g if fill == "full" else _tril_to_fill(torch.tril(g), fill)


def _symm_dense(a32: torch.Tensor, b32: torch.Tensor) -> torch.Tensor:
    sym = torch.tril(a32) + torch.tril(a32, -1).T
    return sym @ b32


def _syrk_kernel(a32, c32, fill: str, tiles: Tuple[int, int], alpha: float,
                 beta: float, out_dtype) -> torch.Tensor:
    bm, bk = tiles
    n1 = a32.shape[0]
    ap = pad2d(a32, bm, bk).contiguous()
    c0 = _fill_to_tiles(c32, n1, bm, fill) \
        if c32 is not None and beta != 0.0 else None
    packed = syrk_tiles(ap, bm=bm, c0=c0, alpha=alpha, beta=beta,
                        out_dtype=out_dtype)
    return _tiles_to_fill(packed, n1, bm, fill)


def _syr2k_kernel(a32, b32, c32, fill: str, tiles: Tuple[int, int],
                  alpha: float, beta: float, out_dtype) -> torch.Tensor:
    bm, bk = tiles
    n1 = a32.shape[0]
    ap = pad2d(a32, bm, bk).contiguous()
    bp = pad2d(b32, bm, bk).contiguous()
    c0 = _fill_to_tiles(c32, n1, bm, fill) \
        if c32 is not None and beta != 0.0 else None
    packed = syr2k_tiles(ap, bp, bm=bm, c0=c0, alpha=alpha, beta=beta,
                         out_dtype=out_dtype)
    return _tiles_to_fill(packed, n1, bm, fill)


def _symm_kernel(a32, b32, tiles: Tuple[int, int],
                 out_dtype) -> torch.Tensor:
    """Dense tril-valid A: tile-pack its lower triangle (strictly-upper
    grid tiles are never gathered, diagonal tiles are symmetrised from
    their lower halves in the kernel)."""
    bm, bn = tiles
    n1, n2 = b32.shape
    packed = pack_tril_tiles(pad2d(a32, bm, bm), bm).contiguous()
    bp = pad2d(b32, bm, bn).contiguous()
    return symm_tiles(packed, bp, bm=bm, out_dtype=out_dtype)[:n1, :n2]


def _symm_kernel_tiles(a: TriTiles, b32, bn: int,
                       out_dtype) -> torch.Tensor:
    """Pre-packed A: its tiles flow straight into the kernel."""
    n2 = b32.shape[-1]
    bp = pad2d(b32, a.bm, bn).contiguous()
    return symm_tiles(a.tiles.contiguous(), bp, bm=a.bm,
                      out_dtype=out_dtype)[:a.n, :n2]


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


def _check_c(c, fill: str, n1: int) -> None:
    if c is None:
        return
    want = (tril_size(n1),) if fill == "packed" else (n1, n1)
    if tuple(c.shape) != want:
        raise ValueError(f"accumulator c for fill={fill!r} must have "
                         f"shape {want}, got {tuple(c.shape)}")


def syrk(a: torch.Tensor, *, out_dtype=None, fill: str = "tril", tile=None,
         kernel: bool = False, c: Optional[torch.Tensor] = None,
         alpha: float = 1.0, beta: Optional[float] = None) -> torch.Tensor:
    """C = alpha·A·Aᵀ + beta·C₀ for A (n1, n2), f32 accumulation.

    ``c`` is an accumulator in the output's fill (lower triangle read);
    ``beta`` defaults to 1.0 when it is given.  ``tile=(bm, bk)`` or
    ``kernel=True`` forces the kernel route."""
    _check_fill(fill)
    _check_2d(a)
    n1, n2 = a.shape
    beta = _resolve_beta(c, beta)
    _check_c(c, fill, n1)
    route = plan_route("syrk", n1, n2, device=a.device, tile=tile,
                       kernel=kernel)
    a32 = a.float()
    c32 = None if c is None else c.float()
    if route.path == "kernel":
        out = _syrk_kernel(a32, c32, fill, route.tiles, alpha, beta,
                           out_dtype or torch.float32)
    else:
        out = _combine_fill(_syrk_dense(a32, fill), c32, alpha, beta, fill)
    return _out(out, out_dtype)


def syr2k(a: torch.Tensor, b: torch.Tensor, *, out_dtype=None,
          fill: str = "tril", tile=None, kernel: bool = False,
          c: Optional[torch.Tensor] = None, alpha: float = 1.0,
          beta: Optional[float] = None) -> torch.Tensor:
    """C = alpha·(A·Bᵀ + B·Aᵀ) + beta·C₀ for A, B (n1, n2)."""
    _check_fill(fill)
    _check_2d(a, b)
    if a.shape != b.shape:
        raise ValueError(f"syr2k operands must match: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    n1, n2 = a.shape
    beta = _resolve_beta(c, beta)
    _check_c(c, fill, n1)
    route = plan_route("syr2k", n1, n2, device=a.device, tile=tile,
                       kernel=kernel)
    a32, b32 = a.float(), b.float()
    c32 = None if c is None else c.float()
    if route.path == "kernel":
        out = _syr2k_kernel(a32, b32, c32, fill, route.tiles, alpha, beta,
                            out_dtype or torch.float32)
    else:
        out = _combine_fill(_syr2k_dense(a32, b32, fill), c32, alpha, beta,
                            fill)
    return _out(out, out_dtype)


def symm(a_sym: Union[torch.Tensor, TriTiles, PackedTriangle],
         b: torch.Tensor, *, out_dtype=None, tile=None,
         kernel: bool = False) -> torch.Tensor:
    """C = sym(A)·B for tril-valid A (n1, n1) and B (n1, n2).

    ``a_sym`` is a dense tensor (only its lower triangle is read), a
    :class:`TriTiles` (fed to the kernel as it is) or a
    :class:`PackedTriangle` (re-tiled by one gather, then as
    TriTiles)."""
    _check_2d(b)
    n1, n2 = b.shape
    if isinstance(a_sym, PackedTriangle):
        bm = tile[0] if tile else min(128, max(8, -(-a_sym.n // 8) * 8))
        a_sym = TriTiles.from_packed(a_sym.vec, a_sym.n, bm)
    if isinstance(a_sym, TriTiles):
        if a_sym.n != n1 or a_sym.batch_shape:
            raise ValueError(f"symm shapes: TriTiles(n={a_sym.n}, "
                             f"batch={a_sym.batch_shape}) vs b "
                             f"{tuple(b.shape)}")
        route = plan_route("symm", n1, n2, device=b.device, tile=tile,
                           kernel=kernel)
        a_t = a_sym.to(torch.float32)
        b32 = b.float()
        if route.path == "kernel":
            out = _symm_kernel_tiles(a_t, b32, route.tiles[1],
                                     out_dtype or torch.float32)
        else:
            out = a_t.to_full() @ b32
        return _out(out, out_dtype)
    _check_2d(a_sym)
    if tuple(a_sym.shape) != (n1, n1):
        raise ValueError(f"symm shapes: a {tuple(a_sym.shape)} vs b "
                         f"{tuple(b.shape)}")
    route = plan_route("symm", n1, n2, device=b.device, tile=tile,
                       kernel=kernel)
    a32, b32 = a_sym.float(), b.float()
    if route.path == "kernel":
        out = _symm_kernel(a32, b32, route.tiles,
                           out_dtype or torch.float32)
    else:
        out = _symm_dense(a32, b32)
    return _out(out, out_dtype)
