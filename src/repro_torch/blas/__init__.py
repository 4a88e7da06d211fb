"""Symmetric BLAS on one device (port of :mod:`repro.blas`):

    from repro_torch import blas
    c = blas.syrk(a, fill="packed")          # packed tril(A·Aᵀ), f32
    c = blas.symm(w, b)                      # sym(W)·B
    c = blas.syrk(stack)                     # (k, n1, n2): one launch

Calls on a CUDA tensor with n1 >= KERNEL_MIN_N1 run the hand-written
Hopper kernels; smaller or CPU calls run a dense IEEE-f32 matmul.  Every
call takes leading batch dims and is differentiable (grad.py).  See
api.py for the fill/accumulate/out_dtype contracts.
"""
from ..core.packing import PackedTriangle, TriTiles
from .api import explain, symm, syr2k, syrk
from .autotune import heuristic_tiles
from .routing import (KERNEL_MIN_N1, Route, capture_routes, current_pin,
                      pinned, plan_route)

__all__ = ["syrk", "syr2k", "symm", "explain", "TriTiles",
           "PackedTriangle", "plan_route", "Route", "KERNEL_MIN_N1",
           "capture_routes", "pinned", "current_pin", "heuristic_tiles"]
