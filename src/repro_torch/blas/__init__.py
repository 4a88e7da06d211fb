"""Symmetric BLAS (port of :mod:`repro.blas`):

    from repro_torch import blas
    c = blas.syrk(a, fill="packed")          # packed tril(A·Aᵀ), f32
    c = blas.symm(w, b)                      # sym(W)·B
    c = blas.syrk(stack)                     # (k, n1, n2): one launch
    c = blas.syrk(a, mesh=mesh)              # the paper's schedules

Calls on a CUDA tensor with n1 >= KERNEL_MIN_N1 run the hand-written
Hopper kernels; smaller or CPU calls run a dense IEEE-f32 matmul; with
``mesh=`` (a :class:`repro_torch.distributed.mesh.Mesh`) the call runs
the 1d / ring / 2d / 3d / 3d-limited schedule the planner picks on the
mesh's ranks.  Every call takes leading batch dims and is
differentiable (grad.py).  See api.py for the fill/accumulate/out_dtype
contracts.
"""
from ..core.packing import PackedTriangle, ShardedTriTiles, TriTiles
from .api import explain, symm, syr2k, syrk
from .autotune import heuristic_tiles
from .routing import (KERNEL_MIN_N1, Route, capture_routes, current_pin,
                      pinned, plan_route)

__all__ = ["syrk", "syr2k", "symm", "explain", "TriTiles",
           "PackedTriangle", "ShardedTriTiles", "plan_route", "Route", "KERNEL_MIN_N1",
           "capture_routes", "pinned", "current_pin", "heuristic_tiles"]
