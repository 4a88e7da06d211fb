"""Route planning for :mod:`repro_torch.blas` (port of
:mod:`repro.blas.routing`).

  mesh present:   regime kind (1d / 2d / ring / 3d / 3d-limited)  ->  1d
                  ->  dense (each rank alone, on its replicated operands)
  single device:  kernel (CUDA tensor and n1 >= KERNEL_MIN_N1, or an
                  explicit request)  ->  dense (torch.matmul, IEEE f32)

The mesh half is the reference's: the regime from
:func:`~repro_torch.core.dispatch.choose_algorithm` (Thm 9 / §VIII-D,
the §IX budget ``M``), :func:`_grid_fits` for whether its grid embeds
in the axis, and the reference's 1d fallback when it does not.  The
``"3d-limited"`` kind stays distinct from ``"3d"``: collapsing them
would discard the working-set bound the planner chose it for.

A batched call (leading dims) plans as its one matrix does: on the
kernel route the whole stack is one launch.  :func:`pinned` holds a
forward Route while its backward ops are planned, so the backward of a
kernel-routed call stays on the kernels and that of a dense call stays
dense (:mod:`repro_torch.blas.grad`).

The reference gates its Pallas route on ``backend == "tpu"``; here the
gate is the operand's device.  An explicit ``tile=`` pair, or
``kernel=True`` (the counterpart of the reference's ``interpret=True``),
forces the kernel route on any device: on a CPU tensor the kernel
wrappers then run their plain versions, which is how the CPU tests walk
the kernel route.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from ..core.dispatch import (AlgoChoice, choose_algorithm, ring_nb,
                             resolve_memory_budget)
from ..core.gf import prime_power
from .autotune import heuristic_tiles

OPS = ("syrk", "syr2k", "symm")
M_OF = {"syrk": 1, "syr2k": 2, "symm": 2}

#: the mesh paths (a Route with P > 1 runs one of these, or "dense")
MESH_PATHS = ("1d", "2d", "3d", "3d-limited", "ring")

#: below this n1 one 128-tile covers the triangle and the kernel cannot
#: beat a dense matmul; the reference's value, not yet measured on the
#: H100 (ROADMAP)
KERNEL_MIN_N1 = 256


@dataclass(frozen=True)
class Route:
    """An executable routing decision."""
    op: str
    path: str       # "dense" | "kernel" | "1d" | "2d" | "3d" | "3d-limited"
                    # | "ring"
    reason: str
    n1: int
    n2: int
    tiles: Optional[Tuple[int, int]] = None
    batch: bool = False
    P: int = 1
    axis: Optional[str] = None
    choice: Optional[AlgoChoice] = None
    M: Optional[int] = None   # resolved per-device memory budget (words)

    def describe(self) -> str:
        grid = ""
        if self.choice is not None and self.path in ("2d", "3d",
                                                     "3d-limited"):
            grid = (f" grid c={self.choice.c} p1={self.choice.p1}"
                    f" p2={self.choice.p2}")
            if self.path == "3d-limited":
                grid += (f" b={self.choice.b} M={self.M}"
                         f" W_IX={self.choice.predicted_words:.4g}w")
        elif self.choice is not None and self.path == "ring":
            grid = (f" ring P={self.choice.P}"
                    f" nb={ring_nb(self.n1, self.choice.P)}"
                    f" shifts={self.choice.P // 2}")
        tiles = f" tiles={self.tiles}" if self.tiles else ""
        batch = " batched" if self.batch else ""
        return (f"{self.op}[{self.n1}x{self.n2}]{batch} -> {self.path}"
                f"{grid}{tiles} ({self.reason})")


_CTX = threading.local()


def _pin_stack() -> List[Route]:
    if not hasattr(_CTX, "pins"):
        _CTX.pins = []
    return _CTX.pins


def current_pin() -> Optional[Route]:
    stack = _pin_stack()
    return stack[-1] if stack else None


@contextlib.contextmanager
def pinned(route: Optional[Route]):
    """Pin a forward Route while planning its backward-pass ops: inside
    the context, ``plan_route`` resolves onto the pinned path ("dense"
    stays dense, "kernel" stays on the kernels, with the forward's tiles
    for the same op and shape, else the heuristic's).  ``route=None``
    is a no-op."""
    if route is None:
        yield
        return
    stack = _pin_stack()
    stack.append(route)
    try:
        yield
    finally:
        stack.pop()


def _capture_stack() -> List[list]:
    if not hasattr(_CTX, "captures"):
        _CTX.captures = []
    return _CTX.captures


@contextlib.contextmanager
def capture_routes():
    """Collect every Route planned on this thread inside the context."""
    log: List[Route] = []
    stack = _capture_stack()
    stack.append(log)
    try:
        yield log
    finally:
        stack.remove(log)


def _emit(route: Route) -> Route:
    for log in _capture_stack():
        log.append(route)
    return route


def _tiles(op: str, n1: int, n2: int, tile) -> Tuple[int, int]:
    if tile is None:
        return heuristic_tiles(op, n1, n2)
    if isinstance(tile, tuple) and len(tile) == 2:
        return int(tile[0]), int(tile[1])
    raise ValueError(f"tile must be a (bm, bk) pair, got {tile!r}")


def _resolve_axis(mesh, axis: Optional[str]) -> Optional[str]:
    if mesh is None:
        return None
    names = list(mesh.shape)
    if axis is not None:
        if axis not in mesh.shape:
            raise ValueError(f"axis {axis!r} not in mesh axes {names}; "
                             "pass axis=None to auto-select")
        return axis
    if len(names) == 1:
        return names[0]
    # auto-select: the largest axis (a size-1 'model' axis on a
    # (data=4, model=1) mesh must not swallow the call into the
    # single-device dense path); prefer 'model' then the last axis on
    # size ties
    return max(names, key=lambda nm: (mesh.shape[nm], nm == "model",
                                      names.index(nm)))


def _is_prime_power(c: int) -> bool:
    return prime_power(c) is not None if isinstance(c, int) and c > 1 \
        else False


def _grid_fits(choice: AlgoChoice, P: int, n2: int,
               single_axis: bool) -> Optional[str]:
    """Which mesh path (if any) can execute ``choice`` exactly."""
    c = choice.c
    if choice.kind == "ring":
        # a ppermute ring over ONE named axis: no c(c+1) embedding, no
        # idle ranks, no n2 divisibility (only rows are padded)
        return "ring" if choice.P >= 2 else None
    if choice.kind == "2d":
        if choice.idle == 0 and c >= 2 and _is_prime_power(c):
            return "2d"
        return None
    if choice.kind == "3d-limited":
        # the memory-constrained plan must NOT collapse into the
        # unlimited-memory 3D (or 2D) schedule: that discards the §IX
        # working-set bound the dispatcher just enforced.  The streamed
        # schedule takes a degenerate replication axis (p2 == 1 still
        # chunks the columns), so only the grid embedding, the chunk and
        # the column split gate it.
        if choice.idle != 0 or c < 2 or not _is_prime_power(c):
            return None
        if single_axis and choice.b >= 1 \
                and n2 % max(choice.p2, 1) == 0:
            return "3d-limited"
        return None
    if choice.kind == "3d":
        if choice.idle != 0 or c < 2 or not _is_prime_power(c):
            return None
        if choice.p2 == 1:        # degenerate replication axis: pure 2D
            return "2d"
        if single_axis and n2 % choice.p2 == 0:
            return "3d"
    return None


def _plan_mesh(op: str, n1: int, n2: int, m: int, P: int, ax: str, mesh,
               batch: bool, M_res) -> Route:
    """The reference's mesh branch: regime kind, then the 1d fallback,
    then dense."""
    single = len(mesh.shape) == 1
    choice = choose_algorithm(n1, n2, P, m, M_res)
    grid_path = _grid_fits(choice, P, n2, single)
    kw = dict(batch=batch, P=P, axis=ax, M=M_res)
    if batch:
        # the stack rides a collective's payload: packed triangles on the
        # 1D wire, extended triangle blocks on the 2d / 3d all-to-all,
        # row blocks on the ring shifts; one collective (pair) covers the
        # stack.  As in the reference, the streamed 3d-limited schedule
        # is not planned for a stack (it falls through to 1d / dense).
        if grid_path == "ring":
            return _emit(Route(op, "ring", "batched: stacked row blocks "
                               "ride the cyclic-shift wire", n1, n2,
                               choice=choice, **kw))
        if grid_path in ("2d", "3d"):
            return _emit(Route(op, grid_path, "batched: extended triangle "
                               f"blocks stacked on the {grid_path} exchange "
                               "payload", n1, n2, choice=choice, **kw))
        if n2 % P == 0:
            return _emit(Route(op, "1d", "batched: stacked packed triangles "
                               "on the 1D wire", n1, n2, choice=choice,
                               **kw))
        return _emit(Route(op, "dense", f"batched with n2 % P = {n2 % P} "
                           "!= 0 and no stacked grid; dense on each rank",
                           n1, n2, **kw))
    fits_1d = n2 % P == 0
    if choice.kind == "1d" and fits_1d:
        return _emit(Route(op, "1d", f"Thm 9 case {choice.case}: packed-"
                           "triangle 1D is optimal", n1, n2, choice=choice,
                           **kw))
    if grid_path == "ring":
        return _emit(Route(op, "ring", "computation-bound (large n2/P): "
                           "cyclic-shift ring computes only the unique "
                           "half of the symmetric flops at 1d-level words",
                           n1, n2, choice=choice, **kw))
    if grid_path == "3d-limited":
        return _emit(Route(op, "3d-limited", f"§IX memory-dependent: "
                           f"M={M_res} words forces streaming b={choice.b} "
                           f"columns over the {choice.p1}x{choice.p2} grid",
                           n1, n2, choice=choice, **kw))
    if grid_path is not None:
        return _emit(Route(op, grid_path, f"Thm 9 case {choice.case}: "
                           f"{choice.kind} grid embeds exactly", n1, n2,
                           choice=choice, **kw))
    if fits_1d:
        return _emit(Route(op, "1d", f"{choice.kind} grid infeasible on "
                           f"P={P}; 1D fallback", n1, n2, choice=choice,
                           **kw))
    return _emit(Route(op, "dense", f"no distributed grid fits (P={P}, "
                       f"n2%P={n2 % P}); dense on each rank", n1, n2,
                       choice=choice, **kw))


def plan_route(op: str, n1: int, n2: int, *, device: torch.device,
               batch: bool = False, tile=None, kernel: bool = False,
               mesh=None, axis: Optional[str] = None,
               M="auto") -> Route:
    """Pick the execution path for one blas call on ``device``;
    ``batch`` marks a call with leading dims (the same path, one launch
    or one collective for the stack).  ``mesh`` / ``axis``: a
    :class:`~repro_torch.distributed.mesh.Mesh` and the axis to run on
    (None: the largest).  ``M``: per-device memory budget in f32 words
    for the §IX regime ("auto": ``REPRO_BLAS_MEMORY_WORDS`` or the
    card's memory; None: no budget; an int as it is)."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}")
    pin = current_pin()
    if mesh is not None:
        if pin is not None and axis is None and pin.axis in mesh.shape:
            axis = pin.axis
        ax = _resolve_axis(mesh, axis)
        if mesh.shape[ax] > 1:
            if tile is not None or kernel:
                import warnings
                warnings.warn("repro_torch.blas: tile=/kernel= only affect "
                              "the single-device kernel route and are "
                              "ignored when a mesh routes the call",
                              stacklevel=3)
            P = mesh.shape[ax]
            M_res = pin.M if (pin is not None and M == "auto") \
                else resolve_memory_budget(M)
            if pin is not None and pin.P == P and \
                    (pin.path in MESH_PATHS or pin.path == "dense") and \
                    (n1, n2) == (pin.n1, pin.n2):
                return _emit(Route(op, pin.path, f"pinned to the {pin.op} "
                                   f"{pin.path} route", n1, n2, batch=batch,
                                   P=P, axis=ax, choice=pin.choice,
                                   M=pin.M))
            return _plan_mesh(op, n1, n2, M_OF[op], P, ax, mesh, batch,
                              M_res)
    if pin is not None and pin.P == 1:
        # the backward of a call rides the forward's path, so the two
        # agree whatever the shape heuristics say
        if pin.path == "kernel":
            tiles = pin.tiles if tile is None and op == pin.op and \
                (n1, n2) == (pin.n1, pin.n2) else _tiles(op, n1, n2, tile)
            return _emit(Route(op, "kernel", f"pinned to forward {pin.op} "
                               "kernel route", n1, n2, tiles=tiles,
                               batch=batch))
        return _emit(Route(op, "dense", f"pinned to forward {pin.op} "
                           "dense route", n1, n2, batch=batch))
    explicit = tile is not None or kernel
    on_cuda = torch.device(device).type == "cuda"
    if explicit or (on_cuda and n1 >= KERNEL_MIN_N1):
        why = "explicit tile/kernel request" if explicit else \
            "triangular flat-grid kernel on cuda"
        return _emit(Route(op, "kernel", why, n1, n2,
                           tiles=_tiles(op, n1, n2, tile), batch=batch))
    return _emit(Route(op, "dense", "small shape or no kernel device "
                       f"({torch.device(device).type}); dense matmul",
                       n1, n2, batch=batch))
