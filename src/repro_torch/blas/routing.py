"""Route planning for :mod:`repro_torch.blas` (port of the single-device
half of :mod:`repro.blas.routing`; the mesh routes wait).

  single device:  kernel (CUDA tensor and n1 >= KERNEL_MIN_N1, or an
                  explicit request)  ->  dense (torch.matmul, IEEE f32)

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

from .autotune import heuristic_tiles

OPS = ("syrk", "syr2k", "symm")

#: below this n1 one 128-tile covers the triangle and the kernel cannot
#: beat a dense matmul; the reference's value, not yet measured on the
#: H100 (ROADMAP)
KERNEL_MIN_N1 = 256


@dataclass(frozen=True)
class Route:
    """An executable routing decision."""
    op: str
    path: str                          # "dense" | "kernel"
    reason: str
    n1: int
    n2: int
    tiles: Optional[Tuple[int, int]] = None
    batch: bool = False

    def describe(self) -> str:
        tiles = f" tiles={self.tiles}" if self.tiles else ""
        batch = " batched" if self.batch else ""
        return (f"{self.op}[{self.n1}x{self.n2}]{batch} -> {self.path}"
                f"{tiles} ({self.reason})")


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


def plan_route(op: str, n1: int, n2: int, *, device: torch.device,
               batch: bool = False, tile=None,
               kernel: bool = False) -> Route:
    """Pick the execution path for one blas call on ``device``;
    ``batch`` marks a call with leading dims (the same path, one launch
    for the stack)."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}")
    pin = current_pin()
    if pin is not None:
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
