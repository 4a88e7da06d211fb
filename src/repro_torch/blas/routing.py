"""Route planning for :mod:`repro_torch.blas` (port of the single-device
half of :mod:`repro.blas.routing`; the mesh routes wait).

  single device:  kernel (CUDA tensor and n1 >= KERNEL_MIN_N1, or an
                  explicit request)  ->  dense (torch.matmul, IEEE f32)

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


_CTX = threading.local()


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


def plan_route(op: str, n1: int, n2: int, *, device: torch.device,
               tile=None, kernel: bool = False) -> Route:
    """Pick the execution path for one blas call on ``device``."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}")
    explicit = tile is not None or kernel
    on_cuda = torch.device(device).type == "cuda"
    if explicit or (on_cuda and n1 >= KERNEL_MIN_N1):
        if tile is None:
            tiles = heuristic_tiles(op, n1, n2)
        elif isinstance(tile, tuple) and len(tile) == 2:
            tiles = (int(tile[0]), int(tile[1]))
        else:
            raise ValueError(f"tile must be a (bm, bk) pair, got {tile!r}")
        why = "explicit tile/kernel request" if explicit else \
            "triangular flat-grid kernel on cuda"
        return _emit(Route(op, "kernel", why, n1, n2, tiles=tiles))
    return _emit(Route(op, "dense", "small shape or no kernel device "
                       f"({torch.device(device).type}); dense matmul",
                       n1, n2))
