"""(bm, bk) tile selection for the symmetric kernels (port of the
heuristic half of :mod:`repro.blas.autotune`; the measured ``"auto"``
cache waits).

On the port ``bm`` is the packed tile format the kernels read and write
(any power of two from 8 to 128); ``bk`` is the contraction padding the
reference applies before a rank update, and the column padding of B
before a SYMM (``bn``)."""
from __future__ import annotations

from typing import Tuple

Tiles = Tuple[int, int]


def _round_up_tile(n: int, cap: int = 128, floor: int = 8) -> int:
    """Smallest power of two >= n (>= floor), capped at ``cap``."""
    t = floor
    while t < n and t < cap:
        t *= 2
    return min(t, cap)


def heuristic_tiles(op: str, n1: int, n2: int) -> Tiles:
    """Full 128 tiles for big problems, shrink-to-fit powers of two for
    small ones."""
    bm = _round_up_tile(n1)
    bk = _round_up_tile(n2 if op != "symm" else max(n2, n1))
    return bm, bk
