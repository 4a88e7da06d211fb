"""(bm, bk) tile selection for the symmetric kernels (port of the
heuristic half of :mod:`repro.blas.autotune`; the measured ``"auto"``
cache waits).

On the port ``bm`` is the packed tile format the kernels read and write
(any power of two from 8 to 128); ``bk`` is the contraction padding the
reference applies before a rank update.  For a SYMM the second entry is
``bn``, the granule B's columns are padded to: the kernels mask ragged
columns, so B is padded at most to n2 rounded up to 8 (rows stay 32 B
aligned for the copies) and not at all for n2 <= 8, which the
matrix-vector kernel takes as it is."""
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
    if op == "symm":
        return bm, 1 if n2 <= 8 else 8
    return bm, _round_up_tile(n2)
