"""Closed-form communication lower bounds from the paper (§IV–V).

All formulas return *words* (matrix elements).  ``m`` is the number of
non-symmetric matrices: SYRK m=1, SYR2K m=2, SYMM m=2.

A copy of :mod:`repro.core.lower_bounds` for the port: same names,
same results.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

M_SYRK, M_SYR2K, M_SYMM = 1, 2, 2


def sequential_reads_lower_bound(n1: int, n2: int, M: int, m: int) -> float:
    """Theorem 2: reads ≥ (m/√2)·n1(n1−1)n2 / √M − 2M."""
    return m / math.sqrt(2.0) * n1 * (n1 - 1) * n2 / math.sqrt(M) - 2 * M


def memory_dependent_parallel_lower_bound(n1: int, n2: int, P: int, M: int,
                                          m: int) -> float:
    """Corollaries 6–8: per-processor receives ≥ (m/√2)·n1(n1−1)n2/(P√M) − 2M."""
    return m / math.sqrt(2.0) * n1 * (n1 - 1) * n2 / (P * math.sqrt(M)) - 2 * M


@dataclass
class MemIndependentBound:
    """Theorem 9 / Cor 10–12 decomposition."""
    case: int          # 1, 2, or 3 (paper's case numbering)
    W: float           # accessed-words term
    owned: float       # subtracted owned-data term
    bound: float       # W - owned (communicated words, >= 0 clipped)


def mem_independent_case(n1: int, n2: int, P: int, m: int) -> int:
    """Regime selection of Theorem 9 (also drives algorithm choice §VIII-D)."""
    nn = n1 * (n1 - 1)
    if nn == 0:          # n1 == 1: no symmetric interactions, 1D trivially
        return 1
    if n1 <= m * n2 and P <= m * n2 / math.sqrt(nn):
        return 1
    if m * n2 < n1 and P <= nn / (m * n2) ** 2:
        return 2
    return 3


def memory_independent_lower_bound(n1: int, n2: int, P: int, m: int
                                   ) -> MemIndependentBound:
    """Theorem 9: communicated words ≥ W − (n1(n1−1)/2 + m·n1·n2)/P."""
    nn = n1 * (n1 - 1)
    case = mem_independent_case(n1, n2, P, m)
    if case == 1:
        W = m * n2 * math.sqrt(nn) / P + nn / 2.0
    elif case == 2:
        W = m * n2 * math.sqrt(nn / P) + nn / (2.0 * P)
    else:
        W = 1.5 * m * (nn * n2 / (math.sqrt(m) * P)) ** (2.0 / 3.0)
    owned = (nn / 2.0 + m * n1 * n2) / P
    return MemIndependentBound(case=case, W=W, owned=owned,
                               bound=max(W - owned, 0.0))


# ---------------------------------------------------------------------------
# Matching algorithm costs (leading-order) for optimality-ratio reporting
# ---------------------------------------------------------------------------
def seq_algorithm_reads(n1: int, n2: int, M: int, m: int) -> float:
    """Leading-order reads of Algs 4–6 (§VII-B2):
    m·n1(n1−1)n2/(r−1) + n1(n1−1)/2 + K  with r = ⌊√(2M+m²)−m⌋."""
    r = int(math.isqrt(2 * M + m * m)) - m
    r = max(r, 2)
    K = n1 * (n1 - 1) / (r * (r - 1))
    return m * n1 * (n1 - 1) * n2 / (r - 1) + n1 * (n1 - 1) / 2.0 + K


def parallel_1d_words(n1: int, P: int) -> float:
    """Eq. (4): (1−1/P)·n1(n1+1)/2 (symmetric matrix via RS or AG)."""
    return (1 - 1 / P) * n1 * (n1 + 1) / 2.0


def parallel_2d_words(n1: int, n2: int, P: int, m: int, c: int) -> float:
    """Eq. (6): m·(n1·n2/c)·(1−1/P) with P = c(c+1)."""
    assert P == c * (c + 1)
    return m * n1 * n2 / c * (1 - 1 / P)


def parallel_3d_words(n1: int, n2: int, m: int, c: int, p2: int) -> float:
    """Eq. (7) leading order: m·n1n2/(√p1·p2) + n1²/(2p1), p1=c(c+1)≈c²."""
    p1 = c * (c + 1)
    return m * n1 * n2 / (c * p2) + n1 * n1 / (2.0 * p1)
