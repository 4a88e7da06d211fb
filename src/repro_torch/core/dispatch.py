"""Algorithm + processor-grid selection (paper §VIII-D, §IX).

Given (n₁, n₂, P, m [, M]) returns which family (1D / 2D / 3D /
3D-limited-memory) is communication-optimal and its grid parameters,
mirroring the case analysis of Theorem 9:

  case 1 (n₁ ≤ m·n₂, small P)  -> 1D,  words ≈ n₁²/2
  case 2 (m·n₂ < n₁, small P)  -> 2D,  words ≈ m·n₁n₂/√P
  case 3 (large P)             -> 3D,  words ≈ (3m/2)·(n₁²n₂/(√m·P))^{2/3}
  memory-constrained           -> 3D-limited, words ≈ m·n₁n₂/√(P·M̃)

This module is what the training-framework integration calls: the Muon/Gram
optimizer asks for the right SYRK/SYMM algorithm for each parameter's
(n₁, n₂) and the mesh size — the paper's regime analysis driving a real
systems decision.

A copy of :mod:`repro.core.dispatch` for the port: same names,
same results;
the memory probe reads the card through torch.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Optional, Union

from .lower_bounds import mem_independent_case, memory_independent_lower_bound

#: env override for the per-device memory budget, in f32 WORDS (not
#: bytes).  Takes precedence over the device-HBM probe; "0"/"" disables
#: the budget entirely (plans stay memory-unconstrained).
MEMORY_BUDGET_ENV = "REPRO_BLAS_MEMORY_WORDS"

#: fraction of the probed HBM byte limit the planner may budget —
#: operands, XLA scratch, and the framework's own buffers share the
#: device, so the streamed working set must not claim all of it
_HBM_BUDGET_FRACTION = 0.8


def device_memory_budget(device=None) -> Optional[int]:
    """Per-device memory budget in f32 words, or None when unknown.

    Resolution order: the :data:`MEMORY_BUDGET_ENV` env var (words; 0 or
    empty disables), else the card's total memory as
    ``torch.cuda.mem_get_info`` reports it, scaled by
    :data:`_HBM_BUDGET_FRACTION`.  ``device`` is a torch device (default:
    the current CUDA device); a CPU device, or no card at all, gives
    None, so CPU route plans stay as memory-unconstrained as the
    reference's on its CPU devices.
    """
    env = os.environ.get(MEMORY_BUDGET_ENV)
    if env is not None:
        env = env.strip()
        if not env:
            return None
        try:
            words = int(float(env))
        except ValueError as e:
            raise ValueError(f"{MEMORY_BUDGET_ENV}={env!r} is not a "
                             "number of f32 words") from e
        return words if words > 0 else None
    import torch
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    _, total = torch.cuda.mem_get_info(device)
    if not total:
        return None
    return int(total * _HBM_BUDGET_FRACTION) // 4


def resolve_memory_budget(M: Union[str, int, None] = "auto"
                          ) -> Optional[int]:
    """Normalize a user-facing ``M`` argument to words-or-None.

    ``"auto"`` (the API default) probes via :func:`device_memory_budget`;
    ``None`` explicitly disables the budget; an int is used as-is.
    """
    if isinstance(M, str):
        if M != "auto":
            raise ValueError(f"M must be 'auto', None, or an int budget "
                             f"in f32 words, got {M!r}")
        return device_memory_budget()
    return M


@dataclass
class AlgoChoice:
    kind: str            # "1d" | "2d" | "3d" | "3d-limited" | "ring"
    case: int            # Thm 9 case
    P: int
    c: int = 0           # 2D/3D triangle-block grid parameter (p1 = c(c+1))
    p1: int = 0
    p2: int = 0
    b: int = 0           # column chunk for limited-memory
    idle: int = 0        # devices left idle by the c(c+1) embedding
    predicted_words: float = 0.0
    lower_bound: float = 0.0

    @property
    def optimality_ratio(self) -> float:
        return self.predicted_words / max(self.lower_bound, 1e-30)


def largest_c_grid(P: int) -> int:
    """Largest c with c(c+1) <= P.

    Note the return value is clamped to >= 1, so for P < 2 the implied
    grid p1 = c(c+1) = 2 does NOT fit; callers that need a feasible grid
    should use :func:`fit_c_grid`.
    """
    c = int((math.isqrt(4 * P + 1) - 1) // 2)
    while (c + 1) * (c + 2) <= P:
        c += 1
    while c > 1 and c * (c + 1) > P:
        c -= 1
    return max(c, 1)


def fit_c_grid(P: int) -> int:
    """Largest c with c(c+1) <= P, or 0 when no triangle grid fits
    (P < 2)."""
    if P < 2:
        return 0
    return largest_c_grid(P)


#: ring-route planning gate: the per-device row block must be at least
#: this tall before the rank-update dots amortize the slot bookkeeping
#: (tiny blocks are wire-bound and the word-minimal families win)
_RING_MIN_BLOCK = 32

#: flops/words balance: the job counts as computation-bound — and the
#: flop-halving ring route is planned — when the per-device dot flops
#: (~2·n1²·n2/P) exceed _RING_BALANCE × the 1d wire words (~n1²/2),
#: i.e. n2 >= (_RING_BALANCE/4)·P
_RING_BALANCE = 128.0


def ring_nb(n1: int, P: int) -> int:
    """Ring row-block height: ceil(n1/P), rounded up to even when P is
    even so the final antipodal shift splits into exact halves."""
    nb = -(-n1 // P)
    if P % 2 == 0 and nb % 2:
        nb += 1
    return nb


def ring_working_set(n1: int, n2: int, P: int, m: int) -> float:
    """Per-device resident words of the ring route: the owned operand
    row block(s) plus one circulating buffer copy, plus the S+1
    extended-triangle output slots."""
    nb = ring_nb(n1, P)
    return m * 2 * nb * n2 + (P // 2 + 1) * nb * nb


def predicted_words_1d(n1: int, P: int) -> float:
    return (1 - 1 / P) * n1 * (n1 + 1) / 2


def predicted_words_2d(n1: int, n2: int, m: int, c: int) -> float:
    P = c * (c + 1)
    return m * n1 * n2 / c * (1 - 1 / P)


def predicted_words_3d(n1: int, n2: int, m: int, c: int, p2: int) -> float:
    p1 = c * (c + 1)
    return m * n1 * n2 / (c * p2) + n1 * n1 / (2 * p1)


def choose_algorithm(n1: int, n2: int, P: int, m: int,
                     M: Optional[int] = None) -> AlgoChoice:
    """Select the communication-optimal family + grid for the problem.

    Invariants (any P >= 1): the returned grid satisfies
    ``p1 * p2 <= P`` and ``idle >= 0``; when no c(c+1) triangle grid fits
    (P < 2) the 1D algorithm is returned regardless of regime.
    """
    case = mem_independent_case(n1, n2, P, m)
    lb = memory_independent_lower_bound(n1, n2, P, m).bound

    # computation-bound regime: the cyclic-shift ring route computes
    # only the unique half of the symmetric interactions —
    # ~⌈(P+1)/2⌉/P of the 2d route's per-device flops — at 1d-level
    # collective volume (⌊P/2⌋ shifts of the nb×n2 slice).  It wins
    # when the dot work, not the wire, is the bottleneck; word-minimal
    # families keep the wire-bound regimes.  Case 1 is excluded: there
    # the column-split 1d algorithm already touches each symmetric
    # interaction exactly once (flop-optimal) while moving only C.
    # M budgets are respected: if the circulating working set does not
    # fit, fall through to the streamed §IX planning below.
    nb_ring = ring_nb(n1, P)
    if (P >= 2 and case != 1 and nb_ring >= _RING_MIN_BLOCK
            and n2 >= (_RING_BALANCE / 4) * P
            and (M is None or ring_working_set(n1, n2, P, m) <= M)):
        return AlgoChoice(
            kind="ring", case=case, P=P, c=0, p1=P, p2=1, idle=0,
            predicted_words=m * (P // 2) * nb_ring * n2, lower_bound=lb)

    # memory feasibility of the unconstrained 3D/2D algorithm (§IX trigger)
    def mem_3d(c: int, p2: int) -> float:
        p1 = c * (c + 1)
        return m * n1 * n2 / (max(c, 1) * p2) + n1 * n1 / (2 * p1)

    def one_d(case_: int) -> AlgoChoice:
        return AlgoChoice(kind="1d", case=case_, P=P, p1=1, p2=P,
                          predicted_words=predicted_words_1d(n1, P),
                          lower_bound=lb)

    if case == 1:
        choice = one_d(1)
    elif case == 2:
        c = fit_c_grid(P)
        if c == 0:
            choice = one_d(2)
        else:
            choice = AlgoChoice(
                kind="2d", case=2, P=P, c=c, p1=c * (c + 1), p2=1,
                idle=P - c * (c + 1),
                predicted_words=predicted_words_2d(n1, n2, m, c),
                lower_bound=lb)
    else:
        # optimal split (§VIII-D case 3): p1 = (n1 P / (m n2))^(2/3),
        # capped at P so the grid always embeds
        p1_target = (n1 * P / (m * n2)) ** (2 / 3)
        c = fit_c_grid(min(max(int(p1_target), 2), P))
        if c == 0:
            choice = one_d(3)
        else:
            p1 = c * (c + 1)
            p2 = max(P // p1, 1)
            choice = AlgoChoice(
                kind="3d", case=3, P=P, c=c, p1=p1, p2=p2,
                idle=P - p1 * p2,
                predicted_words=predicted_words_3d(n1, n2, m, c, p2),
                lower_bound=lb)

    if M is not None and choice.kind in ("2d", "3d"):
        c = choice.c
        if mem_3d(c, max(choice.p2, 1)) > M:
            # §IX: keep x·n1²/(2P) resident, stream b columns at a time
            x = max(2.0 * M * P / (n1 * n1), 1.0)
            p2 = min(max(int(x), 1), P // 2)   # leave room for p1 >= 2
            p1_budget = max(P // p2, 2)
            c = largest_c_grid(p1_budget)      # p1_budget >= 2 -> fits
            p1 = c * (c + 1)
            p2 = max(P // p1, 1)
            # chunk so the streamed panel m·b·n1/c stays within M/2
            b = max(int((M / 2) * c / (m * n1)), 1)
            words = m * n1 * n2 / (c * p2) + n1 * n1 / (2 * p1)
            choice = AlgoChoice(kind="3d-limited", case=choice.case, P=P, c=c,
                                p1=p1, p2=p2, b=b, idle=P - p1 * p2,
                                predicted_words=words, lower_bound=lb)

    if choice.kind != "1d":
        assert choice.p1 * choice.p2 <= P and choice.idle >= 0, choice
    return choice
