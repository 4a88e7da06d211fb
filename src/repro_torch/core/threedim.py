"""3D and limited-memory parallel SYRK / SYR2K / SYMM (paper Algs 13–18)
on ``torch.distributed`` (port of :mod:`repro.core.threedim`).

Optimal regime (Thm 9 case 3, large P): a p₁ × p₂ grid with
p₁ = c(c+1); the 2D algorithm runs inside each p₂-slice on n₂/p₂
columns, then the symmetric matrix is reduce-scattered (SYRK / SYR2K)
or all-gathered (SYMM) over the replication axis: eq. (7),
m·n₁n₂/(√p₁·p₂) + n₁²/(2p₁) words.

The limited-memory variants (Algs 16–18, §IX) stream the non-symmetric
columns in chunks of b, the owned ``(off, diag)`` block carried as an
accumulator across the chunks and ONE reduce-scatter after the last:
the live set is one chunk's m·b·n₁/c words plus the owned n₁²/(2p₁),
matching the memory-dependent bound (Cor 6–8) when p₂ = x = 2MP/n₁².
Do not merge it into the unlimited 3D schedule: that discards the
working-set bound the planner chose it for.

``tb`` is the rank's in-slice axis (size p₁), ``rep`` its replication
axis (size p₂): :meth:`~repro_torch.distributed.mesh.Mesh.grid`.
Leading dims ride every payload.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..distributed import collectives
from ..distributed.mesh import Comm
from .twodim import TwoDPlan, symm_2d_local, syr2k_2d_local, syrk_2d_local


def _flatten_tb(off: torch.Tensor, diag: torch.Tensor) -> torch.Tensor:
    lead = tuple(diag.shape[:-2])
    return torch.cat([off.reshape(lead + (-1,)), diag.reshape(lead + (-1,))],
                     -1)


def _unflatten_tb(flat: torch.Tensor, plan: TwoDPlan
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    lead = tuple(flat.shape[:-1])
    t = plan.T * plan.nb * plan.nb
    off = flat[..., :t].reshape(lead + (plan.T, plan.nb, plan.nb))
    diag = flat[..., t:t + plan.nb * plan.nb].reshape(lead + (plan.nb,
                                                             plan.nb))
    return off, diag


def _pad_to(x: torch.Tensor, mult: int) -> torch.Tensor:
    pad = -x.shape[-1] % mult
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


def _scatter_rep(flat: torch.Tensor, p2: int, rep: Comm) -> torch.Tensor:
    """Reduce-scatter (…, F) over the replication axis (padded to a
    multiple of p₂): this rank keeps (…, F_pad/p₂); one collective."""
    flat = _pad_to(flat, p2)
    lead = tuple(flat.shape[:-1])
    s = flat.shape[-1] // p2
    x = flat.reshape((-1, p2, s)).movedim(1, 0).reshape(-1, s)
    return collectives.reduce_scatter(x, rep).reshape(lead + (s,))


def _gather_rep(shard: torch.Tensor, rep: Comm,
                kind: str = "all_gather") -> torch.Tensor:
    """All-gather (…, s) over the replication axis -> (…, p₂·s)."""
    lead = tuple(shard.shape[:-1])
    s = shard.shape[-1]
    full = collectives.all_gather(shard.reshape(1, -1), rep, kind)
    return full.reshape(rep.size, -1, s).movedim(0, 1) \
        .reshape(lead + (rep.size * s,))


def syrk_3d_local(a_own: torch.Tensor, plan: TwoDPlan, tb: Comm, rep: Comm,
                  p2: int) -> torch.Tensor:
    """Alg 13: 2D SYRK in the slice, then the extended triangle block
    reduce-scattered over the replication axis.  a_own (…, c, nb, w₂),
    w₂ = n₂/(p₂(c+1)).  Returns this rank's flat shard of C_Tk."""
    off, diag = syrk_2d_local(a_own, plan, tb)
    return _scatter_rep(_flatten_tb(off, diag), p2, rep)


def syr2k_3d_local(a_own: torch.Tensor, b_own: torch.Tensor, plan: TwoDPlan,
                   tb: Comm, rep: Comm, p2: int) -> torch.Tensor:
    off, diag = syr2k_2d_local(a_own, b_own, plan, tb)
    return _scatter_rep(_flatten_tb(off, diag), p2, rep)


def symm_3d_local(a_flat_shard: torch.Tensor, b_own: torch.Tensor,
                  plan: TwoDPlan, tb: Comm, rep: Comm) -> torch.Tensor:
    """Alg 15: all-gather A_Tk over the replication axis, then 2D SYMM
    in the slice.  a_flat_shard (…, F_pad/p₂); b_own (…, c, nb, w₂)."""
    a_off, a_diag = _unflatten_tb(_gather_rep(a_flat_shard, rep), plan)
    return symm_2d_local(a_off, a_diag, b_own, plan, tb)


# ---- limited-memory variants (Algs 16–18) ---------------------------------
def syrk_3d_limited_local(a_own_chunks: torch.Tensor, plan: TwoDPlan,
                          tb: Comm, rep: Comm, p2: int) -> torch.Tensor:
    """Alg 16: a_own_chunks (nsteps, …, c, nb, bw), b-column chunks; each
    chunk's 2D rank update adds into the owned extended triangle block;
    one reduce-scatter after the last."""
    off = diag = None
    for chunk in a_own_chunks:
        o, d = syrk_2d_local(chunk, plan, tb)
        off, diag = (o, d) if off is None else (off + o, diag + d)
    return _scatter_rep(_flatten_tb(off, diag), p2, rep)


def syr2k_3d_limited_local(a_own_chunks: torch.Tensor,
                           b_own_chunks: torch.Tensor, plan: TwoDPlan,
                           tb: Comm, rep: Comm, p2: int) -> torch.Tensor:
    """Alg 17: Alg 16 with the symmetrised two-sided update."""
    off = diag = None
    for a, b in zip(a_own_chunks, b_own_chunks):
        o, d = syr2k_2d_local(a, b, plan, tb)
        off, diag = (o, d) if off is None else (off + o, diag + d)
    return _scatter_rep(_flatten_tb(off, diag), p2, rep)


def symm_3d_limited_local(a_flat_shard: torch.Tensor,
                          b_own_chunks: torch.Tensor, plan: TwoDPlan,
                          tb: Comm, rep: Comm) -> torch.Tensor:
    """Alg 18: gather A once, stream the B / C chunks."""
    a_off, a_diag = _unflatten_tb(_gather_rep(a_flat_shard, rep), plan)
    return torch.stack([symm_2d_local(a_off, a_diag, chunk, plan, tb)
                        for chunk in b_own_chunks], 0)
