"""1D communication-optimal parallel SYRK / SYR2K / SYMM (paper Algs 7–9)
on ``torch.distributed`` (port of :mod:`repro.core.onedim`).

Optimal regime (Thm 9 case 1): n₁ ≤ m·n₂ and P ≤ m·n₂/√(n₁(n₁−1)).
The non-symmetric matrices are column-distributed and never
communicated; only the symmetric matrix moves, as a packed lower
triangle (n₁(n₁+1)/2 words) through one reduce-scatter (SYRK / SYR2K)
or all-gather (SYMM): (1−1/P)·n₁(n₁+1)/2 words a rank, eq. (4) with its
constant.

Two surfaces per algorithm:
  * ``*_local`` — this rank's body on its own shards (the optimizer's
    path);
  * ``syrk_1d`` … — entry points on the full operands, which every rank
    passes alike: each takes its column shard.

Leading dims (a stack) ride the payload: one collective covers the
stack, as the reference's stacked 1D wire does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..distributed import collectives
from ..distributed.mesh import Comm
from .packing import pack_tril, tril_size, unpack_tril


def _padded_tril_len(n1: int, nshards: int) -> int:
    t = tril_size(n1)
    return -(-t // nshards) * nshards


def _scatter_packed(packed: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Reduce-scatter (…, Lp) packed triangles over the group: this rank
    keeps its (…, Lp/P) slice of the sum; one collective for the stack."""
    P = comm.size
    lead = tuple(packed.shape[:-1])
    s = packed.shape[-1] // P
    x = packed.reshape((-1, P, s)).movedim(1, 0)             # (P, K, s)
    return collectives.reduce_scatter(x.reshape(-1, s), comm) \
        .reshape(lead + (s,))


def gather_packed(shard: torch.Tensor, comm: Comm) -> torch.Tensor:
    """All-gather (…, s) packed slices -> (…, P·s): one collective for
    the stack."""
    P = comm.size
    lead = tuple(shard.shape[:-1])
    s = shard.shape[-1]
    full = collectives.all_gather(shard.reshape(1, -1), comm)  # (P, K·s)
    return full.reshape(P, -1, s).movedim(0, 1).reshape(lead + (P * s,))


def _pad_packed(packed: torch.Tensor, n1: int, nshards: int) -> torch.Tensor:
    pad = _padded_tril_len(n1, nshards) - packed.shape[-1]
    return torch.nn.functional.pad(packed, (0, pad)) if pad else packed


# --------------------------------------------------------------------------
# per-shard bodies
# --------------------------------------------------------------------------
def syrk_1d_local(a_loc: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Alg 7 on this rank: ``a_loc`` (…, n1, n2/P) column shard ->
    this rank's slice of the packed lower triangle of A·Aᵀ (padded to a
    multiple of P)."""
    n1 = a_loc.shape[-2]
    packed = _pad_packed(pack_tril(a_loc @ a_loc.mT), n1, comm.size)
    return _scatter_packed(packed, comm)


def syr2k_1d_local(a_loc: torch.Tensor, b_loc: torch.Tensor,
                   comm: Comm) -> torch.Tensor:
    """Alg 8: packed slice of A·Bᵀ + B·Aᵀ."""
    n1 = a_loc.shape[-2]
    g = a_loc @ b_loc.mT
    packed = _pad_packed(pack_tril(g + g.mT), n1, comm.size)
    return _scatter_packed(packed, comm)


def symm_1d_local(a_packed_loc: torch.Tensor, b_loc: torch.Tensor,
                  comm: Comm, n1: int) -> torch.Tensor:
    """Alg 9: all-gather the packed triangle of symmetric A from this
    rank's slice ``a_packed_loc`` (…, Lp/P), unpack it and multiply this
    rank's column shard ``b_loc`` (…, n1, n2/P)."""
    packed = gather_packed(a_packed_loc, comm)[..., :tril_size(n1)]
    return unpack_tril(packed, n1, diag=True, symmetric=True) @ b_loc


# --------------------------------------------------------------------------
# full-array entry points
# --------------------------------------------------------------------------
def column_shard(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """This rank's columns of (…, n1, n2), n2 % P == 0."""
    n2 = x.shape[-1]
    if n2 % comm.size:
        raise ValueError(f"n2={n2} does not split over {comm.size} ranks")
    w = n2 // comm.size
    return x[..., comm.index * w:(comm.index + 1) * w]


def gather_columns(x_loc: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Every rank's column shard (…, n1, n2/P) -> (…, n1, n2) on every
    rank: the inverse of :func:`column_shard`, one all-gather counted as
    the result's replication (``collectives.REPLICATE``), not as the
    schedule's wire."""
    parts = collectives.all_gather(x_loc[None], comm,
                                   kind=collectives.REPLICATE)
    return torch.cat(list(parts), dim=-1)


def syrk_1d(A: torch.Tensor, mesh, axis: str = "x") -> torch.Tensor:
    """C = A·Aᵀ with A column-split over ``axis``; returns this rank's
    slice of the padded packed lower triangle."""
    comm = mesh.comm(axis)
    return syrk_1d_local(column_shard(A, comm), comm)


def syr2k_1d(A: torch.Tensor, B: torch.Tensor, mesh,
             axis: str = "x") -> torch.Tensor:
    comm = mesh.comm(axis)
    return syr2k_1d_local(column_shard(A, comm), column_shard(B, comm), comm)


def symm_1d(A_packed: torch.Tensor, B: torch.Tensor, n1: int, mesh,
            axis: str = "x") -> torch.Tensor:
    """C = A·B with A the padded packed lower triangle (every rank takes
    its slice) and B column-split; returns this rank's C columns."""
    comm = mesh.comm(axis)
    s = A_packed.shape[-1] // comm.size
    loc = A_packed[..., comm.index * s:(comm.index + 1) * s]
    return symm_1d_local(loc, column_shard(B, comm), comm, n1)


# --------------------------------------------------------------------------
# host-side helpers for tests / data prep
# --------------------------------------------------------------------------
def pack_for_1d_symm(A_full: np.ndarray, n_shards: int) -> np.ndarray:
    """A full symmetric matrix in the padded packed-triangle layout
    :func:`symm_1d` takes."""
    n1 = A_full.shape[0]
    i, j = np.tril_indices(n1)
    packed = np.asarray(A_full)[i, j]
    pad = _padded_tril_len(n1, n_shards) - packed.shape[0]
    return np.pad(packed, (0, pad))
