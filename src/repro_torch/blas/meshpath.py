"""The mesh execution paths of :mod:`repro_torch.blas` (port of
:mod:`repro.blas.meshpath`).

The core schedules (``core/{onedim,twodim,threedim,ringpath}.py``) work
on each rank's own shards.  The blas surface takes whole operands, which
every rank of the mesh passes alike (SPMD, as a ``shard_map`` body sees
the reference's replicated operands), so this module adds the staging
around them: each rank cuts its own shards out of the operands (no
communication), runs the schedule, and the result is replicated on every
rank by one all-gather of the owned pieces, except on the
``*_sharded`` exits.  The schedules send what the reference's
``shard_map`` bodies send; the replicating all-gathers (which the
reference leaves to its caller, outside the body) are counted apart, as
``collectives.REPLICATE``:

  1D   — column shards of the non-symmetric operands; only the packed
         triangle moves (Algs 7–9);
  ring — row blocks travel ⌊P/2⌋ cyclic shifts (S + 1 for SYMM);
  2D   — the triangle-block layout on exactly P = c(c+1) ranks
         (Algs 10–12);
  3D   — a p1 × p2 grid of the axis (2D in each slice plus the
         replication axis, Algs 13–15), and its streamed §IX variant
         (Algs 16–18).

Packed wire: the symmetric operand or result crosses every boundary
here packed, as the element-packed triangle (1d, ring) or as
:class:`~repro_torch.core.packing.ShardedTriTiles` shards (2d / 3d);
SYMM builds its shards of a packed A by gathers on the rank itself.
Nothing here builds an n₁ × n₁ dense array but the 1D SYMM body's own
local unpack of the gathered triangle, as in the reference.  Leading
batch dims ride every payload: one collective (pair) covers a stack.
All functions take and return f32; :mod:`repro_torch.blas.api` handles
fill and dtype.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core import onedim, ringpath, threedim
from ..core.dispatch import ring_nb
from ..core.packing import (ShardedTriTiles, pack_tril, packed_to_device_shard,
                            tril_size)
from ..core.twodim import (TwoDPlan, make_2d_plan, symm_2d_local,
                           syr2k_2d_local, syrk_2d_local, tb_flat_words)
from ..distributed import collectives


# --------------------------------------------------------------------------
# staging of the non-symmetric operands
# --------------------------------------------------------------------------
def own_rows(x: torch.Tensor, plan: TwoDPlan, k: int) -> torch.Tensor:
    """(…, n1, n2) -> device k's row-block column shares (…, c, nb, w)
    (zero-padded to the plan's n1_pad × n2_pad)."""
    c, nb, w = plan.c, plan.nb, plan.w
    xp = torch.nn.functional.pad(
        x, (0, plan.n2_pad - x.shape[-1], 0, plan.n1_pad - x.shape[-2]))
    blocks = xp.reshape(x.shape[:-2] + (c * c, nb, plan.n2_pad))
    rows = blocks[..., torch.as_tensor(plan.R[k]), :, :]     # (…, c, nb, n2p)
    col = torch.as_tensor(plan.self_col[k][:, None] * w + np.arange(w),
                          device=x.device)                     # (c, w)
    idx = col[:, None, :].expand(rows.shape[:-1] + (w,))
    return torch.gather(rows, -1, idx)


def collect_rows(dist: torch.Tensor, plan: TwoDPlan) -> torch.Tensor:
    """Every device's shares (P, …, c, nb, w) -> (…, n1, n2) (unpadded):
    the inverse of :func:`own_rows` over all k."""
    c, nb, w = plan.c, plan.nb, plan.w
    Pn = plan.num_devices
    lead = tuple(dist.shape[1:-3])
    out = dist.new_zeros(lead + (c * c, nb, plan.n2_pad))
    for k in range(Pn):
        for s in range(c):
            col = int(plan.self_col[k, s]) * w
            out[..., int(plan.R[k][s]), :, col:col + w] = dist[k, ..., s, :, :]
    out = out.reshape(lead + (plan.n1_pad, plan.n2_pad))
    return out[..., :plan.n1, :plan.n2]


def _gather_axis(x: torch.Tensor, comm) -> torch.Tensor:
    """All-gather this rank's piece (…) -> (P, …) over the axis: the
    replication of a sharded result."""
    return collectives.all_gather(x.reshape((1,) + tuple(x.shape)), comm,
                                  kind=collectives.REPLICATE)


def _col_slice(x: torch.Tensor, p2: int, j: int) -> torch.Tensor:
    n2 = x.shape[-1]
    if n2 % p2:
        raise ValueError(f"n2={n2} does not split over p2={p2}")
    s = n2 // p2
    return x[..., j * s:(j + 1) * s]


def _grid(mesh, axis: str, c: int, p2: int):
    return mesh.grid(axis, c * (c + 1), p2)


def _local_shard(st: ShardedTriTiles, c: int, mesh, axis: str
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's (off, diag) of a symmetric operand on the c-grid of
    ``axis``: a local layout on the same grid as it is, a global one by
    its index, any other grid through the packed triangle."""
    P, p1 = mesh.shape[axis], c * (c + 1)
    k = mesh.index(axis) // (P // p1)
    if st.c == c and st.local and st.mesh is mesh and st.axis == axis:
        return st.off, st.diag
    if st.c == c and not st.local:
        return st.off[..., k, :, :, :], st.diag[..., k, :, :]
    return packed_to_device_shard(st.to_packed(), st.n, c, k)


# --------------------------------------------------------------------------
# 1D paths (Algs 7–9): the packed triangle on the wire
# --------------------------------------------------------------------------
def syrk_1d_packed(a: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """(…, n1, n2), n2 % P == 0 -> the packed tril of A·Aᵀ (…, L) on
    every rank: one reduce-scatter (Alg 7) and one all-gather of the
    packed slices."""
    comm = mesh.comm(axis)
    n1 = a.shape[-2]
    shard = onedim.syrk_1d_local(onedim.column_shard(a, comm), comm)
    return onedim.gather_packed(shard, comm)[..., :tril_size(n1)]


def syr2k_1d_packed(a: torch.Tensor, b: torch.Tensor, mesh,
                    axis: str) -> torch.Tensor:
    comm = mesh.comm(axis)
    n1 = a.shape[-2]
    shard = onedim.syr2k_1d_local(onedim.column_shard(a, comm),
                                  onedim.column_shard(b, comm), comm)
    return onedim.gather_packed(shard, comm)[..., :tril_size(n1)]


def symm_1d_packed_a(a_packed: torch.Tensor, b: torch.Tensor, n1: int,
                     mesh, axis: str) -> torch.Tensor:
    """Packed tril (…, L) × (…, n1, n2), n2 % P == 0 -> (…, n1, n2): each
    rank takes its slice of the padded triangle, Alg 9 all-gathers it,
    and the C column shards are all-gathered back (the replication)."""
    comm = mesh.comm(axis)
    P = comm.size
    packed = onedim._pad_packed(a_packed, n1, P)
    s = packed.shape[-1] // P
    loc = packed[..., comm.index * s:(comm.index + 1) * s]
    c_loc = onedim.symm_1d_local(loc, onedim.column_shard(b, comm), comm, n1)
    return onedim.gather_columns(c_loc, comm)


# --------------------------------------------------------------------------
# ring path: computation-optimal cyclic shift (flop-halving SYRK / SYR2K)
# --------------------------------------------------------------------------
def ring_block(x: torch.Tensor, P: int, r: int) -> torch.Tensor:
    """Rank r's zero-padded row block (…, nb, n2) of (…, n1, n2)."""
    nb = ring_nb(x.shape[-2], P)
    blk = x[..., r * nb:(r + 1) * nb, :]
    pad = nb - blk.shape[-2]
    return torch.nn.functional.pad(blk, (0, 0, 0, pad)) if pad else blk


def _ring_unblock(blocks: torch.Tensor, n1: int) -> torch.Tensor:
    """(P, …, nb, n2) -> (…, n1, n2)."""
    return torch.cat(list(blocks), dim=-2)[..., :n1, :]


def syrk_ring_packed(a: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """(…, n1, n2) -> the packed tril of A·Aᵀ (…, L) on every rank:
    ⌊P/2⌋ shifts of the nb × n2 block, each rank computing only the
    blocks it owns, then one all-gather of the slot stacks."""
    comm = mesh.comm(axis)
    slots = ringpath.syrk_ring(ring_block(a, comm.size, comm.index),
                                     comm)
    return ringpath.ring_stack_to_packed(_gather_axis(slots, comm),
                                         a.shape[-2])


def syr2k_ring_packed(a: torch.Tensor, b: torch.Tensor, mesh,
                      axis: str) -> torch.Tensor:
    comm = mesh.comm(axis)
    P, r = comm.size, comm.index
    slots = ringpath.syr2k_ring(ring_block(a, P, r),
                                      ring_block(b, P, r), comm)
    return ringpath.ring_stack_to_packed(_gather_axis(slots, comm),
                                         a.shape[-2])


def symm_ring_packed_a(a_packed: torch.Tensor, b: torch.Tensor, n1: int,
                       mesh, axis: str) -> torch.Tensor:
    """Packed tril (…, L) × (…, n1, n2) -> (…, n1, n2): each rank gathers
    its ring slots from the packed triangle, B travels the ring, and the
    C row blocks are all-gathered back."""
    comm = mesh.comm(axis)
    P, r = comm.size, comm.index
    slots = ringpath.packed_to_ring_local(a_packed, n1, P, r)
    c_blk = ringpath.symm_ring(slots, ring_block(b, P, r), comm)
    return _ring_unblock(_gather_axis(c_blk, comm), n1)


# --------------------------------------------------------------------------
# 2D paths (Algs 10–12): P == c(c+1) triangle-block grid, packed wire
# --------------------------------------------------------------------------
def syrk_2d_sharded(a: torch.Tensor, c: int, mesh,
                    axis: str) -> ShardedTriTiles:
    """(…, n1, n2) -> this rank's extended triangle block of tril(A·Aᵀ),
    as a local ShardedTriTiles (no gather; ``.to_packed()`` gathers the
    ~n²/2 packed words)."""
    n1, n2 = a.shape[-2:]
    plan = make_2d_plan(c, n1, n2)
    comm = mesh.comm(axis)
    off, diag = syrk_2d_local(own_rows(a, plan, comm.index), plan, comm)
    return ShardedTriTiles(off, diag, n1, c, mesh, axis)


def syr2k_2d_sharded(a: torch.Tensor, b: torch.Tensor, c: int, mesh,
                     axis: str) -> ShardedTriTiles:
    n1, n2 = a.shape[-2:]
    plan = make_2d_plan(c, n1, n2)
    comm = mesh.comm(axis)
    k = comm.index
    off, diag = syr2k_2d_local(own_rows(a, plan, k), own_rows(b, plan, k),
                               plan, comm)
    return ShardedTriTiles(off, diag, n1, c, mesh, axis)


def symm_2d_sharded_a(st: ShardedTriTiles, b: torch.Tensor, c: int, mesh,
                      axis: str) -> torch.Tensor:
    """SYMM whose symmetric operand is a ShardedTriTiles: a local one on
    this grid is used in place (no distribute step for A)."""
    n1, n2 = st.n, b.shape[-1]
    plan = make_2d_plan(c, n1, n2)
    comm = mesh.comm(axis)
    a_off, a_diag = _local_shard(st, c, mesh, axis)
    c_own = symm_2d_local(a_off, a_diag, own_rows(b, plan, comm.index),
                          plan, comm)
    return collect_rows(_gather_axis(c_own, comm), plan)


def symm_2d_packed_a(a_packed: torch.Tensor, b: torch.Tensor, c: int, mesh,
                     axis: str) -> torch.Tensor:
    """Packed tril (…, L) × (…, n1, n2) -> (…, n1, n2): this rank's
    extended triangle block is gathered from the packed triangle by rows
    (:func:`packed_to_device_shard`), B's shares cut on the rank."""
    n1 = b.shape[-2]
    st = ShardedTriTiles.from_packed(a_packed, n1, c, mesh, axis)
    return symm_2d_sharded_a(st, b, c, mesh, axis)


# --------------------------------------------------------------------------
# 3D paths (Algs 13–15): a p1 × p2 grid of the axis, packed wire
# --------------------------------------------------------------------------
def _flat_shard(off, diag, plan: TwoDPlan, p2: int, j: int) -> torch.Tensor:
    """Piece j of p2 of the flattened (padded) extended triangle block:
    the 1/p2 of A_Tk this rank holds for Alg 15."""
    flat = threedim._pad_to(threedim._flatten_tb(off, diag), p2)
    s = flat.shape[-1] // p2
    return flat[..., j * s:(j + 1) * s]


def _sharded_from_rep(shard: torch.Tensor, plan: TwoDPlan, n1: int, c: int,
                      rep, mesh, axis: str) -> ShardedTriTiles:
    """Reduce-scattered 3D output (…, F_pad/p2) -> the slice's extended
    triangle block on each of its p2 ranks (one all-gather over the
    replication axis)."""
    flat = threedim._gather_rep(shard, rep, collectives.REPLICATE)[
        ..., :tb_flat_words(c, n1)]
    off, diag = threedim._unflatten_tb(flat, plan)
    return ShardedTriTiles(off, diag, n1, c, mesh, axis)


def syrk_3d_sharded(a: torch.Tensor, c: int, p2: int, mesh,
                    axis: str) -> ShardedTriTiles:
    n1, n2 = a.shape[-2:]
    plan = make_2d_plan(c, n1, n2 // p2)
    tb, rep = _grid(mesh, axis, c, p2)
    a_own = own_rows(_col_slice(a, p2, rep.index), plan, tb.index)
    shard = threedim.syrk_3d_local(a_own, plan, tb, rep, p2)
    return _sharded_from_rep(shard, plan, n1, c, rep, mesh, axis)


def syr2k_3d_sharded(a: torch.Tensor, b: torch.Tensor, c: int, p2: int,
                     mesh, axis: str) -> ShardedTriTiles:
    n1, n2 = a.shape[-2:]
    plan = make_2d_plan(c, n1, n2 // p2)
    tb, rep = _grid(mesh, axis, c, p2)
    i, j = tb.index, rep.index
    shard = threedim.syr2k_3d_local(own_rows(_col_slice(a, p2, j), plan, i),
                                    own_rows(_col_slice(b, p2, j), plan, i),
                                    plan, tb, rep, p2)
    return _sharded_from_rep(shard, plan, n1, c, rep, mesh, axis)


def _collect_3d(c_own: torch.Tensor, plan: TwoDPlan, mesh, axis: str,
                p2: int) -> torch.Tensor:
    """This rank's C shares (…, c, nb, w2) -> (…, n1, n2) on every rank:
    one all-gather over the whole axis, then each slice's rows."""
    allc = _gather_axis(c_own, mesh.comm(axis))             # (P, …)
    p1 = allc.shape[0] // p2
    allc = allc.reshape((p1, p2) + tuple(allc.shape[1:]))
    return torch.cat([collect_rows(allc[:, j], plan) for j in range(p2)],
                     dim=-1)


def symm_3d_sharded_a(st: ShardedTriTiles, b: torch.Tensor, c: int, p2: int,
                      mesh, axis: str) -> torch.Tensor:
    """Alg 15: the slice's 1/p2 piece of A_Tk is all-gathered over the
    replication axis, then 2D SYMM in the slice."""
    n1, n2 = st.n, b.shape[-1]
    plan = make_2d_plan(c, n1, n2 // p2)
    tb, rep = _grid(mesh, axis, c, p2)
    a_off, a_diag = _local_shard(st, c, mesh, axis)
    c_own = threedim.symm_3d_local(
        _flat_shard(a_off, a_diag, plan, p2, rep.index),
        own_rows(_col_slice(b, p2, rep.index), plan, tb.index), plan, tb, rep)
    return _collect_3d(c_own, plan, mesh, axis, p2)


def symm_3d_packed_a(a_packed: torch.Tensor, b: torch.Tensor, c: int,
                     p2: int, mesh, axis: str) -> torch.Tensor:
    st = ShardedTriTiles.from_packed(a_packed, b.shape[-2], c, mesh, axis)
    return symm_3d_sharded_a(st, b, c, p2, mesh, axis)


# --------------------------------------------------------------------------
# 3D limited-memory paths (Algs 16–18, §IX): streamed b-column chunks
# --------------------------------------------------------------------------
def limited_steps(n2: int, p2: int, b: int) -> Tuple[int, int]:
    """Clamp the chunk to the slice's column count; (b, nsteps) with
    nsteps·b >= n2/p2 (the tail chunk zero-padded: padded columns add
    nothing to a rank update and padded SYMM columns are trimmed)."""
    n2s = max(n2 // p2, 1)
    b = max(min(b, n2s), 1)
    return b, -(-n2s // b)


def _own_chunks(x: torch.Tensor, plan_b: TwoDPlan, p2: int, j: int, i: int,
                nsteps: int) -> torch.Tensor:
    """(…, n1, n2) -> device (i, j)'s chunks (nsteps, …, c, nb, bw): the
    slice's columns in b-column chunks, each in the 2D share layout."""
    xs = _col_slice(x, p2, j)
    b = plan_b.n2
    xs = torch.nn.functional.pad(xs, (0, nsteps * b - xs.shape[-1]))
    return torch.stack([own_rows(xs[..., t * b:(t + 1) * b], plan_b, i)
                        for t in range(nsteps)], 0)


def syrk_3d_limited_sharded(a: torch.Tensor, c: int, p2: int, chunk: int,
                            mesh, axis: str) -> ShardedTriTiles:
    """Alg 16 on the packed wire: ``chunk``-column panels stream through
    the owned extended triangle block, one reduce-scatter after the
    last; the live set is one chunk plus the owned block."""
    n1, n2 = a.shape[-2:]
    b, nsteps = limited_steps(n2, p2, chunk)
    plan_b = make_2d_plan(c, n1, b)
    tb, rep = _grid(mesh, axis, c, p2)
    shard = threedim.syrk_3d_limited_local(
        _own_chunks(a, plan_b, p2, rep.index, tb.index, nsteps), plan_b, tb,
        rep, p2)
    return _sharded_from_rep(shard, plan_b, n1, c, rep, mesh, axis)


def syr2k_3d_limited_sharded(a: torch.Tensor, b_mat: torch.Tensor, c: int,
                             p2: int, chunk: int, mesh,
                             axis: str) -> ShardedTriTiles:
    n1, n2 = a.shape[-2:]
    b, nsteps = limited_steps(n2, p2, chunk)
    plan_b = make_2d_plan(c, n1, b)
    tb, rep = _grid(mesh, axis, c, p2)
    i, j = tb.index, rep.index
    shard = threedim.syr2k_3d_limited_local(
        _own_chunks(a, plan_b, p2, j, i, nsteps),
        _own_chunks(b_mat, plan_b, p2, j, i, nsteps), plan_b, tb, rep, p2)
    return _sharded_from_rep(shard, plan_b, n1, c, rep, mesh, axis)


def symm_3d_limited_sharded_a(st: ShardedTriTiles, b: torch.Tensor, c: int,
                              p2: int, chunk: int, mesh,
                              axis: str) -> torch.Tensor:
    """Alg 18: gather A's block once over the replication axis, stream
    the B / C chunks."""
    n1, n2 = st.n, b.shape[-1]
    bw, nsteps = limited_steps(n2, p2, chunk)
    plan_b = make_2d_plan(c, n1, bw)
    tb, rep = _grid(mesh, axis, c, p2)
    a_off, a_diag = _local_shard(st, c, mesh, axis)
    c_own = threedim.symm_3d_limited_local(
        _flat_shard(a_off, a_diag, plan_b, p2, rep.index),
        _own_chunks(b, plan_b, p2, rep.index, tb.index, nsteps), plan_b, tb,
        rep)                                         # (nsteps, …, c, nb, bw)
    allc = _gather_axis(c_own, mesh.comm(axis))      # (P, nsteps, …)
    p1 = allc.shape[0] // p2
    allc = allc.reshape((p1, p2) + tuple(allc.shape[1:]))
    n2s = n2 // p2
    cols = [torch.cat([collect_rows(allc[:, j, t], plan_b)
                       for t in range(nsteps)], dim=-1)[..., :n2s]
            for j in range(p2)]
    return torch.cat(cols, dim=-1)


def symm_3d_limited_packed_a(a_packed: torch.Tensor, b: torch.Tensor,
                             c: int, p2: int, chunk: int, mesh,
                             axis: str) -> torch.Tensor:
    st = ShardedTriTiles.from_packed(a_packed, b.shape[-2], c, mesh, axis)
    return symm_3d_limited_sharded_a(st, b, c, p2, chunk, mesh, axis)
