"""2D communication-optimal parallel SYRK / SYR2K / SYMM (paper Algs 10–12)
on ``torch.distributed`` (port of :mod:`repro.core.twodim`).

Optimal regime (Thm 9 case 2): m·n₂ < n₁ and P ≤ n₁(n₁−1)/(m·n₂)².
P = c(c+1) processors, one per triangle block of the affine-plane partition
of the c² row blocks.  The symmetric matrix never moves; the non-symmetric
matrices move through ONE regular all-to-all (two for SYR2K; B in + C out
for SYMM) of total bandwidth m·(n₁n₂/c)·(1−1/P) — exactly eq. (6).

The paper's irregular point-to-point exchange is a regular all-to-all:
two triangle blocks (affine lines) share at most one row-block index, so
the pairwise payload is one share of one row block (or nothing, for
parallel lines, which is zero-padded).  The routing tables are the
reference's static numpy tables; each rank indexes them with its own
position on the axis.

Data layout on rank k (its position on the axis of size P):
  * non-symmetric row shares ``(…, c, nb, w)``: for the c row blocks
    i ∈ R_k (sorted), this rank's 1/(c+1) column share (w = n₂/(c+1));
  * symmetric extended triangle block: off-diagonal ``(…, T, nb, nb)``
    for the T = c(c−1)/2 pairs (i > j ∈ R_k, lexicographic) and diagonal
    ``(…, nb, nb)`` for the assigned diagonal block D_k (zeros when
    |D_k| = 0).
Leading dims (a stack of matrices) ride every exchange's payload: one
all-to-all covers the whole stack, as the reference's ``*_stacked``
forms do.

The numpy half (``TwoDPlan``, the ``tb_*`` layout tables, the host-side
``distribute_rows`` / ``collect_rows`` / ``distribute_sym`` /
``assemble_sym``) is a copy of the reference's.  The tables follow the
partition's diagonal assignment, which is the port's own matching
(:func:`~repro_torch.core.triangle.assign_diagonals`).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from ..distributed import collectives
from ..distributed.mesh import Comm
from .triangle import TrianglePartition, affine_partition


# --------------------------------------------------------------------------
# plan: static routing tables from the affine partition
# --------------------------------------------------------------------------
@dataclass
class TwoDPlan:
    c: int
    n1: int                      # real rows
    n2: int                      # real cols
    nb: int                      # rows per row block (n1_pad / c^2)
    w: int                       # cols per share (n2_pad / (c+1))
    n1_pad: int
    n2_pad: int
    part: TrianglePartition = field(repr=False)
    R: np.ndarray = field(repr=False)          # (P, c) row blocks per device
    Q: np.ndarray = field(repr=False)          # (c^2, c+1) owners per row blk
    send_slot: np.ndarray = field(repr=False)  # (P, P) slot in R_k or c
    send_valid: np.ndarray = field(repr=False)  # (P, P) bool
    gather_src: np.ndarray = field(repr=False)  # (P, c, c+1) supplier device
    self_col: np.ndarray = field(repr=False)   # (P, c) own column position
    peer_col: np.ndarray = field(repr=False)   # (P, P) col position of peer p
                                               # within Q_i for i = R_k ∩ R_p
    pairs: np.ndarray = field(repr=False)      # (T, 2) slot pairs a>b
    diag_slot: np.ndarray = field(repr=False)  # (P,) slot of diag blk or -1

    @property
    def num_devices(self) -> int:
        return self.c * (self.c + 1)

    @property
    def T(self) -> int:
        return self.c * (self.c - 1) // 2


@functools.lru_cache(maxsize=64)
def make_2d_plan(c: int, n1: int, n2: int) -> TwoDPlan:
    part = affine_partition(c)
    Pn = c * (c + 1)
    nblocks = c * c
    nb = -(-n1 // nblocks)
    w = -(-n2 // (c + 1))
    R = np.array([sorted(Rk) for Rk in part.blocks])          # (P, c)
    q = part.q_sets()
    Q = np.array([sorted(q[i]) for i in range(nblocks)])      # (c^2, c+1)
    inter = part.intersection_table()                          # (P, P)
    send_slot = np.full((Pn, Pn), c, dtype=np.int64)
    send_valid = np.zeros((Pn, Pn), dtype=bool)
    peer_col = np.zeros((Pn, Pn), dtype=np.int64)
    slot_of = {(k, i): s for k in range(Pn) for s, i in enumerate(R[k])}
    for k in range(Pn):
        for p in range(Pn):
            i = inter[k, p]
            if i >= 0:
                send_slot[k, p] = slot_of[(k, int(i))]
                send_valid[k, p] = True
                peer_col[k, p] = int(np.where(Q[int(i)] == p)[0][0])
    gather_src = np.zeros((Pn, c, c + 1), dtype=np.int64)
    self_col = np.zeros((Pn, c), dtype=np.int64)
    for k in range(Pn):
        for s in range(c):
            i = R[k][s]
            gather_src[k, s] = Q[i]
            self_col[k, s] = int(np.where(Q[i] == k)[0][0])
    pairs = np.array([(a, b) for a in range(c) for b in range(a)],
                     dtype=np.int64)
    diag_slot = np.full((Pn,), -1, dtype=np.int64)
    for k in range(Pn):
        if part.diag[k]:
            diag_slot[k] = slot_of[(k, part.diag[k][0])]
    return TwoDPlan(c=c, n1=n1, n2=n2, nb=nb, w=w, n1_pad=nb * nblocks,
                    n2_pad=w * (c + 1), part=part, R=R, Q=Q,
                    send_slot=send_slot, send_valid=send_valid,
                    gather_src=gather_src, self_col=self_col,
                    peer_col=peer_col, pairs=pairs, diag_slot=diag_slot)


# --------------------------------------------------------------------------
# packed-triangle <-> extended-triangle-block index tables (the mesh wire)
# --------------------------------------------------------------------------
def tb_flat_words(c: int, n1: int) -> int:
    """Per-device words of one flattened extended triangle block:
    (T + 1)·nb² — the ~n²/(2P) owned share of the paper's layout."""
    nb = -(-n1 // (c * c))
    T = c * (c - 1) // 2
    return (T + 1) * nb * nb


@functools.lru_cache(maxsize=64)
def tb_pack_tables(c: int, n1: int) -> Tuple[np.ndarray, np.ndarray]:
    """Static gather/scatter tables between the element-packed lower
    triangle of an n1×n1 matrix and the 2D plan's per-device extended
    triangle blocks.

    Element ``l`` of the row-major packed triangle lives at
    ``flat[kidx[l], sidx[l]]`` where ``flat`` is the (P, (T+1)·nb²)
    array of per-device flattened (off ‖ diag) extended triangle
    blocks.  The affine-plane partition stores every block pair
    exactly once (off-diagonal block (i>j) on the unique line through
    {i, j}; diagonal block on its unique assigned device), so the map
    is a bijection onto ~n1²/2 real slots — converting through it
    never touches an n1×n1 dense intermediate.

    Ownership only depends on (c, n1): every TwoDPlan for the same
    pair shares these tables regardless of n2.  Cached; returned
    arrays are read-only.
    """
    plan = make_2d_plan(c, n1, 1)          # n2 does not affect ownership
    nblocks = c * c
    nb, T, Pn = plan.nb, plan.T, plan.num_devices
    dev_of = np.full((nblocks, nblocks), -1, dtype=np.int64)
    slot_of = np.full((nblocks, nblocks), -1, dtype=np.int64)
    for k in range(Pn):
        for t, (a, b) in enumerate(plan.pairs):
            i, j = plan.R[k][a], plan.R[k][b]
            dev_of[i, j] = k
            slot_of[i, j] = t
        ds = plan.diag_slot[k]
        if ds >= 0:
            d = plan.R[k][ds]
            dev_of[d, d] = k
            slot_of[d, d] = T              # diag block rides as slot T
    i, j = np.tril_indices(n1)
    bi, bj = i // nb, j // nb
    assert (dev_of[bi, bj] >= 0).all(), "partition must cover the triangle"
    kidx = dev_of[bi, bj].astype(np.int32)
    sidx = ((slot_of[bi, bj] * nb + i % nb) * nb + j % nb).astype(np.int32)
    for arr in (kidx, sidx):
        arr.setflags(write=False)
    return kidx, sidx


@functools.lru_cache(maxsize=64)
def tb_block_tables(c: int) -> Tuple[np.ndarray, np.ndarray]:
    """*Block*-granular (device, slot) ↔ lower-triangle-grid bijection —
    the slice/tile-granular replacement for per-element
    :func:`tb_pack_tables` on the ShardedTriTiles converters.

    The c²-block row grid has Tb = c²(c²+1)/2 lower-triangle blocks in
    the row-major flat order of :func:`~repro.core.packing.
    tile_tril_coords`; every device k owns T+1 slots (T off-diagonal
    pairs + one diagonal slot).  Returns

      * ``src`` (Tb,) int32: flat slot index ``k·(T+1)+t`` owning each
        lower-triangle grid block (a bijection — every block owned
        exactly once);
      * ``dst`` (P, T+1) int32: the flat grid-block id held by each
        device slot, with the sentinel ``Tb`` for the diagonal slot of
        devices that own no diagonal block (callers append one zero pad
        block).

    Ownership depends only on c (so the cache is keyed on c alone);
    cached and read-only.
    """
    plan = make_2d_plan(c, 1, 1)
    T, Pn = plan.T, plan.num_devices
    nblocks = c * c
    Tb = nblocks * (nblocks + 1) // 2
    src = np.full(Tb, -1, dtype=np.int64)
    dst = np.full((Pn, T + 1), Tb, dtype=np.int64)
    for k in range(Pn):
        for t, (a, b) in enumerate(plan.pairs):
            i, j = int(plan.R[k][a]), int(plan.R[k][b])      # i > j
            f = i * (i + 1) // 2 + j
            src[f] = k * (T + 1) + t
            dst[k, t] = f
        ds = plan.diag_slot[k]
        if ds >= 0:
            d = int(plan.R[k][ds])
            f = d * (d + 1) // 2 + d
            src[f] = k * (T + 1) + T
            dst[k, T] = f
    assert (src >= 0).all(), "partition must cover the block triangle"
    src = src.astype(np.int32)
    dst = dst.astype(np.int32)
    src.setflags(write=False)
    dst.setflags(write=False)
    return src, dst


@functools.lru_cache(maxsize=256)
def tb_device_row_starts(c: int, n1: int, k: int
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Slice-granular packed-offset tables for ONE device's extended
    triangle block — the straggler-replacement rebuild path.

    Device ``k`` of the c(c+1) partition owns T+1 = c(c−1)/2 + 1 grid
    blocks (``tb_block_tables`` dst row k).  Returns

      * ``starts`` (T+1, nb) int32: packed offset of intra-block row u of
        owned block t — matrix row bi·nb+u, columns bj·nb…, i.e. each
        (block, row) pair is one contiguous width-nb slice of the packed
        triangle (padded to tril_size(c²·nb));
      * ``is_diag`` (T+1,) bool: grid-diagonal blocks whose intra-block
        upper halves must be masked;
      * ``valid`` (T+1,) bool: False only for the diagonal slot of
        devices that own no diagonal block (the ``dst`` sentinel).

    Rebuilding one device therefore costs (T+1)·nb slice gathers —
    ~n²/(2P) words — instead of the full P-shard ``from_packed``.
    """
    _, dst = tb_block_tables(c)
    from .packing import tile_tril_coords
    nblocks = c * c
    nb = -(-n1 // nblocks)
    coords = tile_tril_coords(nblocks)            # (Tb, 2) row-major tril
    Tb = coords.shape[0]
    f = dst[k].astype(np.int64)                   # (T+1,) grid block ids
    valid = f < Tb
    fv = np.where(valid, f, 0)
    bi, bj = coords[fv, 0], coords[fv, 1]         # (T+1,)
    u = np.arange(nb, dtype=np.int64)
    rr = bi[:, None] * nb + u[None, :]            # (T+1, nb) matrix rows
    starts = (rr * (rr + 1) // 2 + bj[:, None] * nb).astype(np.int32)
    is_diag = (bi == bj) & valid
    for arr in (starts, is_diag, valid):
        arr.setflags(write=False)
    return starts, is_diag, valid



# --------------------------------------------------------------------------
# the all-to-all row exchange (Alg 10 lines 3–14)
# --------------------------------------------------------------------------
def _ix(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.int64)


def _stack(x: torch.Tensor, core: int):
    """(…, *core) -> ((K, *core), lead)."""
    lead = tuple(x.shape[:x.ndim - core])
    return x.reshape((-1,) + tuple(x.shape[x.ndim - core:])), lead


def _exchange_rows(a_own: torch.Tensor, plan: TwoDPlan,
                   comm: Comm) -> torch.Tensor:
    """(…, c, nb, w) own shares -> (…, c, nb, n2_pad) assembled rows: one
    all-to-all for the whole stack."""
    c, nb, w = plan.c, plan.nb, plan.w
    k = comm.index
    a, lead = _stack(a_own, 3)
    own = a.movedim(0, 1)                                     # (c, K, nb, w)
    K = own.shape[1]
    own_pad = torch.cat([own, own.new_zeros((1, K, nb, w))], 0)
    send = own_pad[_ix(plan.send_slot[k])]                   # (P, K, nb, w)
    recv = collectives.all_to_all(send, comm)
    gsrc = _ix(plan.gather_src[k])                            # (c, c+1)
    is_self = (gsrc == k).to(recv.device)
    shares = recv[gsrc]                                  # (c, c+1, K, nb, w)
    shares = torch.where(is_self[:, :, None, None, None], own[:, None],
                         shares)
    rows = shares.permute(2, 0, 3, 1, 4).reshape(K, c, nb, (c + 1) * w)
    return rows.reshape(lead + (c, nb, (c + 1) * w))


def _reverse_exchange(c_partial: torch.Tensor, plan: TwoDPlan,
                      comm: Comm) -> torch.Tensor:
    """SYMM output reduction (Alg 12 lines 21–33): partial full rows
    (…, c, nb, n2_pad) -> summed own column shares (…, c, nb, w)."""
    c, nb, w = plan.c, plan.nb, plan.w
    k = comm.index
    x, lead = _stack(c_partial, 3)
    K = x.shape[0]
    parts = x.reshape(K, c, nb, c + 1, w)
    slot = _ix(plan.send_slot[k])                              # (P,)
    pcol = _ix(plan.peer_col[k])                               # (P,)
    valid = torch.as_tensor(plan.send_valid[k]).to(x.device)
    parts_pad = torch.cat([parts, parts.new_zeros((K, 1, nb, c + 1, w))], 1)
    send = parts_pad[:, slot, :, pcol]                         # (P, K, nb, w)
    send = send * valid[:, None, None, None]
    recv = collectives.all_to_all(send, comm)
    seg = _ix(np.where(plan.send_valid[k], plan.send_slot[k], c))
    summed = recv.new_zeros((c + 1, K, nb, w)).index_add_(
        0, seg.to(recv.device), recv)[:c]
    own = torch.stack([parts[:, s, :, int(plan.self_col[k][s]), :]
                       for s in range(c)], 1)                  # (K, c, nb, w)
    out = own + summed.movedim(0, 1)
    return out.reshape(lead + (c, nb, w))


# --------------------------------------------------------------------------
# local computations
# --------------------------------------------------------------------------
def _syrk_blocks(rows_a: torch.Tensor, rows_b: Optional[torch.Tensor],
                 plan: TwoDPlan, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Off-diagonal GEMMs + diagonal SYRK of the triangle block (Alg 10
    lines 15–17 / Alg 11 lines 18–20); rows (…, c, nb, n2_pad)."""
    pa, pb = _ix(plan.pairs[:, 0]), _ix(plan.pairs[:, 1])
    ds = int(plan.diag_slot[k])
    lead = rows_a.shape[:-3]
    nb = plan.nb
    if rows_b is None:                                          # SYRK
        off = rows_a[..., pa, :, :] @ rows_a[..., pb, :, :].mT
        if ds < 0:
            return off, rows_a.new_zeros(lead + (nb, nb))
        rd = rows_a[..., ds, :, :]
        return off, torch.tril(rd @ rd.mT)
    off = (rows_a[..., pa, :, :] @ rows_b[..., pb, :, :].mT
           + rows_b[..., pa, :, :] @ rows_a[..., pb, :, :].mT)  # SYR2K
    if ds < 0:
        return off, rows_a.new_zeros(lead + (nb, nb))
    g = rows_a[..., ds, :, :] @ rows_b[..., ds, :, :].mT
    return off, torch.tril(g + g.mT)


def syrk_2d_local(a_own: torch.Tensor, plan: TwoDPlan, comm: Comm):
    """Alg 10 on this rank: (…, c, nb, w) -> (off (…, T, nb, nb),
    diag (…, nb, nb))."""
    rows = _exchange_rows(a_own, plan, comm)
    return _syrk_blocks(rows, None, plan, comm.index)


def syr2k_2d_local(a_own: torch.Tensor, b_own: torch.Tensor,
                   plan: TwoDPlan, comm: Comm):
    """Alg 11: two exchanges, one symmetrised rank-2k update."""
    rows_a = _exchange_rows(a_own, plan, comm)
    rows_b = _exchange_rows(b_own, plan, comm)
    return _syrk_blocks(rows_a, rows_b, plan, comm.index)


def _symm_partial(a_off: torch.Tensor, a_diag: torch.Tensor,
                  rows_b: torch.Tensor, plan: TwoDPlan,
                  k: int) -> torch.Tensor:
    """Collective-free core of Alg 12: extended triangle block ×
    assembled B rows (…, c, nb, n2p) -> partial C rows (…, c, nb, n2p)."""
    pa, pb = _ix(plan.pairs[:, 0]), _ix(plan.pairs[:, 1])
    # C_i += A_ij B_j  and  C_j += A_ij^T B_i  for each pair (i>j)
    contrib_i = a_off @ rows_b[..., pb, :, :]
    contrib_j = a_off.mT @ rows_b[..., pa, :, :]
    dev = rows_b.device
    c_partial = torch.zeros_like(rows_b)
    c_partial.index_add_(-3, pa.to(dev), contrib_i)
    c_partial.index_add_(-3, pb.to(dev), contrib_j)
    ds = int(plan.diag_slot[k])
    if ds >= 0:                       # C_d += sym(A_dd) B_d
        a_dd = a_diag + torch.tril(a_diag, -1).mT
        c_partial[..., ds, :, :] += a_dd @ rows_b[..., ds, :, :]
    return c_partial


def symm_2d_local(a_off: torch.Tensor, a_diag: torch.Tensor,
                  b_own: torch.Tensor, plan: TwoDPlan,
                  comm: Comm) -> torch.Tensor:
    """Alg 12.  a_off (…, T, nb, nb): off-diagonal blocks A_ij, i > j ∈
    R_k; a_diag (…, nb, nb): lower-triangular diagonal block (zeros if
    none); b_own (…, c, nb, w): B row shares.  Returns C row shares
    (…, c, nb, w)."""
    rows_b = _exchange_rows(b_own, plan, comm)
    c_partial = _symm_partial(a_off, a_diag, rows_b, plan, comm.index)
    return _reverse_exchange(c_partial, plan, comm)


# --------------------------------------------------------------------------
# full-array entry points (every rank passes the same global arrays)
# --------------------------------------------------------------------------
def syrk_2d(a_dist: torch.Tensor, plan: TwoDPlan, mesh, axis: str = "x"):
    """a_dist: (P, …, c, nb, w), every rank's shares (the reference's
    global array).  Returns this rank's (off (…, T, nb, nb), diag
    (…, nb, nb))."""
    comm = mesh.comm(axis)
    return syrk_2d_local(a_dist[comm.index], plan, comm)


def syr2k_2d(a_dist: torch.Tensor, b_dist: torch.Tensor, plan: TwoDPlan,
             mesh, axis: str = "x"):
    comm = mesh.comm(axis)
    return syr2k_2d_local(a_dist[comm.index], b_dist[comm.index], plan,
                          comm)


def symm_2d(a_off: torch.Tensor, a_diag: torch.Tensor, b_dist: torch.Tensor,
            plan: TwoDPlan, mesh, axis: str = "x") -> torch.Tensor:
    """a_off (P, …, T, nb, nb), a_diag (P, …, nb, nb), b_dist
    (P, …, c, nb, w) -> this rank's C shares (…, c, nb, w)."""
    comm = mesh.comm(axis)
    k = comm.index
    return symm_2d_local(a_off[k], a_diag[k], b_dist[k], plan, comm)


# --------------------------------------------------------------------------
# host-side distribution / assembly helpers (tests, data prep)
# --------------------------------------------------------------------------
def distribute_rows(Xf: np.ndarray, plan: TwoDPlan) -> np.ndarray:
    """(n1, n2) -> (P, c, nb, w): per-device row-block column shares."""
    c, nb, w = plan.c, plan.nb, plan.w
    Xp = np.zeros((plan.n1_pad, plan.n2_pad), Xf.dtype)
    Xp[:Xf.shape[0], :Xf.shape[1]] = Xf
    blocks = Xp.reshape(c * c, nb, plan.n2_pad)
    out = np.zeros((plan.num_devices, c, nb, w), Xf.dtype)
    for k in range(plan.num_devices):
        for s, i in enumerate(plan.R[k]):
            col = plan.self_col[k, s]
            out[k, s] = blocks[i][:, col * w:(col + 1) * w]
    return out


def collect_rows(dist: np.ndarray, plan: TwoDPlan) -> np.ndarray:
    """Inverse of :func:`distribute_rows` (unpadded)."""
    c, nb, w = plan.c, plan.nb, plan.w
    Xp = np.zeros((plan.n1_pad, plan.n2_pad), dist.dtype)
    blocks = Xp.reshape(c * c, nb, plan.n2_pad)
    for k in range(plan.num_devices):
        for s, i in enumerate(plan.R[k]):
            col = plan.self_col[k, s]
            blocks[i][:, col * w:(col + 1) * w] = dist[k, s]
    return blocks.reshape(plan.n1_pad, plan.n2_pad)[:plan.n1, :plan.n2]


def distribute_sym(Af: np.ndarray, plan: TwoDPlan
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Full symmetric (n1, n1) -> extended triangle blocks
    (P, T, nb, nb) off-diag + (P, nb, nb) diag(lower)."""
    c, nb = plan.c, plan.nb
    Ap = np.zeros((plan.n1_pad, plan.n1_pad), Af.dtype)
    Ap[:Af.shape[0], :Af.shape[0]] = Af
    At = Ap.reshape(c * c, nb, c * c, nb).transpose(0, 2, 1, 3)
    off = np.zeros((plan.num_devices, plan.T, nb, nb), Af.dtype)
    diag = np.zeros((plan.num_devices, nb, nb), Af.dtype)
    for k in range(plan.num_devices):
        for t, (a, b) in enumerate(plan.pairs):
            i, j = plan.R[k][a], plan.R[k][b]
            off[k, t] = At[i, j]
        ds = plan.diag_slot[k]
        if ds >= 0:
            d = plan.R[k][ds]
            diag[k] = np.tril(At[d, d])
    return off, diag


def assemble_sym(off: np.ndarray, diag: np.ndarray, plan: TwoDPlan
                 ) -> np.ndarray:
    """(P, T, nb, nb) + (P, nb, nb) -> dense lower-triangular (n1, n1)."""
    c, nb = plan.c, plan.nb
    full = np.zeros((c * c, c * c, nb, nb), off.dtype)
    for k in range(plan.num_devices):
        for t, (a, b) in enumerate(plan.pairs):
            i, j = plan.R[k][a], plan.R[k][b]
            if i >= j:
                full[i, j] = off[k, t]
            else:
                full[j, i] = off[k, t].T
        ds = plan.diag_slot[k]
        if ds >= 0:
            d = plan.R[k][ds]
            full[d, d] = diag[k]
    dense = full.transpose(0, 2, 1, 3).reshape(plan.n1_pad, plan.n1_pad)
    return np.tril(dense)[:plan.n1, :plan.n1]
