"""Computation-optimal cyclic-shift (ring) SYRK / SYR2K / SYMM on
``torch.distributed`` (port of :mod:`repro.core.ringpath`).

The Koanantakool–Yelick style c=1 schedule: rank r owns row block A_r
(nb = ceil(n1/P) rows, rounded up to even when P is even) and the
extended-triangle slots of C it is responsible for.  A copy of the local
operand travels the ring by ``ppermute`` for S = ⌊P/2⌋ shifts; after s
shifts rank r holds A_{(r−s) mod P} and computes exactly ONE unique block
C[r, (r−s) mod P], never its transpose partner.  When P is even the last
shift is antipodal (the pair (r, r−S) meets twice), so the two partners
split the block: the rank below P/2 computes the first nb/2 rows, the
other the last nb/2, each as a genuinely half-size product.

Per-rank dot flops are therefore (P+1)·nb²·n2, about (P+1)/P · n1²n2/P,
the unique half of the symmetric work, against ~2·n1²n2/P for the 2d /
3d routes.  Words: S shifts of the nb × n2 block, m·⌊P/2⌋·nb·n2 a rank.

The slot stack (…, S+1, nb, nb) of a rank converts to and from the packed
triangle through :func:`ring_stack_to_packed` / :func:`packed_to_ring`
(blocks with row distance d ≤ S live on rank i directly; d > S live
transposed on rank j at slot P−d; the even-P antipodal block is the SUM
of both partners' half-slots).  The two are deliberately not inverses at
even P: SYMM's input holds the full antipodal block on both partners
(one transposed), the compute output half-rows on each.

SYMM rides the same ring with B travelling instead of A: each shift adds
S[r,q]·B_q to the local C_r and S[q,r]·B_r = Lᵀ·B_r into a second buffer
that travels with B and is sent home after the loop (S+1 shifts).

Leading dims (a stack) ride the shifted payload.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..distributed import collectives
from ..distributed.mesh import Comm
from .dispatch import ring_nb
from .packing import packed_to_tiles, tiles_to_packed


def _fwd_perm(P: int):
    return [(i, (i + 1) % P) for i in range(P)]


# --------------------------------------------------------------------------
# ring bodies: this rank's row block in, its slots (or C block) out (the
# reference's take the device-major staged arrays of every device)
# --------------------------------------------------------------------------
def syrk_ring(a_loc: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Ring SYRK on this rank: ``a_loc`` (…, nb, n2), its zero-padded row
    block -> its slot stack (…, S+1, nb, nb); exactly ⌊P/2⌋ ppermutes."""
    P = comm.size
    if P < 2:
        raise ValueError("the ring route needs P >= 2")
    S, even, perm = P // 2, P % 2 == 0, _fwd_perm(P)
    buf = a_loc
    slots = [torch.tril(a_loc @ a_loc.mT)]
    for s in range(1, S + 1):
        buf = collectives.ppermute(buf, perm, comm)
        if even and s == S:
            # antipodal shift: the rank below P/2 computes rows [:h] of
            # the shared block, its partner rows [h:], each a half-size
            # product (the flop saving over a masked full block)
            h = a_loc.shape[-2] // 2
            if comm.index < P // 2:
                half = buf[..., :h, :] @ a_loc.mT
                slots.append(torch.cat([half, torch.zeros_like(half)], -2))
            else:
                half = a_loc[..., h:, :] @ buf.mT
                slots.append(torch.cat([torch.zeros_like(half), half], -2))
        else:
            slots.append(a_loc @ buf.mT)
    return torch.stack(slots, dim=-3)


def syr2k_ring(a_loc: torch.Tensor, b_loc: torch.Tensor,
               comm: Comm) -> torch.Tensor:
    """Ring SYR2K: A and B row blocks travel in ONE buffer (still ⌊P/2⌋
    ppermutes); slots of A·Bᵀ + B·Aᵀ."""
    P = comm.size
    if P < 2:
        raise ValueError("the ring route needs P >= 2")
    S, even, perm = P // 2, P % 2 == 0, _fwd_perm(P)
    buf = torch.stack([a_loc, b_loc], 0)
    g = a_loc @ b_loc.mT
    slots = [torch.tril(g + g.mT)]
    for s in range(1, S + 1):
        buf = collectives.ppermute(buf, perm, comm)
        if even and s == S:
            h = a_loc.shape[-2] // 2
            if comm.index < P // 2:
                half = buf[0][..., :h, :] @ b_loc.mT \
                    + buf[1][..., :h, :] @ a_loc.mT
                slots.append(torch.cat([half, torch.zeros_like(half)], -2))
            else:
                half = a_loc[..., h:, :] @ buf[1].mT \
                    + b_loc[..., h:, :] @ buf[0].mT
                slots.append(torch.cat([torch.zeros_like(half), half], -2))
        else:
            slots.append(a_loc @ buf[1].mT + b_loc @ buf[0].mT)
    return torch.stack(slots, dim=-3)


def symm_ring(slots: torch.Tensor, b_loc: torch.Tensor,
              comm: Comm) -> torch.Tensor:
    """Ring SYMM: C = sym(S)·B with S held as this rank's slot stack
    (…, S+1, nb, nb) (the :func:`packed_to_ring` layout) and B its row
    block (…, nb, n2).  Returns this rank's C row block; S+1 ppermutes.

    At the even-P antipodal shift the mirror update is skipped: the
    partner's own full-block update already covers it."""
    P = comm.size
    if P < 2:
        raise ValueError("the ring route needs P >= 2")
    S, even, perm = P // 2, P % 2 == 0, _fwd_perm(P)
    home = [(i, (i - S) % P) for i in range(P)]
    diag = slots[..., 0, :, :]
    sym = diag + torch.tril(diag, -1).mT
    c_own = sym @ b_loc
    buf = torch.stack([b_loc, torch.zeros_like(b_loc)], 0)
    for s in range(1, S + 1):
        buf = collectives.ppermute(buf, perm, comm)
        L = slots[..., s, :, :]
        c_own = c_own + L @ buf[0]
        if not (even and s == S):
            buf = torch.stack([buf[0], buf[1] + L.mT @ b_loc], 0)
    ret = collectives.ppermute(buf[1], home, comm)
    return c_own + ret


# --------------------------------------------------------------------------
# (device, slot) <-> packed-triangle layout converters
# --------------------------------------------------------------------------
@lru_cache(maxsize=None)
def ring_block_tables(P: int):
    """Static gather tables: lower block t = (i, j) of the P × P block
    grid (row-major, j ≤ i) <- flat ring slot ``dev·(S+1)+s``.

    d = i−j ≤ S: device i slot d holds C[i,j] directly.  d > S: device
    j slot P−d holds C[j,i] = C[i,j]ᵀ (transposed on the way out).
    Even P, d = S: the block is the SUM of both partners' half-slots
    (device i rows [h:], device j rows [:h]), no transpose.
    """
    S = P // 2
    even = P % 2 == 0
    coords = [(i, j) for i in range(P) for j in range(i + 1)]
    src1 = np.zeros(len(coords), np.int32)
    src2 = np.zeros(len(coords), np.int32)
    use2 = np.zeros(len(coords), bool)
    transp = np.zeros(len(coords), bool)
    for t, (i, j) in enumerate(coords):
        d = i - j
        if even and d == S:
            src1[t] = i * (S + 1) + S
            src2[t] = j * (S + 1) + S
            use2[t] = True
        elif d <= S:
            src1[t] = i * (S + 1) + d
        else:
            src1[t] = j * (S + 1) + (P - d)
            transp[t] = True
    return src1, src2, use2, transp


@lru_cache(maxsize=None)
def ring_unpack_tables(P: int):
    """Static gather tables: (device r, slot s) <- lower block index.

    Slot s on device r holds S[r, q] for q = (r−s) mod P: the lower
    block (r, q) directly when r ≥ q, else block (q, r) transposed.  For
    even P both antipodal partners get the FULL block (one direct, one
    transposed); the SYMM body skips the mirror update there.
    """
    S = P // 2
    src = np.zeros((P, S + 1), np.int32)
    transp = np.zeros((P, S + 1), bool)
    for r in range(P):
        for s in range(S + 1):
            q = (r - s) % P
            if r >= q:
                src[r, s] = r * (r + 1) // 2 + q
            else:
                src[r, s] = q * (q + 1) // 2 + r
                transp[r, s] = True
    return src, transp


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), device=device)


def ring_stack_to_packed(stack: torch.Tensor, n1: int) -> torch.Tensor:
    """(P, …, S+1, nb, nb) device-major slot stack -> packed (…, L)."""
    P = stack.shape[0]
    S, nb, dev = P // 2, stack.shape[-1], stack.device
    src1, src2, use2, transp = ring_block_tables(P)
    flat = stack.movedim(0, -4)
    flat = flat.reshape(flat.shape[:-4] + (P * (S + 1), nb, nb))
    g = flat[..., _t(src1, dev).long(), :, :]
    g2 = flat[..., _t(src2, dev).long(), :, :]
    g = g + torch.where(_t(use2, dev)[:, None, None], g2,
                        torch.zeros_like(g2))
    blocks = torch.where(_t(transp, dev)[:, None, None], g.mT, g)
    return tiles_to_packed(blocks, n1)


def packed_to_ring(p: torch.Tensor, n1: int, P: int) -> torch.Tensor:
    """Packed (…, L) -> (P, …, S+1, nb, nb) device-major slot stack
    (diagonal slots tril-masked; the SYMM body symmetrises)."""
    nb, S, dev = ring_nb(n1, P), P // 2, p.device
    blocks = packed_to_tiles(p, n1, nb, nt=P)
    src, transp = ring_unpack_tables(P)
    g = blocks[..., _t(src.reshape(-1), dev).long(), :, :]
    g = g.reshape(g.shape[:-3] + (P, S + 1, nb, nb))
    g = torch.where(_t(transp, dev)[:, :, None, None], g.mT, g)
    return g.movedim(-4, 0)


def packed_to_ring_local(p: torch.Tensor, n1: int, P: int,
                         r: int) -> torch.Tensor:
    """Rank r's slot stack (…, S+1, nb, nb) of :func:`packed_to_ring`,
    built alone."""
    nb, dev = ring_nb(n1, P), p.device
    blocks = packed_to_tiles(p, n1, nb, nt=P)
    src, transp = ring_unpack_tables(P)
    g = blocks[..., _t(src[r], dev).long(), :, :]
    return torch.where(_t(transp[r], dev)[:, None, None], g.mT, g)
