"""The collectives the mesh schedules run, each counting the words it
sends.

Counterparts of the reference's ``shard_map`` collectives:

  ``reduce_scatter`` — ``lax.psum_scatter(..., tiled=True)``
  ``all_gather``     — ``lax.all_gather(..., tiled=True)``
  ``gather``         — an all-gather whose result only the first rank
                       keeps (a checkpoint's leaf on its writer)
  ``all_to_all``     — ``lax.all_to_all(x, axis, 0, 0, tiled=True)``
  ``ppermute``       — ``lax.ppermute`` (on ``batch_isend_irecv``)
  ``all_reduce``     — ``lax.psum`` (``lax.pmax`` with ``op="max"``)

Each works along dim 0 of its operand on one :class:`Comm` (a mesh
axis, or a 3d grid's tb / rep axis) and adds to this rank's word count
what this rank puts on the wire, in elements: (P−1)/P of its operand
for a reduce-scatter or an all-to-all, (P−1) times it for an
all-gather, all of it for a gather from any rank but the first, 2(P−1)/P of it for an all-reduce, the whole buffer for
each send of a ppermute to another rank.  These are the ring
algorithms' counts (the closed forms of the paper's word bounds);
:func:`word_counts` reads them by kind, :func:`byte_counts` the same
elements times their size (an int8 payload moves a quarter of the bytes
of an f32 one), and :func:`reset_word_counts` sets both to 0.

An all-gather that only replicates a result the schedule leaves
sharded (the blas surface returns whole results on every rank, where
the reference's ``shard_map`` returns shards and leaves any gather to
its caller) is counted under ``REPLICATE``, apart from the schedule's
wire, which is every other kind.

On a gloo group with device buffers (``Comm.staged``) each call copies
its operand to the host and its result back.
"""
from __future__ import annotations

import collections
from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import Comm

#: the kind of an all-gather that replicates a sharded result
REPLICATE = "replicate"

_WORDS: Dict[str, int] = collections.Counter()
_BYTES: Dict[str, int] = collections.Counter()
_CALLS: Dict[str, int] = collections.Counter()


def word_counts() -> Dict[str, int]:
    """Words this rank sent since the last reset, by collective kind."""
    return dict(_WORDS)


def byte_counts() -> Dict[str, int]:
    """Bytes this rank sent since the last reset, by collective kind."""
    return dict(_BYTES)


def call_counts() -> Dict[str, int]:
    """Collectives this rank ran since the last reset, by kind."""
    return dict(_CALLS)


def reset_word_counts() -> None:
    _WORDS.clear()
    _BYTES.clear()
    _CALLS.clear()


def _count(kind: str, words: int, x: torch.Tensor) -> None:
    _WORDS[kind] += int(words)
    _BYTES[kind] += int(words) * x.element_size()
    _CALLS[kind] += 1


def _stage(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    x = x.contiguous()
    return x.cpu() if comm.staged else x


def _home(y: torch.Tensor, like: torch.Tensor, comm: Comm) -> torch.Tensor:
    return y.to(like.device, non_blocking=False) if comm.staged else y


def reduce_scatter(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Sum over the group of (P·s, …) operands; this rank keeps rows
    [index·s, (index+1)·s)."""
    P = comm.size
    if P == 1:
        return x
    if x.shape[0] % P:
        raise ValueError(f"reduce_scatter of {tuple(x.shape)} over {P} ranks")
    xs = _stage(x, comm)
    out = xs.new_empty((x.shape[0] // P,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, xs, group=comm.group)
    _count("reduce_scatter", x.numel() * (P - 1) // P, x)
    return _home(out, x, comm)


def all_gather(x: torch.Tensor, comm: Comm,
               kind: str = "all_gather") -> torch.Tensor:
    """(s, …) on every rank -> (P·s, …), the ranks' operands in order;
    counted under ``kind`` (``REPLICATE`` for a result's exit)."""
    P = comm.size
    if P == 1:
        return x
    xs = _stage(x, comm)
    out = xs.new_empty((P * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, xs, group=comm.group)
    _count(kind, x.numel() * (P - 1), x)
    return _home(out, x, comm)


def gather(x: torch.Tensor, comm: Comm) -> "torch.Tensor | None":
    """(s, …) on every rank -> (P·s, …), the ranks' operands in order,
    on the group's first rank (index 0); None on the others."""
    P = comm.size
    if P == 1:
        return x
    xs = _stage(x, comm)
    first = comm.index == 0
    parts = [torch.empty_like(xs) for _ in range(P)] if first else None
    dist.gather(xs, parts, dst=comm.ranks[0], group=comm.group)
    if not first:
        _count("gather", x.numel(), x)
        return None
    return _home(torch.cat(parts), x, comm)


def all_to_all(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """(P, …): row p goes to rank p; row p of the result came from
    rank p."""
    P = comm.size
    if x.shape[0] != P:
        raise ValueError(f"all_to_all of {tuple(x.shape)} over {P} ranks")
    if P == 1:
        return x
    xs = _stage(x, comm)
    out = torch.empty_like(xs)
    dist.all_to_all_single(out, xs, group=comm.group)
    _count("all_to_all", x.numel() * (P - 1) // P, x)
    return _home(out, x, comm)


def all_reduce(x: torch.Tensor, comm: Comm, op: str = "sum"
               ) -> torch.Tensor:
    """Sum (or, with ``op="max"``, maximum) over the group (a new
    tensor)."""
    P = comm.size
    if P == 1:
        return x
    xs = _stage(x, comm).clone()
    dist.all_reduce(xs, op={"sum": dist.ReduceOp.SUM,
                            "max": dist.ReduceOp.MAX}[op], group=comm.group)
    _count("all_reduce", 2 * x.numel() * (P - 1) // P, x)
    return _home(xs, x, comm)


def ppermute(x: torch.Tensor, perm: Sequence[Tuple[int, int]],
             comm: Comm) -> torch.Tensor:
    """Send ``x`` along the (source, destination) pairs of ``perm``
    (axis indices); returns what this rank received, zeros if nothing.
    All sends and receives of a rank go out as one batch."""
    me = comm.index
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"ppermute {perm} is not a permutation")
    if comm.size == 1 or (dst == [me] and src == [me]):
        return x.clone() if src else torch.zeros_like(x)
    xs = _stage(x, comm)
    out = torch.zeros_like(xs)
    ops = []
    if dst:
        ops.append(dist.P2POp(dist.isend, xs, comm.ranks[dst[0]],
                              group=comm.group))
        _count("ppermute", x.numel(), x)
    if src:
        ops.append(dist.P2POp(dist.irecv, out, comm.ranks[src[0]],
                              group=comm.group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return _home(out, x, comm)


# ---------------------------------------------------------------------------
# the tensor-parallel operators (Megatron's f and g), differentiable
# ---------------------------------------------------------------------------
class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.float(), ctx.comm).to(g.dtype), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        return all_reduce(x, comm)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Identity forward, all-reduce (in f32) of the gradient backward:
    where a replicated activation enters column-parallel weights."""
    if comm.size == 1:
        return x
    return _CopyToGroup.apply(x, comm)


def reduce_from_group(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """All-reduce forward, identity backward: the sum of the ranks'
    partial results (row-parallel weights, a sharded vocabulary).  Pass
    f32 partials: the sum is taken in ``x``'s dtype."""
    if comm.size == 1:
        return x
    return _ReduceFromGroup.apply(x, comm)
