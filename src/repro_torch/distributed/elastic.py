"""Elastic scaling: plan the (data, model) mesh for whatever ranks a
job has and re-shard the training state onto it, packed symmetric
state included (port of :mod:`repro.distributed.elastic`).

:func:`plan_shape` is the reference's, pure and device-free, so every
rank computes the same mesh on its own.  :func:`plan_mesh` is the
reference's ``plan_mesh(n_devices, *, max_model, model_divides)``: it
builds the planned mesh over the initialised process group through
:func:`repro_torch.distributed.mesh.make_mesh`.

The recovery story: a job loses ranks, restarts on a smaller world,
``plan_mesh`` picks its (data, model) factorisation, and
``restore_checkpoint(mesh=, specs=)`` gives each rank its block of each
saved whole leaf (:func:`reshard_tree` is the same placement for a tree
in memory).  No state is keyed to rank ids, so shrinking and growing
are alike.  A :class:`~repro_torch.core.packing.ShardedTriTiles` wire
moves from P = c(c+1) ranks to P′ = c′(c′+1) through the element-packed
triangle (:func:`reshard_tritiles`): ~n²/2 words, never a dense n × n.

Specs are the port's tuples (``models.sharding``): one entry per
dimension, an axis name, a tuple of names or None; ``()`` replicates a
leaf of any rank, as the reference's ``P()`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core.dispatch import fit_c_grid
from ..core.packing import (PackedTriangle, PackedTriangleSlice,
                            ShardedTriTiles, TriTiles)
from .checkpoint import _is_packed_leaf, _unflatten, _walk
from .mesh import Mesh, make_mesh


def plan_shape(n_devices: int, *, max_model: int = 16,
               model_divides: Optional[int] = None) -> Tuple[int, int]:
    """Pick (data, model) for ``n_devices``: the largest model axis
    ≤ ``max_model`` that divides ``n_devices`` (and ``model_divides``,
    e.g. n_heads or d_ff, when given); data takes the rest."""
    best = 1
    for m in range(1, min(max_model, n_devices) + 1):
        if n_devices % m:
            continue
        if model_divides is not None and model_divides % m:
            continue
        best = m
    return n_devices // best, best


def plan_mesh(n_devices: Optional[int] = None, *, max_model: int = 16,
              model_divides: Optional[int] = None, device=None) -> Mesh:
    """The planned (data, model) mesh over the ranks of the initialised
    default process group (collective: every rank calls it alike).
    ``n_devices`` defaults to the group's size and must equal it;
    ``device`` is this rank's (see ``make_mesh``: the card unless "cpu"
    is asked for)."""
    if not dist.is_initialized():
        raise RuntimeError("plan_mesh needs torch.distributed initialised")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"plan_mesh for {n_devices} devices on a process "
                         f"group of {world}")
    data, model = plan_shape(n_devices, max_model=max_model,
                             model_divides=model_divides)
    return make_mesh({"data": data, "model": model}, device=device)


def wire_c(n_devices: Optional[int] = None) -> int:
    """The triangle-block wire parameter for a world of ``n_devices``
    (default: the initialised process group's size): the largest c with
    P = c(c+1) <= n_devices, 0 when no wire fits.  Pure, so every rank
    computes the same c′ after an elastic restart."""
    if n_devices is None:
        if not dist.is_initialized():
            raise RuntimeError("wire_c without n_devices needs "
                               "torch.distributed initialised")
        n_devices = dist.get_world_size()
    return fit_c_grid(n_devices)


def reshard_tritiles(st: ShardedTriTiles, c_new: int, *, mesh=None,
                     axis: Optional[str] = None) -> ShardedTriTiles:
    """Re-shard a P = c(c+1) extended-triangle-block wire onto
    P′ = c′(c′+1) devices: old (device, slot) -> element-packed triangle
    -> new (device, slot), through the block-granular converters, the
    packed vector (~n²/2 words) the only intermediate; bit-exact in any
    dtype (data movement only).  Returns the global form, or with
    ``mesh`` / ``axis`` this rank's shard of the new wire (a local
    ``st`` is gathered first)."""
    if c_new == st.c and mesh is None and not st.local:
        return st
    if c_new < 1:
        raise ValueError(f"no triangle wire fits c_new={c_new}")
    return ShardedTriTiles.from_packed(st.to_packed(), st.n, c_new,
                                       mesh, axis)


def reshard_packed_state(tree: Any, n_devices: Optional[int] = None, *,
                         c: Optional[int] = None) -> Any:
    """Every :class:`ShardedTriTiles` leaf of ``tree`` re-sharded onto
    the wire of the new world (``c`` explicit, or
    ``wire_c(n_devices)``); TriTiles, PackedTriangle and plain leaves do
    not depend on the device count and pass through."""
    c_new = wire_c(n_devices) if c is None else c
    leaves = (reshard_tritiles(x, c_new) if isinstance(x, ShardedTriTiles)
              else x for _, x in _walk(tree, ""))
    return _unflatten(tree, leaves)


def _with_fields(like, **fields):
    """A leaf of ``like``'s packed type holding ``fields`` (specs) in
    place of its arrays; the shape checks of the type are skipped."""
    out = object.__new__(type(like))
    for f in dataclasses.fields(like):
        object.__setattr__(out, f.name, fields.get(f.name,
                                                   getattr(like, f.name)))
    return out


_ARRAYS = {PackedTriangle: ("vec",), PackedTriangleSlice: ("vec",),
           TriTiles: ("tiles",), ShardedTriTiles: ("off", "diag")}


def spec_tree_like(tree: Any, spec: tuple = (), *,
                   shard_axis: Optional[str] = None) -> Any:
    """A spec tree of ``tree``'s structure, every leaf ``spec`` (default
    replicated).  Packed-aware: a :class:`ShardedTriTiles` leaf maps to
    a ShardedTriTiles whose ``off`` / ``diag`` hold ``(shard_axis,)`` on
    the leading device axis (``spec`` when ``shard_axis`` is None);
    TriTiles and PackedTriangle leaves hold ``spec`` in their arrays'
    places."""
    def one(x):
        if isinstance(x, ShardedTriTiles):
            s = (shard_axis,) if shard_axis is not None else spec
            return _with_fields(x, off=s, diag=s)
        if _is_packed_leaf(x):
            return _with_fields(x, **{f: spec for f in _ARRAYS[type(x)]})
        return spec

    return _unflatten(tree, (one(x) for _, x in _walk(tree, "")))


def _pairs(tree: Any, specs: Any):
    """(leaf, its spec) over ``tree`` in the checkpoint's leaf order;
    ``specs`` has ``tree``'s structure down to each leaf, where it holds
    that leaf's spec (a tuple, which is not walked into)."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _pairs(tree[k], specs[k])
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _pairs(getattr(tree, f), getattr(specs, f))
    elif isinstance(tree, (list, tuple)):
        for x, s in zip(tree, specs):
            yield from _pairs(x, s)
    else:
        yield tree, specs


def _place(x, spec, mesh: Mesh):
    from ..models.sharding import shard_leaf
    if isinstance(x, int):
        return x
    x = torch.as_tensor(x)
    spec = tuple(spec) + (None,) * (x.ndim - len(spec))
    block = shard_leaf(x, spec, mesh)
    out = torch.empty(block.shape, dtype=block.dtype, device=mesh.device)
    return out.copy_(block)


def reshard_tree(tree: Any, specs: Any, mesh: Mesh) -> Any:
    """This rank's block of every leaf of ``tree`` (whole tensors or
    numpy arrays, as a restore reads them) under the matching spec of
    ``specs`` on ``mesh``, on the mesh's device.  A spec shorter than
    its leaf's rank replicates the trailing dims.  A packed leaf pairs
    with one spec, used for each of its arrays, or with a same-format
    leaf of specs (:func:`spec_tree_like`); a :class:`ShardedTriTiles`
    whose device axis is split over a mesh axis becomes this rank's
    shard of the wire (the local form)."""
    def one(x, s):
        if isinstance(x, ShardedTriTiles):
            axes = [a for a in (s.off if _is_packed_leaf(s) else s) if a]
            if axes:
                return ShardedTriTiles.from_packed(x.to_packed(), x.n, x.c,
                                                   mesh, axes[0])
        if _is_packed_leaf(x):
            names = _ARRAYS[type(x)]
            return dataclasses.replace(x, **{
                f: _place(getattr(x, f),
                          getattr(s, f) if _is_packed_leaf(s) else s, mesh)
                for f in names})
        return _place(x, s, mesh)

    return _unflatten(tree, (one(x, s) for x, s in _pairs(tree, specs)))


def validate_divisibility(mesh, *, global_batch: int,
                          model_dims: Sequence[int]) -> Tuple[bool, str]:
    """Pre-flight check: the batch divides the DP axes ('pod' and
    'data'), every model dim the TP axis.  Returns (ok, reason)."""
    shape = dict(getattr(mesh, "shape", mesh))
    dp = 1
    for a in ("pod", "data"):
        dp *= shape.get(a, 1)
    tp = shape.get("model", 1)
    if global_batch % dp:
        return False, f"global_batch {global_batch} % dp {dp} != 0"
    for d in model_dims:
        if d % tp:
            return False, f"model dim {d} % tp {tp} != 0"
    return True, "ok"
