"""Sharding rules: parameter, cache and batch specs per arch (port of
:mod:`repro.models.sharding`), and the two moves between a whole tensor
and this rank's block of it.

Scheme (the reference's):

  * TP over 'model' (Megatron column / row splits; MoE experts are
    tensor-parallel over their f dim);
  * DP over 'pod' + 'data';
  * ``cfg.fsdp_params`` also shards weight rows over 'data';
  * KV caches are sequence-sharded over 'model', batch-sharded over
    'data' when the batch divides.

A spec is a tuple with one entry per dimension: an axis name, a tuple
of axis names, or None (replicated) — the port's ``PartitionSpec``.  A
one-axis tuple is written as the name, as ``PartitionSpec`` normalises
it.  Every rule falls back to replication on a dimension that does not
divide.  Trees are dicts keyed by the port's paths
(:meth:`~repro_torch.models.model.Model.param_tree`'s keys), each value
a shape (or anything with ``.shape``); a ``"periods"`` leaf carries
the stacked leading dim, which is never sharded.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..distributed import collectives

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]


def _sizes(mesh) -> Dict[str, int]:
    return dict(getattr(mesh, "shape", mesh))


def _tuplize(axis: Axis) -> Tuple[str, ...]:
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _norm(axis: Axis) -> Axis:
    """A one-axis tuple as its name, as ``PartitionSpec`` prints it."""
    if isinstance(axis, tuple) and len(axis) == 1:
        return axis[0]
    return axis


def axis_size(mesh, axis: Axis) -> int:
    sizes = _sizes(mesh)
    return math.prod(sizes[a] for a in _tuplize(axis))


def _div(n: int, mesh, axis: Axis) -> bool:
    return axis is None or n % axis_size(mesh, axis) == 0


def _spec(shape, mesh, *axes) -> Spec:
    """Per-dimension divisibility fallback to replication."""
    return tuple(ax if ax is not None and _div(dim, mesh, ax) else None
                 for dim, ax in zip(shape, axes))


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(int(s) for s in getattr(leaf, "shape", leaf))


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------
COLUMN = ("wq", "wk", "wv", "wi", "wg", "in_proj", "wx", "wif", "wo_gate",
          "w_dkv", "w_kr", "w_dq", "w_uq", "w_uk", "w_uv", "dt_proj",
          "conv_w")
ROW = ("wo", "out_proj", "x_proj", "a_log")


def leaf_spec(cfg, name: str, shape, mesh) -> Spec:
    """The spec of one unstacked leaf named ``name`` (its last path
    key)."""
    fs = "data" if getattr(cfg, "fsdp_params", False) else None
    nd = len(shape)
    if name == "embed":
        return _spec(shape, mesh, "model", fs)
    if name == "unembed":
        return _spec(shape, mesh, fs, "model")
    if name in ("scale", "bias", "conv_b", "dt_bias", "d_skip", "router"):
        return (None,) * nd
    # MoE experts: tensor-parallel over f, so tokens never cross devices
    if name in ("wi", "wg") and nd == 3:      # (E, d, f)
        return _spec(shape, mesh, None, fs, "model")
    if name == "wo" and nd == 3:              # (E, f, d)
        return _spec(shape, mesh, None, "model", fs)
    if nd == 2 and name in COLUMN:
        return _spec(shape, mesh, fs, "model")
    if nd == 2 and name in ROW:
        return _spec(shape, mesh, "model", fs)
    return (None,) * nd


def param_specs(cfg, shapes: Dict[Tuple[str, ...], Any], mesh
                ) -> Dict[Tuple[str, ...], Spec]:
    """A spec per parameter path; a leaf under ``"periods"`` keeps its
    leading stacked dim replicated."""
    out = {}
    for path, leaf in shapes.items():
        shape = _shape(leaf)
        if "periods" in path:
            out[path] = (None,) + leaf_spec(cfg, path[-1], shape[1:], mesh)
        else:
            out[path] = leaf_spec(cfg, path[-1], shape, mesh)
    return out


# ---------------------------------------------------------------------------
# cache + batch specs
# ---------------------------------------------------------------------------
def cache_specs(cfg, shapes: Dict[Tuple[str, ...], Any], mesh,
                batch: int) -> Dict[Tuple[str, ...], Spec]:
    """Sequence-sharded KV over 'model', batch over 'data' when it
    divides (batch 1 falls back to the sequence over both axes)."""
    sizes = _sizes(mesh)
    bax = "data" if batch % sizes["data"] == 0 and batch > 1 else None
    sax = "model" if bax else ("data", "model")
    out = {}
    for path, leaf in shapes.items():
        name, shape = path[-1], _shape(leaf)
        lead = (None,) if "periods" in path else ()
        core = shape[len(lead):]
        if name in ("k", "v"):                # (B, S, hkv, hd)
            spec = (bax, sax, None, None)
        elif name in ("ckv", "kr"):           # (B, S, kv_lora | rd)
            spec = (bax, sax, None)
        elif name == "conv":                  # (B, dc-1, di)
            spec = _spec(core, mesh, bax, None, "model")
        elif name == "ssm":                   # (B, di, ds)
            spec = _spec(core, mesh, bax, "model", None)
        elif name == "C":                     # (B, H, dh, dh)
            spec = _spec(core, mesh, bax, None, None, None)
        elif name in ("n", "c", "m"):
            spec = (bax,) + (None,) * (len(core) - 1)
        else:
            spec = (None,) * len(core)
        out[path] = lead + spec
    return out


def batch_specs(cfg, mesh, batch: int, has_pod: bool) -> Dict[str, Spec]:
    """Input specs for tokens / labels / embeds: batch over the DP axes
    (over 'data' alone, or replicated, when it does not divide)."""
    sizes = _sizes(mesh)
    dp: Tuple[str, ...] = (("pod",) if has_pod else ()) + ("data",)
    if batch % math.prod(sizes[a] for a in dp) == 0:
        bax = _norm(dp)
    else:
        bax = "data" if batch % sizes["data"] == 0 else None
    return {"tokens": (bax, None), "labels": (bax, None),
            "positions": (bax, None), "embeds": (bax, None, None),
            "patch_embeds": (bax, None, None)}


# ---------------------------------------------------------------------------
# this rank's block, and the whole tensor back
# ---------------------------------------------------------------------------
def _block_index(mesh, axis: Axis) -> int:
    """This rank's block along the axes of ``axis``, row-major."""
    idx = 0
    for a in _tuplize(axis):
        idx = idx * mesh.shape[a] + mesh.index(a)
    return idx


def shard_leaf(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``spec`` (a
    view; every rank passes the same ``x``)."""
    if len(spec) != x.ndim:
        raise ValueError(f"spec {spec} for a tensor of {x.ndim} dims")
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        k = axis_size(mesh, axis)
        if x.shape[dim] % k:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {axis!r} ({k})")
        w = x.shape[dim] // k
        x = x.narrow(dim, _block_index(mesh, axis) * w, w)
    return x


def gather_leaf(x_loc: torch.Tensor, spec: Spec, mesh,
                kind: str = collectives.REPLICATE,
                first: bool = False) -> Optional[torch.Tensor]:
    """The whole tensor from every rank's block under ``spec``: one
    counted all-gather per mesh axis it is split over (under ``kind``;
    by default the replication of a sharded result).  With ``first``
    only the rank holding the first block of each of those axes gets it
    (``collectives.gather``); the others get None."""
    if len(spec) != x_loc.ndim:
        raise ValueError(f"spec {spec} for a tensor of {x_loc.ndim} dims")
    x = x_loc
    for dim, axis in enumerate(spec):
        for a in reversed(_tuplize(axis)):    # the inner axis first
            part = x.movedim(dim, 0).contiguous()
            if first:
                parts = collectives.gather(part, mesh.comm(a))
                if parts is None:
                    return None
            else:
                parts = collectives.all_gather(part, mesh.comm(a),
                                               kind=kind)
            x = parts.movedim(0, dim)
    return x


def global_shape(shape, spec: Optional[Spec], mesh) -> Tuple[int, ...]:
    """The whole tensor's shape from a block's ``shape`` under ``spec``."""
    if spec is None:
        return tuple(shape)
    return tuple(int(n) * axis_size(mesh, a) for n, a in zip(shape, spec))


def is_sharded(spec: Optional[Spec]) -> bool:
    return spec is not None and any(a is not None for a in spec)
