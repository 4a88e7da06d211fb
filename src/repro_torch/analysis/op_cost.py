"""Per-op cost of an eager PyTorch step: the counterpart of
:mod:`repro.analysis.hlo_cost`.

The reference reads XLA's optimised HLO text (while bodies × their trip
counts).  Eager PyTorch has no such program: the port counts the aten
ops a step dispatches instead, under a ``TorchDispatchMode``
(:class:`OpCounter`), which also sees the backward pass's ops.  On the
meta device (``launch/dryrun.py``) the step runs as a shape function:
nothing is allocated and no kernel runs, so a full-width cell counts on
any host.

Per op:

  * dot flops with ``torch.utils.flop_counter``'s formulas (mm, bmm,
    addmm, baddbmm, convolution, the SDPA kernels), by the product's
    dtype (its first operand's);
  * elementwise and transcendental flops, one an output element, in the
    classes of ``hlo_cost``'s ``_ELEMENTWISE`` / ``_TRANSCENDENTAL``; a
    reduction one flop an input element; softmax and the activations'
    backward as the ops they stand for; by the dtype of the op's first
    floating operand;
  * "eager bytes": the inputs plus the output of every op that is not a
    view.  Views, reshapes, expands and slices are free, as
    ``hlo_cost``'s ``_FREE`` ops; an expanded operand counts the
    elements it holds; a gather (``index``, ``embedding``) reads only
    the rows it takes, and a write into a buffer (``copy_``,
    ``index_put_``, ``fill_``) moves what it writes.  That is what eager
    PyTorch moves through HBM, one kernel an op: no fusion, unlike the
    reference's count of XLA's fused program.  The remat tag
    ``scan_out`` (``models.common``) is free too, as XLA's
    ``checkpoint_name``.

A hand-written kernel is one opaque call: its wrapper adds its own cost
(:func:`add_kernel_cost`) to the active counters, where it launches and
in its meta branch.

:class:`OpCost` carries ``HloCost``'s field names.  On one device the
``collective_*`` fields and ``unknown_trip_whiles`` are 0.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

#: one flop an output element (``hlo_cost._ELEMENTWISE``'s opcodes, by
#: their aten names)
ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "neg", "abs",
    "eq", "ne", "lt", "le", "gt", "ge", "where", "logical_and",
    "logical_or", "logical_xor", "logical_not", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "clamp", "clamp_min", "clamp_max",
    "remainder", "fmod", "sign", "floor", "ceil", "round", "trunc",
    "floor_divide", "atan2", "isfinite", "masked_fill", "reciprocal",
    "square", "threshold_backward",
}
#: one transcendental an output element (``hlo_cost._TRANSCENDENTAL``)
TRANSCENDENTAL = {
    "exp", "log", "tanh", "sqrt", "rsqrt", "sin", "cos", "sigmoid", "expm1",
    "log1p", "erf", "pow", "tan",
}
#: ops that stand for several: (elementwise, transcendental) an output
#: element, as XLA lowers them
COMPOSITE = {
    "silu": (1, 1), "gelu": (7, 1), "softplus": (2, 2),
    "sigmoid_backward": (2, 0), "tanh_backward": (2, 0),
    "silu_backward": (4, 1), "gelu_backward": (12, 1),
    "softplus_backward": (3, 1),
    # max, subtract, sum and divide / the sum of grad · out, its
    # broadcast product and difference
    "_softmax": (4, 1), "_log_softmax": (3, 1),
    "_softmax_backward_data": (4, 0), "_log_softmax_backward_data": (3, 1),
}
#: reductions: one flop an input element
REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "argmax", "argmin",
    "cumsum", "cummax", "logsumexp", "var", "std", "norm", "linalg_vector_norm",
    "topk", "sort", "argsort", "all", "any",
}
#: views, allocations and metadata: no bytes, no flops
FREE = {
    "_unsafe_view", "view", "_reshape_alias", "reshape", "detach", "alias",
    "lift_fresh", "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "resize_", "set_", "t", "expand", "slice", "select",
    "unbind", "split", "split_with_sizes", "chunk", "permute", "transpose",
    "squeeze", "unsqueeze", "unfold", "diagonal", "narrow", "as_strided",
    "_local_scalar_dense", "sym_size", "sym_stride", "sym_numel",
    "is_same_size", "_to_copy_meta", "unsafe_split", "view_as", "movedim",
    "_has_compatible_shallow_copy_type", "record_stream", "scan_out",
}
#: gathers: read the rows they take (``hlo_cost``: 2 × the result)
GATHERS = {"index", "index_select", "gather", "embedding"}
#: writes into ``self``: read their sources, write what they write
OVERWRITES = {"copy_", "fill_", "zero_", "index_put_", "_index_put_impl_",
              "index_copy_", "scatter_", "scatter_add_", "index_add_",
              "masked_scatter_"}


@dataclass
class OpCost:
    """Aggregated costs of one counted run (per device), with
    ``HloCost``'s fields and the port's splits by dtype."""
    flops: float = 0.0               # dot + elementwise + reduction flops
    transcendentals: float = 0.0
    bytes_accessed: float = 0.0      # eager bytes
    collective_bytes: float = 0.0
    collective_by_kind: Dict[str, float] = field(default_factory=dict)
    collective_counts: Dict[str, float] = field(default_factory=dict)
    collective_wire_bytes: float = 0.0
    unknown_trip_whiles: int = 0
    #: dot flops, all and by the product's dtype
    dot_flops: float = 0.0
    dot_flops_by_dtype: Dict[str, float] = field(default_factory=dict)
    #: every flop (dots, elementwise, transcendental, reductions,
    #: kernels) by dtype: what ``roofline.compute_s`` divides
    flops_by_dtype: Dict[str, float] = field(default_factory=dict)
    #: aten ops counted; the hand-written kernels' calls by name
    ops: int = 0
    kernels: Dict[str, int] = field(default_factory=dict)
    #: by aten op name: [calls, flops + transcendentals, bytes]
    by_op: Dict[str, List[float]] = field(default_factory=dict)

    @property
    def total_flops(self) -> float:
        return self.flops + self.transcendentals

    def top_ops(self, n: int = 8, key: int = 2) -> List[Tuple[str, float]]:
        """The ``n`` ops with the most bytes (``key=2``) or flops (1)."""
        return sorted(((k, v[key]) for k, v in self.by_op.items()),
                      key=lambda kv: -kv[1])[:n]

    def summary(self) -> Dict[str, object]:
        return {"flops": self.flops, "transcendentals": self.transcendentals,
                "total_flops": self.total_flops,
                "dot_flops": self.dot_flops,
                "dot_flops_by_dtype": dict(self.dot_flops_by_dtype),
                "flops_by_dtype": dict(self.flops_by_dtype),
                "eager_bytes": self.bytes_accessed, "ops": self.ops,
                "kernels": dict(self.kernels)}


_ACTIVE: List["OpCounter"] = []


def add_kernel_cost(name: str, flops: Dict[str, float],
                    nbytes: float, transcendentals: float = 0.0) -> None:
    """A hand-written kernel's own cost, added to every active counter:
    ``flops`` by dtype (of which ``transcendentals`` are counted apart,
    as ``hlo_cost`` counts them), ``nbytes`` its HBM bytes (each input
    read once, each output written once)."""
    for c in _ACTIVE:
        c._kernel(name, flops, nbytes, transcendentals)


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def _held_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements a tensor holds: an expanded (stride 0) dim
    counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of an op's arguments or results (nested in tuples,
    lists and dicts), each once."""
    out: List[torch.Tensor] = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if not any(x is y for y in out):
                out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return out


def _first_float(ts: List[torch.Tensor]) -> Optional[torch.dtype]:
    for t in ts:
        if t.is_floating_point():
            return t.dtype
    return None


class OpCounter(TorchDispatchMode):
    """Counts every aten op dispatched inside ``with OpCounter() as c:``
    (and the kernels' own costs); ``c.cost`` is the :class:`OpCost`."""

    def __init__(self):
        super().__init__()
        self.cost = OpCost()
        self._by_op = defaultdict(lambda: [0, 0.0, 0.0])

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        self.cost.by_op = {k: list(v) for k, v in self._by_op.items()}
        return super().__exit__(*exc)

    def _add(self, name: str, dtype: str, flops: float, trans: float,
             nbytes: float, dot: bool = False) -> None:
        c = self.cost
        c.flops += flops
        c.transcendentals += trans
        c.bytes_accessed += nbytes
        if flops or trans:
            c.flops_by_dtype[dtype] = c.flops_by_dtype.get(dtype, 0.0) \
                + flops + trans
        if dot:
            c.dot_flops += flops
            c.dot_flops_by_dtype[dtype] = \
                c.dot_flops_by_dtype.get(dtype, 0.0) + flops
        row = self._by_op[name]
        row[0] += 1
        row[1] += flops + trans
        row[2] += nbytes

    def _kernel(self, name, flops, nbytes, trans) -> None:
        c = self.cost
        c.kernels[name] = c.kernels.get(name, 0) + 1
        total = sum(flops.values())
        for dt, f in flops.items():
            c.flops_by_dtype[dt] = c.flops_by_dtype.get(dt, 0.0) + f
        c.flops += total - trans
        c.transcendentals += trans
        c.bytes_accessed += nbytes
        row = self._by_op[name]
        row[0] += 1
        row[1] += total
        row[2] += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name.split("::")[-1]
        if name in FREE or func.is_view:
            return out
        self.cost.ops += 1
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        out_elems = sum(t.numel() for t in outs)
        packet = func._overloadpacket
        dt = _first_float(ins) or (outs[0].dtype if outs else torch.float32)
        dtype = _dtype_name(dt)
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            self._add(name, dtype, f, 0.0, self._bytes(name, ins, outs),
                      dot=True)
            return out
        base = name.rstrip("_") if name not in COMPOSITE else name
        flops = trans = 0.0
        if base in ELEMENTWISE:
            flops = out_elems
        elif base in TRANSCENDENTAL:
            trans = out_elems
        elif base in COMPOSITE:
            e, t = COMPOSITE[base]
            flops, trans = e * out_elems, t * out_elems
        elif base in REDUCTIONS and ins:
            flops = ins[0].numel()
        self._add(name, dtype, flops, trans, self._bytes(name, ins, outs))
        return out

    @staticmethod
    def _bytes(name: str, ins: List[torch.Tensor],
               outs: List[torch.Tensor]) -> float:
        out_b = sum(_held_bytes(t) for t in outs)
        if name in GATHERS:
            idx = sum(_held_bytes(t) for t in ins[1:]
                      if not t.is_floating_point())
            return 2.0 * out_b + idx
        if name in OVERWRITES:
            reads = sum(_held_bytes(t) for t in ins[1:])
            if name in ("copy_", "fill_", "zero_"):
                return float(reads + _held_bytes(ins[0]))
            src = [t for t in ins[1:] if t.is_floating_point()]
            return float(reads + (_held_bytes(src[-1]) if src else 0))
        return float(sum(_held_bytes(t) for t in ins) + out_b)


def count_ops(fn, *args, **kwargs) -> Tuple[object, OpCost]:
    """(``fn(*args, **kwargs)``, its :class:`OpCost`)."""
    with OpCounter() as c:
        out = fn(*args, **kwargs)
    return out, c.cost
