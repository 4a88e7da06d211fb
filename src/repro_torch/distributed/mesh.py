"""A named device mesh over ``torch.distributed`` process groups.

The port's counterpart of ``jax.sharding.Mesh`` and of
:func:`repro.launch.mesh.make_mesh`: named axes, each with its size and
the process group of the ranks along it that hold this rank, plus the
p1 × p2 sub-grids the 3d schedules reshape a single axis into (the
counterpart of :func:`repro.blas.meshpath._mesh_3d`: rank r of the axis
sits at (r // p2, r % p2)) and this rank's device.

Every rank calls the same ``blas`` function with the same arguments
(SPMD), the way a ``shard_map`` body runs on every device.  The
collectives (:mod:`repro_torch.distributed.collectives`) go through
:meth:`Mesh.comm`, which raises when the axis has no group or a group
of the wrong size: there is no fallback to another backend, device or
route.

With ``backend="gloo"`` and a CUDA device the collectives copy each
buffer to the host and back around the call (gloo's wire is the
host's); with ``"nccl"`` they run on the device buffers.  Which of the
two is fixed by the backend the caller names, nothing else.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class Comm:
    """One axis group as this rank sees it: ``ranks`` are the global
    ranks of the group's members in axis order, ``index`` this rank's
    position among them.  A size-1 axis needs no group."""
    name: str
    size: int
    index: int
    ranks: Tuple[int, ...]
    group: object = None
    staged: bool = False

    def check(self) -> "Comm":
        if self.size == 1:
            return self
        if self.group is None:
            raise RuntimeError(f"mesh axis {self.name!r} (size {self.size}) "
                               "has no process group on this rank")
        got = dist.get_world_size(self.group)
        if got != self.size:
            raise RuntimeError(f"mesh axis {self.name!r} has size "
                               f"{self.size} but its group has {got} ranks")
        return self


def _coords(rank: int, sizes: Sequence[int]) -> Tuple[int, ...]:
    out = []
    for s in reversed(sizes):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))


def _rank_of(coords: Sequence[int], sizes: Sequence[int]) -> int:
    r = 0
    for x, s in zip(coords, sizes):
        r = r * s + x
    return r


def grid_shapes(P: int) -> List[Tuple[int, int]]:
    """The (p1, p2) grids a P-rank axis holds for the 3d schedules:
    p1 = c(c+1) for c ≥ 2, p2 = P / p1 ≥ 1 (p2 = 1 is the 2d layout)."""
    out, c = [], 2
    while c * (c + 1) <= P:
        if P % (c * (c + 1)) == 0:
            out.append((c * (c + 1), P // (c * (c + 1))))
        c += 1
    return out


class Mesh:
    """Named axes over the ranks of the default process group, row-major
    (the last axis varies fastest), as ``jax.make_mesh`` lays devices.

    ``shape`` maps axis name to size (what the planner reads).  A mesh
    made by :func:`planning_mesh` has no groups and no device: it plans
    routes but every collective on it raises.
    """

    def __init__(self, axes: Dict[str, int], *, rank: int = 0,
                 groups: Optional[Dict[str, Comm]] = None,
                 grids: Optional[Dict[tuple, Tuple[Comm, Comm]]] = None,
                 backend: Optional[str] = None,
                 device: Optional[torch.device] = None):
        self.shape = dict(axes)
        self.rank = rank
        self.backend = backend
        self.device = torch.device(device) if device is not None else None
        self._comms = dict(groups or {})
        self._grids = dict(grids or {})
        self.coords = _coords(rank, list(self.shape.values()))

    def index(self, axis: str) -> int:
        return self.coords[list(self.shape).index(axis)]

    def comm(self, axis: str) -> Comm:
        """This rank's group along ``axis``; raises when it is missing or
        has the wrong size."""
        if axis not in self.shape:
            raise ValueError(f"axis {axis!r} not in mesh axes "
                             f"{list(self.shape)}")
        if self.shape[axis] == 1:
            return Comm(axis, 1, 0, (self.rank,))
        if axis not in self._comms:
            raise RuntimeError(f"mesh axis {axis!r} (size "
                               f"{self.shape[axis]}) has no process group: "
                               "build the mesh with make_mesh on an "
                               "initialised process group")
        return self._comms[axis].check()

    def grid(self, axis: str, p1: int, p2: int) -> Tuple[Comm, Comm]:
        """(tb, rep) groups of the p1 × p2 grid on ``axis``: tb holds the
        ranks with this rank's rep index, rep those with its tb index."""
        if p1 * p2 != self.shape.get(axis, -1):
            raise ValueError(f"grid {p1}x{p2} does not tile axis {axis!r} "
                             f"of size {self.shape.get(axis)}")
        if p2 == 1:
            return self.comm(axis), Comm(axis + ":rep", 1, 0, (self.rank,))
        key = (axis, p1, p2)
        if key not in self._grids:
            raise RuntimeError(f"mesh axis {axis!r} has no {p1}x{p2} grid "
                               "groups")
        tb, rep = self._grids[key]
        return tb.check(), rep.check()


def planning_mesh(axes: Dict[str, int]) -> Mesh:
    """A mesh of the given axis sizes with no process groups: enough to
    plan routes (``plan_route``, ``explain``), not to run them."""
    return Mesh(axes)


def _new_group(ranks: Sequence[int], backend: Optional[str]):
    return dist.new_group(list(ranks), backend=backend)


def make_mesh(axes: Optional[Dict[str, int]] = None, *,
              device=None) -> Mesh:
    """The mesh over the initialised default process group: every axis's
    groups and, on each axis, the groups of every p1 × p2 grid of the 3d
    schedules.  Collective: every rank of the default group must call it
    with the same axes.  ``device`` is this rank's device; with none the
    rank runs on the card (the current one with gloo, ``cuda:<rank mod
    cards>`` with nccl) and raises when there is no card: the host is
    used only when asked for ("cpu")."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised "
                           "(init_distributed)")
    world, rank = dist.get_world_size(), dist.get_rank()
    backend = dist.get_backend()
    axes = dict(axes or {"x": world})
    sizes = list(axes.values())
    if math.prod(sizes) != world:
        raise ValueError(f"mesh axes {axes} need {math.prod(sizes)} ranks, "
                         f"the process group has {world}")
    card = resolve_device(device)
    if device is None and backend == "nccl":
        card = torch.device("cuda", rank % torch.cuda.device_count())
    device = card
    staged = backend == "gloo" and device.type != "cpu"
    comms: Dict[str, Comm] = {}
    grids: Dict[tuple, Tuple[Comm, Comm]] = {}
    for ax_i, (name, size) in enumerate(axes.items()):
        if size == 1:
            continue
        # every line along this axis gets its group; all ranks create
        # every group, in the same order (new_group is collective)
        others = [s for j, s in enumerate(sizes) if j != ax_i]
        for flat in range(math.prod(others)):
            rest = list(_coords(flat, others))
            ranks = [_rank_of(rest[:ax_i] + [x] + rest[ax_i:], sizes)
                     for x in range(size)]
            group = _new_group(ranks, backend)
            if rank in ranks:
                comms[name] = Comm(name, size, ranks.index(rank),
                                   tuple(ranks), group, staged)
            for p1, p2 in grid_shapes(size):
                if p2 == 1:
                    continue
                for j in range(p2):               # tb groups: fixed rep j
                    sub = [ranks[i * p2 + j] for i in range(p1)]
                    g = _new_group(sub, backend)
                    if rank in sub:
                        tb = Comm(f"{name}:tb", p1, sub.index(rank),
                                  tuple(sub), g, staged)
                        grids.setdefault((name, p1, p2), [None, None])[0] = tb
                for i in range(p1):               # rep groups: fixed tb i
                    sub = [ranks[i * p2 + j] for j in range(p2)]
                    g = _new_group(sub, backend)
                    if rank in sub:
                        rep = Comm(f"{name}:rep", p2, sub.index(rank),
                                   tuple(sub), g, staged)
                        grids.setdefault((name, p1, p2), [None, None])[1] = rep
    return Mesh(axes, rank=rank, groups=comms,
                grids={k: tuple(v) for k, v in grids.items()},
                backend=backend, device=device)


def init_distributed(rank: int, world_size: int, init_method: str,
                     backend: str = "gloo") -> None:
    """``torch.distributed.init_process_group`` with the address, world
    size and rank given explicitly (nothing in the environment names a
    cluster).  A backend this torch lacks, or one that fails to
    initialise, raises."""
    if not dist.is_backend_available(backend):
        raise ValueError(f"torch.distributed backend {backend!r} is not "
                         f"available in this torch ({torch.__version__})")
    dist.init_process_group(backend=backend, init_method=init_method,
                            rank=rank, world_size=world_size)
