"""Plan the (data, model) mesh for a world of ranks (port of the
planning half of :mod:`repro.distributed.elastic`).

:func:`plan_shape` is the reference's, pure and device-free, so every
rank computes the same mesh on its own.  :func:`plan_mesh` is the
reference's ``plan_mesh(n_devices, *, max_model, model_divides)``: it
builds the planned mesh over the initialised process group through
:func:`repro_torch.distributed.mesh.make_mesh`.

Re-sharding a saved state onto another world (``reshard_*``) waits for
ROADMAP A8.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch.distributed as dist

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
