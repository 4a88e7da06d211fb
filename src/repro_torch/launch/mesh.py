"""Mesh helpers of the trainer (port of :mod:`repro.launch.mesh`) over the
port's :class:`~repro_torch.distributed.mesh.Mesh`.

A mesh of the ranks at hand is built by
:func:`repro_torch.distributed.mesh.make_mesh` (named axes, ``pod`` first
when there is one), or planned by
:func:`repro_torch.distributed.elastic.plan_mesh`, as the trainer does.
"""
from __future__ import annotations

from ..distributed.mesh import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh is a TPU pod shape: (data 16,
    model 16) = 256 chips, or (pod 2, data 16, model 16) = 512 (v5e
    pods).  No GPU host of the port has that shape, so this raises."""
    shape = "(2, 16, 16)" if multi_pod else "(16, 16)"
    raise NotImplementedError(
        f"the production mesh {shape} is a TPU pod shape; on GPUs build a "
        "mesh of the ranks at hand with distributed.mesh.make_mesh("
        "{'data': ..., 'model': ...}) or distributed.elastic.plan_mesh")


def dp_axes(mesh) -> tuple:
    """The data-parallel axes of a mesh (pod included when present)."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)
