"""Distributed runtime (port of :mod:`repro.distributed`): the mesh of
``torch.distributed`` ranks the blas schedules run on (``mesh``), its
counted collectives (``collectives``) and a launcher of P rank processes
(``launch``); the straggler monitor and step timer the train loop uses
on every step.  Checkpoints, compression, elasticity and faults wait
(ROADMAP)."""
from .straggler import StepTimer, StragglerEvent, StragglerMonitor

__all__ = ["StepTimer", "StragglerEvent", "StragglerMonitor"]
