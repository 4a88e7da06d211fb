"""Distributed runtime (port of :mod:`repro.distributed`): so far the
straggler monitor and step timer the train loop uses on every step;
checkpoints, compression, elasticity and faults wait (ROADMAP)."""
from .straggler import StepTimer, StragglerEvent, StragglerMonitor

__all__ = ["StepTimer", "StragglerEvent", "StragglerMonitor"]
