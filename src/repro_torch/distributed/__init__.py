"""Distributed runtime (port of :mod:`repro.distributed`): the mesh of
``torch.distributed`` ranks the blas schedules run on (``mesh``), its
counted collectives (``collectives``) and a launcher of P rank processes
(``launch``); packed-native checkpoints in one process (``checkpoint``),
the retry policy of their I/O (``resilience``) and the seeded fault
harness that the checkpoint commit protocol and the serving cache fire
into (``faults``); the straggler monitor and step timer the train loop
uses on every step.  Compression, elasticity and ABFT wait (ROADMAP)."""
from . import faults
from .checkpoint import (checkpoint_bytes, latest_step, read_manifest,
                         recover_stale, restore_checkpoint,
                         save_checkpoint, verify_restored,
                         wait_for_saves)
from .resilience import with_retries
from .straggler import StepTimer, StragglerEvent, StragglerMonitor

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "read_manifest", "wait_for_saves", "checkpoint_bytes",
           "recover_stale", "verify_restored", "with_retries", "faults",
           "StepTimer", "StragglerEvent", "StragglerMonitor"]
