"""Distributed runtime (port of :mod:`repro.distributed`): the mesh of
``torch.distributed`` ranks the blas schedules run on (``mesh``), its
counted collectives (``collectives``) and a launcher of P rank processes
(``launch``); packed-native checkpoints in one process (``checkpoint``);
``resilience``: the ABFT-checked SYRK / SYR2K / SYMM on the local route
(the kernels) and every mesh route, their shard repair from a trusted
reference, and the retry policy of checkpoint I/O; the seeded fault
harness that the checked routes, the checkpoint commit protocol, the
serving cache and the train loop fire into (``faults``); the straggler
monitor and step timer the train loop uses on every step, and the
replacement shard of its ``evict`` leg; int8 gradient compression with
error feedback and the compressed all-reduces on the counted
collectives (``compression``); elastic scaling (``elastic``: the
reference's mesh planner ``plan_shape`` and ``plan_mesh``, which builds
the planned (data, model) mesh, the triangle wire's ``wire_c``, and the
re-sharding of a state onto another mesh: ``reshard_tree``,
``reshard_tritiles``, ``reshard_packed_state``, ``spec_tree_like``; and
``elastic.validate_divisibility``); the checkpoints save a mesh's blocks and
restore onto any mesh (``mesh=`` / ``specs=``)."""
from . import faults
from .checkpoint import (checkpoint_bytes, latest_step, read_manifest,
                         recover_stale, restore_checkpoint,
                         save_checkpoint, verify_restored,
                         wait_for_saves)
from .elastic import (plan_mesh, plan_shape, reshard_packed_state,
                      reshard_tree, reshard_tritiles, spec_tree_like, wire_c)
from .compression import (ErrorFeedbackInt8, compressed_allreduce,
                          compressed_allreduce_sym, dequantize_int8,
                          quantize_int8)
from .resilience import (AbftError, AbftReport, checked_symm, checked_syr2k,
                         checked_syrk, repair_with_reference, with_retries)
from .straggler import (StepTimer, StragglerEvent, StragglerMonitor,
                        rebuild_replacement_shard)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "read_manifest", "wait_for_saves", "checkpoint_bytes",
           "recover_stale", "verify_restored", "quantize_int8",
           "dequantize_int8", "ErrorFeedbackInt8", "compressed_allreduce",
           "compressed_allreduce_sym", "with_retries", "faults",
           "StepTimer", "StragglerEvent", "StragglerMonitor",
           "rebuild_replacement_shard", "checked_syrk", "checked_syr2k",
           "checked_symm", "repair_with_reference", "AbftError",
           "AbftReport", "plan_shape", "plan_mesh", "reshard_tree",
           "reshard_tritiles", "reshard_packed_state", "spec_tree_like",
           "wire_c"]
