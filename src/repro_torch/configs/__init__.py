"""Architecture registry: ``get_config(arch_id)`` / ``get_smoke_config``.

Port of :mod:`repro.configs` for the archs the port can run so far
(stablelm-1.6b, xlstm-350m); the other archs wait for their blocks
(MLA, MoE, Mamba).
Each module exposes ``CONFIG`` (the published configuration) and
``SMOKE`` (a reduced same-family config for CPU tests).
"""
from __future__ import annotations

import importlib
from typing import List

ARCHS: List[str] = ["stablelm_1_6b", "xlstm_350m"]

_ALIASES = {"stablelm-1.6b": "stablelm_1_6b", "xlstm-350m": "xlstm_350m"}


def canonical(arch: str) -> str:
    return _ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))


def _module(arch: str):
    name = canonical(arch)
    if name not in ARCHS:
        raise ValueError(f"arch {arch!r} is not ported yet (have {ARCHS})")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    return _module(arch).SMOKE
