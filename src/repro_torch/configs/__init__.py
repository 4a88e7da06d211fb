"""Architecture registry: ``get_config(arch_id)`` / ``get_smoke_config``.

Port of :mod:`repro.configs`, all ten of its archs: stablelm-1.6b,
xlstm-350m, jamba-v0.1-52b, the dense families gemma2-9b, gemma3-12b,
granite-20b, pixtral-12b, musicgen-large, and deepseek-v2-236b and
deepseek-v3-671b (MLA, prefix blocks, shared experts, MTP).
Each module exposes ``CONFIG`` (the published configuration) and
``SMOKE`` (a reduced same-family config for CPU tests).
"""
from __future__ import annotations

import importlib
from typing import List

ARCHS: List[str] = ["stablelm_1_6b", "xlstm_350m", "jamba_v0_1_52b",
                    "gemma2_9b", "gemma3_12b", "granite_20b", "pixtral_12b",
                    "musicgen_large", "deepseek_v2_236b",
                    "deepseek_v3_671b"]

_ALIASES = {"stablelm-1.6b": "stablelm_1_6b", "xlstm-350m": "xlstm_350m",
            "jamba-v0.1-52b": "jamba_v0_1_52b", "gemma2-9b": "gemma2_9b",
            "gemma3-12b": "gemma3_12b", "granite-20b": "granite_20b",
            "pixtral-12b": "pixtral_12b",
            "musicgen-large": "musicgen_large",
            "deepseek-v2-236b": "deepseek_v2_236b",
            "deepseek-v3-671b": "deepseek_v3_671b"}


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
