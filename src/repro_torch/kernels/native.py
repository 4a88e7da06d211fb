"""Build and bind the hand-written CUDA kernels (``repro_torch/csrc``).

Each ``.cu`` source is compiled by its own ``nvcc`` process (all started
together) into a shared library with a plain C interface, loaded with
``ctypes``.  Nothing is built at import: the first launch on a CUDA
tensor calls :func:`load`, which builds what is missing.  Libraries are
named by a hash of their sources and flags, so an edited kernel is
rebuilt and a current one is reused.

Build directory: ``$REPRO_TORCH_BUILD_DIR``, default ``build/kernels``
under the repository root (listed in ``.gitignore``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("rank_update.cu", "sym_stream.cu", "slstm_scan.cu")
HEADERS = ("tile_mma.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
#: C signature of every entry point, by source: {name: argtypes}
SIGNATURES = {
    "rank_update.cu": {
        "repro_rank_update": [_I, _I, _P, _P, _I, _I, _I, _P, _I, _P, _F,
                              _F, _F, _P, _I, _P]},
    "sym_stream.cu": {
        "repro_sym_stream": [_I, _I, _I, _P, _P, _I, _I, _I, _P, _F, _P,
                             _I, _P],
        "repro_sym_stream_narrow": [_I, _P, _P, _I, _I, _P, _P, _F, _P, _P,
                                    _I, _P]},
    "slstm_scan.cu": {
        "repro_slstm_scan_quad": [_I, _P, _L, _L] + [_P] * 6 + [_I] * 3
        + [_P],
        "repro_slstm_scan_bwd": [_I] + [_P] * 11 + [_I] * 3 + [_P],
        "repro_slstm_scan": [_I] + [_P, _L, _L, _L] * 4 + [_P] * 5
        + [_I] * 3 + [_P],
        "repro_slstm_ring_bytes": [_I]},
}

_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
_FUNCS: Dict[str, ctypes._CFuncPtr] = {}
#: what the last :func:`load` did: seconds spent building and the
#: compiler's resource report (registers, shared memory, spills)
BUILD_INFO: Dict[str, object] = {"seconds": 0.0, "built": [], "ptxas": ""}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parent.parent.parent / "build" / "kernels"


def nvcc_path() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        home = os.environ.get(var)
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the repro_torch CUDA kernels")


def _digest(source: str) -> str:
    h = hashlib.sha256()
    for name in (source,) + HEADERS:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _lib_path(source: str) -> Path:
    return build_dir() / f"{Path(source).stem}-{_digest(source)}.so"


def load() -> Dict[str, ctypes._CFuncPtr]:
    """Build (in parallel) whatever library is missing and return the
    bound C entry points by function name.  Thread-safe: the serving
    cache's refresh thread and the decode thread may both get here."""
    with _LOCK:
        if _FUNCS:
            return _FUNCS
        out = build_dir()
        out.mkdir(parents=True, exist_ok=True)
        todo = [s for s in SOURCES if not _lib_path(s).exists()]
        t0 = time.perf_counter()
        procs = []
        for src in todo:
            tmp = _lib_path(src).with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o",
                   str(tmp), str(CSRC / src)]
            procs.append((src, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        reports = []
        failed: Optional[str] = None
        for src, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed = failed or f"nvcc failed on {src}:\n{log}"
                continue
            os.replace(tmp, _lib_path(src))
            reports.append(f"== {src}\n{log}")
        if failed:
            raise RuntimeError(failed)
        BUILD_INFO.update(seconds=time.perf_counter() - t0, built=todo,
                          ptxas="\n".join(reports))
        for src in SOURCES:
            lib = ctypes.CDLL(str(_lib_path(src)))
            for name, argtypes in SIGNATURES[src].items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _FUNCS[name] = fn
        return _FUNCS


def count_launch(fn) -> None:
    """Add one to a wrapper's ``launches`` count; called right after
    the wrapper's kernel launched, and nowhere else."""
    with _COUNT_LOCK:
        fn.launches += 1


def zero_launch_counts(fns) -> None:
    with _COUNT_LOCK:
        for fn in fns:
            fn.launches = 0


def read_launch_counts(fns) -> Dict[str, int]:
    with _COUNT_LOCK:
        return {fn.__name__: fn.launches for fn in fns}


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a launch error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
