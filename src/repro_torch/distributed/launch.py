"""Run one function on P ranks of a ``torch.distributed`` group, a
process each:

    from repro_torch.distributed.launch import run_ranks
    results = run_ranks("mypkg.mymod:work", 4, backend="gloo",
                        device="cpu", kwargs={"n1": 64})   # on the host

Each rank initialises the group (``init_method=file://`` in a fresh
temporary directory, so concurrent launches never share an address),
builds the :class:`~repro_torch.distributed.mesh.Mesh` of one axis
``"x"`` of all ranks (``work`` may build others with ``make_mesh``),
calls ``work(mesh, **kwargs)``
and returns its result (anything picklable) to the caller, in rank
order.  Ranks on the CPU split the host's cores between them (intra-op
threads).  ``device`` is every rank's device: "cpu" (asked for, as the
tests do); "cuda:0" puts all ranks on one card, as a one-card machine
must with gloo; "cuda" gives rank r the card r, as NCCL needs.  With no
``device`` the ranks run on the card (the current one with gloo, one
each with NCCL), and the launch raises when there is none, as every
entry point of the port does.  A rank that fails makes the launch
raise with the end of its log; a launch that outlives ``timeout``
seconds is killed and raises.  Nothing is retried or switched.
"""
from __future__ import annotations

import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence


def _src_dir() -> str:
    import repro_torch
    return os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))


def run_ranks(target: str, world: int, *, backend: str = "gloo",
              device: Optional[str] = None,
              kwargs: Optional[Dict[str, Any]] = None,
              timeout: float = 600.0,
              paths: Sequence[str] = ()) -> List[Any]:
    """Run ``target`` ("module:function") on ``world`` ranks; returns
    each rank's result.  ``paths`` are prepended to the ranks' module
    search path."""
    from ..device import resolve_device
    card = resolve_device(device)    # no device: the card, or raise
    device = "cuda" if device is None and backend == "nccl" else str(card)
    tmp = tempfile.mkdtemp(prefix="repro_ranks_")
    try:
        spec = {"target": target, "world": world, "backend": backend,
                "device": device, "kwargs": kwargs or {},
                "paths": list(paths),
                "init": "file://" + os.path.join(tmp, "rendezvous")}
        spec_path = os.path.join(tmp, "spec.pkl")
        with open(spec_path, "wb") as f:
            pickle.dump(spec, f)
        child_env = dict(os.environ)
        child_env["PYTHONPATH"] = os.pathsep.join(
            [_src_dir()] + [p for p in child_env.get("PYTHONPATH", "")
                            .split(os.pathsep) if p])
        procs, logs = [], []
        for r in range(world):
            log = open(os.path.join(tmp, f"rank{r}.log"), "wb")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.distributed.launch",
                 spec_path, str(r)], stdout=log, stderr=subprocess.STDOUT,
                env=child_env))
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                if any(p.returncode not in (None, 0) for p in procs):
                    break                  # one rank failed: stop the rest
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{target} on {world} ranks did not "
                                       f"finish in {timeout:.0f} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in logs:
                log.close()
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            # the first rank that failed on its own, not one killed after
            r = min(failed, key=lambda i: procs[i].returncode < 0)
            with open(os.path.join(tmp, f"rank{r}.log"), "rb") as f:
                tail = f.read()[-6000:].decode(errors="replace")
            raise RuntimeError(f"{target} failed on rank {r} of {world} "
                               f"(exit {procs[r].returncode}):\n{tail}")
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(spec_path: str, rank: int) -> None:
    import importlib

    import torch
    import torch.distributed as dist

    from ..device import ieee_f32
    from .mesh import init_distributed, make_mesh
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    sys.path[:0] = spec["paths"]
    ieee_f32()
    device = spec["device"]
    if device == "cuda":
        device = f"cuda:{rank % torch.cuda.device_count()}"
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    else:
        # the ranks share the host's cores: intra-op threads beyond a
        # rank's share only contend
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // spec["world"]))
    init_distributed(rank, spec["world"], spec["init"], spec["backend"])
    try:
        mesh = make_mesh(device=device)
        mod, fn = spec["target"].split(":")
        result = getattr(importlib.import_module(mod), fn)(mesh,
                                                           **spec["kwargs"])
        out = os.path.join(os.path.dirname(spec_path), f"rank{rank}.pkl")
        with open(out + ".tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(out + ".tmp", out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
