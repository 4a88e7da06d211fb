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
order.  Ranks on the CPU split the caller's intra-op threads between
them (the host's cores, unless the caller holds itself to fewer).
``device`` is every rank's device: "cpu" (asked for, as the tests do);
"cuda:0" puts all ranks on one card; "cuda" gives rank r the
card r mod the cards present (all on the one card of a one-card
machine), as NCCL needs.  With no ``device`` the ranks run on the cards
as with "cuda", whatever the backend, and the launch raises when there
is none, as every entry point of the port does.

A rank that returned waits for every rank's work to end (a barrier)
before it tears its group down.  A rank that fails makes the launch
raise with the end of its log.  Once
one rank has failed, the others get ``FAIL_GRACE_S`` seconds to end on
their own before they are killed, and the rank reported is the first to
end with a Python error (a positive exit code): not a peer that aborted
when it lost that rank, nor one the launch killed.  A rank whose
``work`` raised says so in a file before its teardown: the first to say
so is the rank reported (a peer whose collective broke when that rank
left raises after it, and may end first), and it is not killed at the
grace's end but ends on its own (or at ``timeout``), so that a slow
teardown on a loaded host cannot hide the rank that failed.
A rank that wrote its result has done its work: a crash in its own
teardown after that (an abort at exit) fails nothing.  A launch that
outlives ``timeout`` seconds is killed and raises.  Nothing is retried
or switched.
"""
from __future__ import annotations

import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence


def _src_dir() -> str:
    import repro_torch
    return os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))


def spec_device(device: Optional[str]) -> str:
    """The device string the ranks are given: "cuda" (spread over the
    cards, :func:`rank_device`) when none was asked for, which raises
    without a card; else the one asked for."""
    from ..device import resolve_device
    card = resolve_device(device)    # no device: the card, or raise
    return "cuda" if device is None else str(card)


def rank_device(device: str, rank: int, n_cards: int) -> str:
    """Rank ``rank``'s device from the spec's: "cuda" is card
    ``rank mod n_cards``; anything else is taken as it is."""
    return f"cuda:{rank % n_cards}" if device == "cuda" else device


#: seconds the other ranks are given to end on their own once one rank
#: has failed, before they are killed
FAIL_GRACE_S = 5.0


def _first_failure(exits: Sequence[int], codes: Sequence[int],
                   raised: Sequence[int] = ()) -> int:
    """The rank to report of a failed launch, given each rank's exit
    code (0 for a rank that returned its result): the first of
    ``raised`` (the ranks whose work raised, in the order they said so:
    a peer that lost that rank raises after it); else the first in
    ``exits`` (ranks in the order they ended on their own) with a
    positive code, a Python error; else the first to end with a signal
    (an abort after a peer left); else a rank that was killed."""
    for r in raised:
        if codes[r]:
            return r
    for r in exits:
        if codes[r] > 0:
            return r
    for r in exits:
        if codes[r]:
            return r
    return next(r for r, c in enumerate(codes) if c)


def run_ranks(target: str, world: int, *, backend: str = "gloo",
              device: Optional[str] = None,
              kwargs: Optional[Dict[str, Any]] = None,
              timeout: float = 600.0,
              paths: Sequence[str] = ()) -> List[Any]:
    """Run ``target`` ("module:function") on ``world`` ranks; returns
    each rank's result.  ``paths`` are prepended to the ranks' module
    search path."""
    import torch
    device = spec_device(device)
    tmp = tempfile.mkdtemp(prefix="repro_ranks_")
    try:
        threads = min(torch.get_num_threads(), os.cpu_count() or 1)
        spec = {"target": target, "world": world, "backend": backend,
                "device": device, "kwargs": kwargs or {},
                "threads": max(1, threads // world),
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
        result = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world)]
        raised = [os.path.join(tmp, f"rank{r}.err") for r in range(world)]
        exits: List[int] = []             # ranks in the order they ended

        def failed(r: int) -> bool:
            # a rank whose result is written has done its work: an exit
            # code from its teardown after that is not its failure
            return bool(procs[r].returncode) and \
                not os.path.exists(result[r])
        try:
            grace, killed = None, set()
            while len(exits) + len(killed) < world:
                for r, p in enumerate(procs):
                    if r not in exits and r not in killed \
                            and p.poll() is not None:
                        exits.append(r)
                now = time.monotonic()
                if grace is None and any(map(failed, exits)):
                    # one rank failed: the others get a moment to end on
                    # their own, so that the order they ended in shows
                    # which failed first
                    grace = now + FAIL_GRACE_S
                if grace is not None and now > grace:
                    # past the grace, only ranks whose work raised are
                    # left to end on their own
                    for r, p in enumerate(procs):
                        if r not in exits and r not in killed \
                                and not os.path.exists(raised[r]):
                            p.kill()
                            p.wait()
                            killed.add(r)
                if now > deadline:
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
        codes = [p.returncode if failed(r) else 0
                 for r, p in enumerate(procs)]
        if any(codes):
            order = sorted((os.stat(raised[r]).st_mtime_ns, r)
                           for r in range(world) if os.path.exists(raised[r]))
            r = _first_failure(exits, codes, [r for _, r in order])
            with open(os.path.join(tmp, f"rank{r}.log"), "rb") as f:
                tail = f.read()[-6000:].decode(errors="replace")
            raise RuntimeError(f"{target} failed on rank {r} of {world} "
                               f"(exit {codes[r]}):\n{tail}")
        out = []
        for r in range(world):
            with open(result[r], "rb") as f:
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
        device = rank_device(device, rank, torch.cuda.device_count())
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    else:
        # the ranks share the caller's cores: intra-op threads beyond a
        # rank's share only contend
        torch.set_num_threads(spec["threads"])
    init_distributed(rank, spec["world"], spec["init"], spec["backend"])
    try:
        mesh = make_mesh(device=device)
        mod, fn = spec["target"].split(":")
        try:
            result = getattr(importlib.import_module(mod), fn)(
                mesh, **spec["kwargs"])
        except BaseException:
            # the launcher waits for a rank whose work raised (its
            # teardown may be slow) instead of killing it at the grace
            with open(os.path.join(os.path.dirname(spec_path),
                                   f"rank{rank}.err"), "w") as f:
                f.write(traceback.format_exc())
            raise
        out = os.path.join(os.path.dirname(spec_path), f"rank{rank}.pkl")
        with open(out + ".tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(out + ".tmp", out)
        # no rank leaves before every rank's work has ended: a group that
        # work made returns on one rank while its peer may still be
        # connecting to it, and a rank that left at once would close
        # that connection under the peer (gloo's connectFullMesh:
        # "Connection closed by peer")
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
