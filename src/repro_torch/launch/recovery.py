"""Chaos recovery: device death -> elastic resume (port of
:mod:`repro.launch.recovery`).

    PYTHONPATH=src python -m repro_torch.launch.recovery --device cpu \
        --steps 4 --kill-step 3 -- --d-model 64 --d-ff 128 --ckpt-every 2

    PYTHONPATH=src python -m repro_torch.launch.recovery --device cpu \
        --devices 4 --devices-after 2 --steps 4 --kill-step 3 -- \
        --ckpt-every 2

One call to :func:`run_recovery` runs the whole sequence, each phase a
subprocess ``python -m repro_torch.launch.train`` (``PYTHONPATH=src``),
as a restart looks to a scheduler:

  1. **Phase 1**: train on ``devices`` ranks (``--devices``, the mesh
     planned with ``--max-model``) with an armed ``train:step`` *kill*
     fault (:mod:`repro_torch.distributed.faults`, delivered through
     ``REPRO_FAULTS`` so the injection is reproducible from the
     environment alone).  At ``kill_step`` every rank stops after rank
     0 committed its pending checkpoint writes, and the trainer raises
     :class:`~repro_torch.distributed.faults.DeviceLossError`.
  2. **Phase 2**: restart the same job without the fault on
     ``devices_after`` ranks, the surviving world, whose mesh the
     trainer plans from that count.  ``restore_checkpoint`` gives each
     rank its block of the saved state (the packed Gram EMAs travel as
     triangle words, each rank taking its slice) and
     ``verify_restored`` gathers the placed blocks back and checks every
     leaf against the checkpoint's crc before a step runs; the run then
     completes.

Runs on the card unless ``device="cpu"`` (``--device cpu``) is given,
and raises when there is none; a mesh's ranks share the card (gloo).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time
from typing import Any, Dict, Optional, Sequence

from ..device import resolve_device
from ..distributed import faults

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))


def _run_phase(ckpt_dir: str, ndev: int, extra_args: Sequence[str],
               extra_env: Optional[Dict[str, str]] = None,
               *, steps: int, global_batch: int, seq_len: int,
               layers: int, ckpt_every: int, optimizer: str,
               track_gram: bool, timeout: float, device: Optional[str],
               max_model: int) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env.pop(faults.ENV_SPECS, None)            # phase 2 runs fault-free
    if extra_env:
        env.update(extra_env)
    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           *(["--device", device] if device else []),
           "--devices", str(ndev),
           "--steps", str(steps), "--global-batch", str(global_batch),
           "--seq-len", str(seq_len), "--layers", str(layers),
           "--ckpt-dir", ckpt_dir, "--ckpt-every", str(ckpt_every),
           "--log-every", str(max(ckpt_every, 1)),
           "--max-model", str(max_model),
           "--optimizer", optimizer]
    if track_gram:
        cmd.append("--track-gram")
    cmd += list(extra_args)
    return subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=timeout)


def _port_line(stdout: str) -> Dict[str, Any]:
    """The trainer's ``[train] port:`` line (losses, kernel launches,
    checkpoint seconds; on a mesh rank 0's words), the last one printed,
    and a mesh run's ``[train] ranks:`` line as ``"ranks"`` (every
    rank's losses, kernel launches and checkpoint words)."""
    out: Dict[str, Any] = {}
    for tag in ("port", "ranks"):
        found = re.findall(rf"^\[train\] {tag}: (\{{.*\}})$", stdout,
                           re.M)
        if found:
            got = json.loads(found[-1])
            out.update(got if tag == "port" else {"ranks": got})
    return out


def run_recovery(ckpt_dir: str, *, devices: int = 1,
                 devices_after: int = 1, steps: int = 40,
                 kill_step: int = 20, global_batch: int = 12,
                 seq_len: int = 128, layers: int = 2,
                 ckpt_every: int = 10, optimizer: str = "muon",
                 track_gram: bool = True, seed: int = 0,
                 timeout: float = 900.0, device: Optional[str] = None,
                 max_model: int = 2,
                 extra_args: Sequence[str] = ()) -> Dict[str, Any]:
    """Kill a device mid-train, restart on ``devices_after`` ranks,
    resume, finish.

    ``extra_args`` go to both phases' trainer (``["--full"]`` with
    ``layers=0`` trains a config at its published widths and depth);
    ``max_model`` caps both meshes' model axis (the reference's
    ``--max-model 2``).
    Returns the reference's summary dict::

        {"killed": True,            # phase 1 died of DeviceLossError
         "kill_step": 20,
         "resumed_step": 20,        # phase 2 restart point
         "verified_leaves": 46,     # verify_restored coverage
         "mismatches": 0,           # crc-exact incl. packed Gram EMAs
         "completed": True,         # phase 2 ran to `steps`
         "final": {...}}            # phase 2 [train] done payload

    plus ``"phases"``: each phase's wall seconds and its ``[train]
    port:`` line (losses, kernel launches, phase 2's restore and verify
    seconds).  Raises ``RuntimeError`` when either phase deviates from
    the script (no injected death, failed restart, restore mismatch).
    """
    resolve_device(device)             # no device and no card: raise
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    phase_kw = dict(steps=steps, global_batch=global_batch,
                    seq_len=seq_len, layers=layers,
                    ckpt_every=ckpt_every, optimizer=optimizer,
                    track_gram=track_gram, timeout=timeout, device=device,
                    max_model=max_model)

    # -- phase 1: armed kill at kill_step --------------------------------
    chaos_env = faults.env_dict(
        [faults.FaultSpec(site="train:step", kind="kill",
                          step=kill_step)], seed=seed)
    t0 = time.perf_counter()
    p1 = _run_phase(ckpt_dir, devices, extra_args, chaos_env, **phase_kw)
    t1 = time.perf_counter()
    if p1.returncode == 0 or "injected device loss" not in p1.stderr:
        raise RuntimeError(
            "phase 1 did not die of the injected device loss:\n"
            + p1.stderr[-2000:])

    # -- phase 2: resume on the surviving world -------------------------
    p2 = _run_phase(ckpt_dir, devices_after, extra_args, None, **phase_kw)
    t2 = time.perf_counter()
    if p2.returncode != 0:
        raise RuntimeError("phase 2 (elastic resume) failed:\n"
                           + p2.stderr[-2000:])
    m_res = re.search(r"resumed from step (\d+)", p2.stdout)
    m_ver = re.search(r"restore verified: (\d+) leaves, (\d+) mismatch",
                      p2.stdout)
    m_done = re.search(r"\[train\] done: (\{.*\})", p2.stdout)
    if not (m_res and m_ver and m_done):
        raise RuntimeError("phase 2 output missing resume/verify/done "
                           "markers:\n" + p2.stdout[-2000:])
    mismatches = int(m_ver.group(2))
    if mismatches:
        raise RuntimeError(
            f"restored state NOT bit-exact: {mismatches} leaf "
            f"crc mismatches\n" + p2.stdout[-2000:])
    final = json.loads(m_done.group(1))
    return {"killed": True, "kill_step": kill_step,
            "resumed_step": int(m_res.group(1)),
            "verified_leaves": int(m_ver.group(1)),
            "mismatches": mismatches,
            "completed": final["steps"] + int(m_res.group(1)) == steps,
            "final": final,
            "phases": [{"s": t1 - t0, **_port_line(p1.stdout)},
                       {"s": t2 - t1, **_port_line(p2.stdout)}]}


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        description="chaos recovery: device kill -> resume; arguments "
                    "after '--' go to both phases' trainer")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint dir (default: a fresh temp dir, "
                         "deleted afterwards)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run "
                         "on the host)")
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--devices-after", type=int, default=1)
    ap.add_argument("--max-model", type=int, default=2)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--kill-step", type=int, default=20)
    ap.add_argument("train_args", nargs="*")
    args = ap.parse_args(argv)
    import tempfile
    tmp = None if args.ckpt_dir else tempfile.mkdtemp(prefix="recovery_")
    try:
        out = run_recovery(args.ckpt_dir or tmp, devices=args.devices,
                           devices_after=args.devices_after,
                           steps=args.steps, kill_step=args.kill_step,
                           device=args.device, max_model=args.max_model,
                           extra_args=args.train_args)
    finally:
        if tmp:
            shutil.rmtree(tmp, ignore_errors=True)
    print("[recovery]", json.dumps(out))


if __name__ == "__main__":
    main()
