"""The trainer's failure sites and the kill -> resume run of the port
(``repro_torch.launch.train`` ``--fail-at``, the ``train:step`` /
``train:straggler`` fault sites, ``repro_torch.launch.recovery``), on
the CPU at a reduced stablelm (1 layer, d_model 64).

As the reference's (``repro/launch/train.py:143-160``): ``--fail-at N``
and a ``train:step`` kill fire before step N of a run that did not
resume, after the checkpoints still being written have committed; a
resume from that checkpoint equals the uninterrupted run bit for bit;
``train:straggler`` delays past the monitor's warm-up and patience
escalate to ``warn`` then ``checkpoint``.  ``run_recovery`` returns the
reference's summary keys."""
import os
import time

import pytest
import torch

from repro_torch.distributed import faults
from repro_torch.distributed.checkpoint import read_manifest
from repro_torch.launch import train as ttrain
from repro_torch.launch.recovery import run_recovery
from test_torch_hygiene import limit_torch_threads  # noqa: F401

#: the reference's run_recovery summary keys (repro/launch/recovery.py:125)
RECOVERY_KEYS = {"killed", "kill_step", "resumed_step", "verified_leaves",
                 "mismatches", "completed", "final"}


def _args(**kw):
    args = ttrain.build_argparser().parse_args([])
    for k, v in dict(device="cpu", steps=4, layers=1, d_model=64, d_ff=128,
                     global_batch=2, seq_len=16, loss_chunk=16,
                     log_every=1, optimizer="muon", ckpt_every=2).items():
        setattr(args, k, v)
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def _train(monkeypatch, **kw):
    """``train`` with its model kept: (summary, model)."""
    made = []
    init = ttrain.init_model

    def keep(cfg, seed, device):
        made.append(init(cfg, seed=seed, device=device))
        return made[-1]

    monkeypatch.setattr(ttrain, "init_model", keep)
    return ttrain.train(_args(**kw)), made[-1]


def _entries(d):
    return sorted(os.listdir(d))


def _slow_writes(monkeypatch):
    """Async checkpoint writes that are still running when the step
    loop reaches the failure (the raise must wait for them)."""
    from repro_torch.distributed import checkpoint
    write = checkpoint._write_logged

    def slow(*args):
        time.sleep(0.5)
        write(*args)

    monkeypatch.setattr(checkpoint, "_write_logged", slow)


def test_fail_at_raises_after_the_checkpoint_commits(monkeypatch, tmp_path,
                                                     capsys):
    d = str(tmp_path)
    _slow_writes(monkeypatch)
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        ttrain.train(_args(ckpt_dir=d, fail_at=3))
    assert _entries(d) == ["step_00000002"]           # no .tmp left
    assert read_manifest(d)["step"] == 2
    assert '[train] port: {"start_step": 0, "losses": [' \
        in capsys.readouterr().out


def test_kill_then_resume_is_bit_exact(monkeypatch, tmp_path):
    """A ``train:step`` kill at step 3 leaves step 2's checkpoint; the
    resumed run's losses, parameters and every checkpointed leaf equal
    the uninterrupted run's; a resumed run with ``--fail-at`` before its
    start does not fail again."""
    full, m_full = _train(monkeypatch, ckpt_dir=str(tmp_path / "u"))
    d = str(tmp_path / "r")
    _slow_writes(monkeypatch)
    with faults.inject(faults.FaultSpec(site="train:step", kind="kill",
                                        step=3)) as inj:
        with pytest.raises(faults.DeviceLossError,
                           match="injected device loss at train:step"):
            ttrain.train(_args(ckpt_dir=d))
    assert [(e.site, e.step) for e in inj.events] == [("train:step", 3)]
    assert _entries(d) == ["step_00000002"]
    out, m_res = _train(monkeypatch, ckpt_dir=d, fail_at=1)
    assert out["resumed"] and out["start_step"] == 2 and out["steps"] == 2
    assert out["restore_verified"]["mismatches"] == []
    assert out["losses"] == full["losses"][2:]
    for a, b in zip(m_full.parameters(), m_res.parameters()):
        assert torch.equal(a, b)
    want = read_manifest(str(tmp_path / "u"))["leaves"]
    got = read_manifest(d)["leaves"]
    assert sorted(want) == sorted(got)
    assert [k for k in want if want[k]["crc"] != got[k]["crc"]] == []


def test_error_fault_before_a_step_raises_a_fault_error(tmp_path):
    """An ``error`` at ``train:step`` propagates as the reference's does
    (a FaultError, not a device loss)."""
    with faults.inject(faults.FaultSpec(site="train:step", kind="error",
                                        step=1)):
        with pytest.raises(faults.FaultError,
                           match="injected fault at train:step step 1"):
            ttrain.train(_args(ckpt_dir=str(tmp_path)))


class _Clock:
    """The step timer's and the delay fault's clock: it moves 1 ms a
    reading and by what sleeps on it, so the step times are the
    injected delays whatever the host's load."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1e-3
        return self.t

    def sleep(self, seconds):
        self.t += seconds


def test_straggler_delays_escalate_to_a_checkpoint(monkeypatch, tmp_path,
                                                   capsys):
    """Six delayed steps after the monitor's 8-step warm-up: the third
    gives ``warn``, the sixth ``checkpoint``, and the checkpoint of the
    state after that step is written."""
    from repro_torch.distributed import straggler
    clock = _Clock()
    monkeypatch.setattr(straggler, "time", clock)
    monkeypatch.setattr(faults, "time", clock)
    d = str(tmp_path)
    with faults.inject(faults.FaultSpec(site="train:straggler",
                                        kind="delay", delay_s=0.5, skip=8,
                                        times=6)) as inj:
        out = ttrain.train(_args(ckpt_dir=d, steps=15, ckpt_every=100,
                                 optimizer="adamw"))
    assert [e.step for e in inj.events] == list(range(8, 14))
    lines = [x for x in capsys.readouterr().out.splitlines()
             if x.startswith("[straggler]")]
    assert [x.split(":")[1].split()[0] for x in lines] == \
        ["warn", "checkpoint"]
    assert lines[1].startswith("[straggler] step 13: checkpoint")
    assert out["straggler_events"] == 2
    assert _entries(d) == ["step_00000014", "step_00000015"]


def test_run_recovery_on_the_host(tmp_path):
    out = run_recovery(str(tmp_path / "ckpt"), device="cpu", devices=1,
                       devices_after=1, steps=4, kill_step=3, ckpt_every=2,
                       global_batch=2, seq_len=16, layers=1,
                       optimizer="muon", track_gram=True, timeout=300,
                       extra_args=["--d-model", "64", "--d-ff", "128"])
    assert RECOVERY_KEYS <= set(out)
    assert out["killed"] and out["kill_step"] == 3
    assert out["resumed_step"] == 2 and out["mismatches"] == 0
    assert out["completed"] and out["verified_leaves"] > 0
    assert out["final"]["resumed"] and out["final"]["steps"] == 2
    p1, p2 = out["phases"]
    assert len(p1["losses"]) == 3 and p2["start_step"] == 2
    # phase 2 recomputes step 2 from the step-2 checkpoint
    assert p2["losses"][0] == p1["losses"][2]
    assert [p2["losses"][0], p2["losses"][-1]] == \
        [out["final"]["first_loss"], out["final"]["final_loss"]]
