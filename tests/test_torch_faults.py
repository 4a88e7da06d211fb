"""The port's fault harness (``repro_torch.distributed.faults``) against
the reference's (``repro.distributed.faults``), and its sites in the
port's checkpoint commit protocol.

Each scripted run of host fault sites goes through both harnesses armed
with the same specs: the same calls must raise the same kinds, and the
same events must fire in the same order with the same details.
``corrupt_slots`` must write byte-identical words and record the same
slots for the same seed, site, step, device and range, on f32 and bf16
payloads.  The checkpoint chaos tests are the reference's
(``tests/test_faults.py``), on the port's ``save_checkpoint``."""
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import faults as jf
from repro.distributed.checkpoint import save_checkpoint as j_save
from repro_torch.distributed import faults as tf
from repro_torch.distributed.checkpoint import (restore_checkpoint,
                                                save_checkpoint,
                                                verify_restored)
from repro_torch.distributed.resilience import with_retries
from test_torch_hygiene import limit_torch_threads  # noqa: F401


def _run(mod, specs, calls, seed=0):
    """Each (site, step) of ``calls`` through ``mod.maybe_fail`` under
    ``mod.inject(*specs)``: what each call raised (or None) and the
    events, as plain tuples."""
    outcomes = []
    with mod.inject(*(mod.FaultSpec(**s) for s in specs),
                    seed=seed) as inj:
        for site, step in calls:
            try:
                mod.maybe_fail(site, step)
                outcomes.append(None)
            except mod.FaultError as e:
                outcomes.append((type(e).__name__, str(e)))
    events = [(e.site, e.kind, e.step, e.device, e.detail)
              for e in inj.events]
    return outcomes, events


def _same_as_reference(specs, calls):
    got = _run(tf, specs, calls)
    assert got == _run(jf, specs, calls)
    return got


# ---------------------------------------------------------------------------
# the injector
# ---------------------------------------------------------------------------
def test_spec_times_and_skip():
    """A spec skips its first `skip` matches, fires `times` times, and is
    inert afterwards."""
    outcomes, events = _same_as_reference(
        [dict(site="train:step", kind="error", skip=1, times=2)],
        [("train:step", 0), ("train:step", 1), ("train:step", 1),
         ("train:step", 2)])
    assert outcomes[0] is None and outcomes[3] is None
    assert [o[0] for o in outcomes[1:3]] == ["FaultError"] * 2
    assert [e[1] for e in events] == ["error", "error"]


def test_step_and_site_filtering():
    outcomes, events = _same_as_reference(
        [dict(site="train:step", kind="error", step=5)],
        [("train:step", 4), ("ckpt:fsync", 5), ("train:step", 5),
         ("train:step", 5)])
    assert outcomes[:2] == [None, None] and outcomes[3] is None
    assert outcomes[2][0] == "FaultError"
    assert [e[2] for e in events] == [5]


def test_kill_and_delay_kinds():
    outcomes, events = _same_as_reference(
        [dict(site="train:step", kind="kill", device=2)],
        [("train:step", 3)])
    assert outcomes[0][0] == "DeviceLossError"
    assert issubclass(tf.DeviceLossError, tf.FaultError)
    assert issubclass(tf.FaultError, OSError)
    t0 = time.monotonic()
    outcomes, events = _same_as_reference(
        [dict(site="train:straggler", kind="delay", delay_s=0.02)],
        [("train:straggler", 0)])
    assert time.monotonic() - t0 >= 0.04          # slept in both
    assert outcomes == [None] and events[0][1] == "delay"


def test_several_specs_and_payload_kinds_never_raise():
    """The first armed spec matching wins; a payload spec never fires at
    a host site, and ``payload_fault`` consumes it."""
    specs = [dict(site="ckpt:rename", kind="error", times=0, skip=2),
             dict(site="ckpt:rename", kind="bitflip", times=1),
             dict(site="ckpt:fsync", kind="error", message="disk gone")]
    calls = [("ckpt:rename", None)] * 4 + [("ckpt:fsync", 7)] * 2
    outcomes, events = _same_as_reference(specs, calls)
    assert outcomes[:2] == [None, None]
    assert outcomes[4] == ("FaultError", "disk gone")
    for mod in (tf, jf):
        with mod.inject(mod.FaultSpec(site="collective:syrk",
                                      kind="nan", device=1)) as inj:
            mod.maybe_fail("collective:syrk", 0)
            sp = mod.payload_fault("collective:syrk", 0)
            assert sp.kind == "nan" and sp.device == 1
            assert mod.payload_fault("collective:syrk", 0) is None
        assert inj.events == []
    with pytest.raises(ValueError, match="unknown fault kind"):
        tf.FaultSpec(site="x", kind="melt")


def test_env_activation(monkeypatch):
    """REPRO_FAULTS arms either package's injector from the environment
    alone; the port writes the reference's environment."""
    specs = [tf.FaultSpec(site="train:step", kind="kill", step=7)]
    env = tf.env_dict(specs, seed=9)
    assert env == jf.env_dict([jf.FaultSpec(site="train:step", kind="kill",
                                            step=7)], seed=9)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for mod in (tf, jf):
        # each package caches the injector it built from the environment;
        # dropped after the test, so the spent spec does not reach a
        # later test in this process that arms the same environment
        monkeypatch.setattr(mod, "_ENV_CACHE", (None, None))
        mod.maybe_fail("train:step", 6)           # wrong step: no-op
        with pytest.raises(mod.DeviceLossError):
            mod.maybe_fail("train:step", 7)
        assert mod.active().seed == 9
    monkeypatch.delenv(tf.ENV_SPECS)
    assert tf.active() is None


# ---------------------------------------------------------------------------
# corrupt_slots: the reference's bytes
# ---------------------------------------------------------------------------
def _payload(dtype, n=96, seed=0):
    """Words in (-2, 2), so a flipped exponent bit gives NaNs of both
    signs and infinities as well as large finite values."""
    x = np.random.default_rng(seed).uniform(-2, 2, n).astype(np.float32)
    x[:4] = [1.0, -1.0, 0.0, -0.0]
    j = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16"
                              else jnp.float32)
    if dtype == "bfloat16":
        t = torch.from_numpy(np.asarray(j).view(np.int16).copy()) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(x.copy())
    return j, t


def _bits(a) -> bytes:
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        return a.numpy().tobytes()
    return np.asarray(a).tobytes()


def _corrupt(mod, vec, kind, seed, site, step, device, lo, hi, armed):
    spec = mod.FaultSpec(site=site, kind=kind, device=device)
    if not armed:
        return mod.corrupt_slots(vec, lo, hi, spec, site, step), []
    with mod.inject(spec, seed=seed) as inj:
        sp = mod.payload_fault(site, step)
        out = mod.corrupt_slots(vec, lo, hi, sp, site, step)
    return out, [(e.kind, e.step, e.device, e.detail) for e in inj.events]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["bitflip", "nan"])
@pytest.mark.parametrize("seed,site,step,device,lo,hi,armed", [
    (11, "collective:syrk", 2, 3, 8, 40, True),
    (0, "collective:symm", None, None, 0, 96, True),
    (5, "collective:syr2k", 9, 0, 90, 95, True),     # fewer than 8 slots
    (0, "collective:syrk", 1, 1, 17, 17, True),      # empty range: 1 slot
    (0, "collective:syrk", 4, 2, 3, 60, False),      # no injector armed
])
def test_corrupt_slots_matches_reference(dtype, kind, seed, site, step,
                                         device, lo, hi, armed):
    j, t = _payload(dtype)
    before = _bits(t)
    want, jev = _corrupt(jf, j, kind, seed, site, step, device, lo, hi,
                         armed)
    got, tev = _corrupt(tf, t, kind, seed, site, step, device, lo, hi,
                        armed)
    assert got.dtype == t.dtype and got.device == t.device
    assert _bits(got) == _bits(want)
    assert tev == jev and len(tev) == int(armed)
    assert _bits(t) == before                        # never in place
    words = [np.frombuffer(b, np.uint8).reshape(len(t), -1)
             for b in (before, _bits(got))]
    changed = np.nonzero((words[0] != words[1]).any(axis=1))[0]
    assert 1 <= changed.size <= (1 if kind == "nan" else 8)
    assert lo <= changed.min() and changed.max() < max(hi, lo + 1)


def test_corrupt_slots_deterministic():
    """The pattern is a pure function of (seed, site, step, device): the
    same coordinates corrupt the same slots to the same values, another
    seed differently."""
    _, t = _payload("float32")
    outs = [_corrupt(tf, t, "bitflip", s, "collective:syrk", 2, 3, 8, 40,
                     True)[0] for s in (11, 11, 12)]
    assert _bits(outs[0]) == _bits(outs[1])
    assert _bits(outs[0]) != _bits(outs[2])
    changed = torch.nonzero(outs[0].view(torch.int32)
                            != t.view(torch.int32)).flatten()
    assert 1 <= changed.numel() <= 8
    assert changed.min() >= 8 and changed.max() < 40


# ---------------------------------------------------------------------------
# with_retries under injected faults
# ---------------------------------------------------------------------------
def test_with_retries_heals_an_injected_transient_fault():
    seen = []
    with tf.inject(tf.FaultSpec(site="serve:refresh", times=1)) as inj:
        out = with_retries(lambda: tf.maybe_fail("serve:refresh") or "ok",
                           retries=2, backoff=0.001,
                           on_retry=lambda a, e: seen.append(a))
    assert out == "ok" and seen == [0] and len(inj.events) == 1


def test_with_retries_exhausts_and_reraises_a_persistent_fault():
    with tf.inject(tf.FaultSpec(site="serve:refresh", times=0)) as inj:
        with pytest.raises(tf.FaultError, match="serve:refresh"):
            with_retries(tf.maybe_fail, "serve:refresh", retries=2,
                         backoff=0.001)
    assert len(inj.events) == 3                      # 1 try + 2 retries


# ---------------------------------------------------------------------------
# checkpoint chaos (the reference's tests/test_faults.py, on the port)
# ---------------------------------------------------------------------------
@pytest.fixture()
def small():
    rng = np.random.default_rng(3)
    return {"w": torch.from_numpy(rng.standard_normal((6, 6))).float(),
            "step_count": torch.tensor(4, dtype=torch.int32)}


def _io_faults(mod):
    return (mod.FaultSpec(site="ckpt:fsync", kind="error", times=2),
            mod.FaultSpec(site="ckpt:rename", kind="error", times=1))


def test_checkpoint_transient_io_faults_absorbed(tmp_path, small):
    """fsync / rename hiccups inside the retry budget never surface: the
    save commits, the restored tree crc-verifies, and the same faults
    fire in the same order as in the reference's save."""
    with tf.inject(*_io_faults(tf)) as inj:
        save_checkpoint(str(tmp_path / "t"), 3, small)
    with jf.inject(*_io_faults(jf)) as jinj:
        j_save(str(tmp_path / "j"), 3,
               {k: jnp.asarray(v.numpy()) for k, v in small.items()})
    assert [(e.site, e.detail) for e in inj.events] == \
        [(e.site, e.detail) for e in jinj.events]
    assert [e.site for e in inj.events] == ["ckpt:fsync"] * 2 + \
        ["ckpt:rename"]
    step, back = restore_checkpoint(str(tmp_path / "t"), small)
    assert step == 3
    vr = verify_restored(str(tmp_path / "t"), back, step=step)
    assert vr["checked"] == 2 and not vr["mismatches"]


def test_checkpoint_crash_window_old_recovery(tmp_path, small):
    """Re-saving the same step moves final -> .old before the tmp rename;
    a persistent failure in that window loses the final dir, but the
    read path recovers the complete .old copy."""
    save_checkpoint(str(tmp_path), 2, small)
    tree2 = {"w": small["w"] + 1.0, "step_count": small["step_count"]}
    with pytest.raises(tf.FaultError):
        with tf.inject(tf.FaultSpec(site="ckpt:rename", kind="error",
                                    skip=1, times=0)):
            save_checkpoint(str(tmp_path), 2, tree2)
    assert not (tmp_path / "step_00000002").is_dir()
    assert (tmp_path / "step_00000002.old").is_dir()
    step, back = restore_checkpoint(str(tmp_path), small)
    assert step == 2 and torch.equal(back["w"], small["w"])
    assert not verify_restored(str(tmp_path), back,
                               step=step)["mismatches"]
