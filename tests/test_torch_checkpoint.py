"""The port's checkpoints (``repro_torch.distributed.checkpoint``) on the
CPU: the reference's own checkpoint tests (``tests/test_distributed.py``,
``tests/test_faults.py``) replayed on the port, and both directions of
cross-reading with ``repro.distributed`` on a stablelm smoke model and
its Muon (with the packed Gram), AdamW and 8-bit AdamW states.

Every comparison is bitwise, apart from the reference tests' own 1e-2
on packed words narrowed to bf16."""
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.packing import PackedTriangle as JPacked
from repro.distributed import restore_checkpoint as j_restore
from repro.distributed import save_checkpoint as j_save
from repro.distributed import verify_restored as j_verify
from repro.models.model import init_params
from repro.optim import AdamW as JAdamW
from repro.optim import Muon as JMuon
from repro_torch.core.packing import (PackedTriangle, ShardedTriTiles,
                                      TriTiles, pack_tril)
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import (checkpoint_bytes, latest_step,
                                     read_manifest, restore_checkpoint,
                                     save_checkpoint, verify_restored,
                                     wait_for_saves, with_retries)
from repro_torch.models.model import from_jax_params
from repro_torch.optim import muon as tmuon
from repro_torch.optim.adamw import AdamW as TAdamW
from repro_torch.optim.gram import GramMonitor
from repro_torch.optim.muon import Muon as TMuon


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(8, 16, generator=g),
            "stack": {"b": torch.arange(5, dtype=torch.int32)},
            "scalars": (torch.tensor(3.5), 7)}


def _leaves(tree):
    return [v for _, v in ckpt._flatten(tree)]


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return type(a) is type(b) and a == b


# ---------------------------------------------------------------------------
# the reference's checkpoint tests, on the port
# ---------------------------------------------------------------------------
def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 12, t)
    step, back = restore_checkpoint(str(tmp_path), t)
    assert step == 12
    assert isinstance(back["scalars"], tuple) and back["scalars"][1] == 7
    assert all(map(_same, _leaves(t), _leaves(back)))


def test_checkpoint_retention_and_latest(tmp_path):
    for s in (1, 2, 3, 4):
        save_checkpoint(str(tmp_path), s, _tree(s), keep=2)
    assert latest_step(str(tmp_path)) == 4
    assert sorted(os.listdir(tmp_path)) == ["step_00000003",
                                            "step_00000004"]


def test_checkpoint_async(tmp_path):
    save_checkpoint(str(tmp_path), 9, _tree(), blocking=False)
    wait_for_saves()
    assert latest_step(str(tmp_path)) == 9


def test_checkpoint_async_snapshot_is_not_aliased(tmp_path, monkeypatch):
    """The train step updates parameters in place: an async save must
    hold the values of the moment it was called, even when the write
    starts only after the update."""
    model = from_jax_params(_smoke_np_params(), _smoke_cfgs()[1],
                            device="cpu")
    before = {k: v.clone() for k, v in model.stacked().items()}
    go = threading.Event()
    write = ckpt._write

    def late_write(*args):
        go.wait(30)
        return write(*args)

    monkeypatch.setattr(ckpt, "_write", late_write)
    save_checkpoint(str(tmp_path), 1, {"params": model.stacked()},
                    blocking=False)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    after = model.stacked()
    go.set()
    wait_for_saves()
    _, back = restore_checkpoint(str(tmp_path), {"params": after})
    for k, v in back["params"].items():
        assert torch.equal(v, before[k]), k
        assert not torch.equal(v, after[k]), k


def test_wait_for_saves_raises_a_writer_error(tmp_path, monkeypatch):
    def broken(*args):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_write", broken)
    save_checkpoint(str(tmp_path), 1, _tree(), blocking=False)
    with pytest.raises(OSError, match="disk full"):
        wait_for_saves()
    wait_for_saves()                       # reported once


def test_checkpoint_crc_detects_corruption(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 1, t)
    d = os.path.join(tmp_path, "step_00000001")
    victim = next(f for f in sorted(os.listdir(d)) if f.endswith(".npy"))
    with open(os.path.join(d, victim), "r+b") as f:
        f.seek(-1, 2)
        last = f.read(1)
        f.seek(-1, 2)
        f.write(bytes([last[0] ^ 0xFF]))     # guaranteed bit flip
    with pytest.raises(IOError):
        restore_checkpoint(str(tmp_path), t)


def test_checkpoint_interrupted_save_invisible(tmp_path):
    """A tmp dir without manifest must not count as a checkpoint."""
    save_checkpoint(str(tmp_path), 5, _tree())
    os.makedirs(os.path.join(tmp_path, "step_00000006.tmp-999"))
    assert latest_step(str(tmp_path)) == 5


def test_checkpoint_extra_metadata(tmp_path):
    save_checkpoint(str(tmp_path), 3, _tree(),
                    extra={"data_step": 3, "mesh": [2, 4]})
    assert read_manifest(str(tmp_path))["extra"]["mesh"] == [2, 4]


def test_checkpoint_bf16_void_roundtrip(tmp_path):
    """bf16 words go to disk as the reference's ml_dtypes array does (a
    '<V2' void header, byte for byte) and restore bit-exactly."""
    import ml_dtypes
    x = (torch.arange(37, dtype=torch.float32) * 0.37).bfloat16()
    save_checkpoint(str(tmp_path), 2, {"x": x})
    fn = os.path.join(tmp_path, "step_00000002", "x.npy")
    raw = np.load(fn)
    assert raw.dtype.kind == "V"
    ref = os.path.join(tmp_path, "ref.npy")
    np.save(ref, raw.view(ml_dtypes.bfloat16))
    assert open(fn, "rb").read() == open(ref, "rb").read()
    _, back = restore_checkpoint(str(tmp_path), {"x": x})
    assert back["x"].dtype == torch.bfloat16
    assert torch.equal(back["x"].view(torch.int16), x.view(torch.int16))


def _sym(n, seed=0):
    a = np.random.default_rng(seed).standard_normal((n, n))
    return torch.from_numpy((a + a.T) / 2).float()


def test_checkpoint_packed_leaf_roundtrip(tmp_path):
    """Typed packed leaves store as ONE packed-vector file each (bf16 by
    default: < 0.30x the dense f32 bytes) and rebuild their layout."""
    n = 24
    s = _sym(n)
    tree = {"pt": PackedTriangle.from_dense(s),
            "tt": TriTiles.from_tril(torch.tril(s), 8),
            "st": ShardedTriTiles.from_tril(torch.tril(s), 2)}
    save_checkpoint(str(tmp_path), 1, tree)
    b = checkpoint_bytes(str(tmp_path))
    for k in ("pt", "tt", "st"):
        assert b["leaves"][k] <= 0.30 * n * n * 4, (k, b["leaves"][k])
        assert read_manifest(str(tmp_path))["leaves"][k]["dtype"] == \
            "bfloat16"
    _, back = restore_checkpoint(str(tmp_path), tree)
    want = pack_tril(torch.tril(s))
    for k in ("pt", "tt", "st"):
        got = back[k].vec if k == "pt" else back[k].to_packed()
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-2,
                                   atol=1e-2)  # bf16 narrow
    # bit-exact when the narrow pass is disabled
    save_checkpoint(str(tmp_path), 2, tree, packed_dtype=None)
    _, back = restore_checkpoint(str(tmp_path), tree)
    for k in ("pt", "tt", "st"):
        got = back[k].vec if k == "pt" else back[k].to_packed()
        assert torch.equal(got, want), k
    assert verify_restored(str(tmp_path), back)["packed"] == 3


def test_checkpoint_packed_into_other_layouts(tmp_path):
    """The stored words are layout-free: a TriTiles at another bm and a
    ShardedTriTiles at another c rebuild in this process."""
    n = 30
    s = _sym(n, 1)
    save_checkpoint(str(tmp_path), 1,
                    {"a": ShardedTriTiles.from_tril(torch.tril(s), 2),
                     "b": TriTiles.from_tril(torch.tril(s), 8)},
                    packed_dtype=None)
    like = {"a": ShardedTriTiles.from_tril(torch.zeros(n, n), 3),
            "b": TriTiles.from_tril(torch.zeros(n, n), 16)}
    _, back = restore_checkpoint(str(tmp_path), like)
    assert back["a"].c == 3 and back["b"].bm == 16
    want = pack_tril(torch.tril(s))
    assert torch.equal(back["a"].to_packed(), want)
    assert torch.equal(back["b"].to_packed(), want)
    with pytest.raises(ValueError, match="dimension mismatch"):
        restore_checkpoint(str(tmp_path),
                           {"a": PackedTriangle.from_dense(torch.eye(4)),
                            "b": like["b"]})


def test_checkpoint_packed_to_dense_like(tmp_path):
    """A packed-stored leaf restores into a dense like as the mirrored
    symmetric matrix."""
    n = 16
    s = _sym(n, 3)
    save_checkpoint(str(tmp_path), 1, {"g": PackedTriangle.from_dense(s)},
                    packed_dtype=None)
    _, back = restore_checkpoint(str(tmp_path), {"g": torch.zeros(n, n)})
    assert torch.equal(back["g"], s)


def test_checkpoint_dense_stored_into_packed_like(tmp_path):
    """A legacy dense-stored symmetric leaf restores into a packed like
    (its lower triangle)."""
    n = 12
    s = _sym(n, 4)
    save_checkpoint(str(tmp_path), 1, {"g": s, "h": s, "k": s})
    like = {"g": PackedTriangle.from_dense(torch.zeros(n, n)),
            "h": TriTiles.from_tril(torch.zeros(n, n), 8),
            "k": ShardedTriTiles.from_tril(torch.zeros(n, n), 2)}
    _, back = restore_checkpoint(str(tmp_path), like)
    want = pack_tril(s)
    assert torch.equal(back["g"].vec, want)
    assert torch.equal(back["h"].to_packed(), want)
    assert torch.equal(back["k"].to_packed(), want)


def test_retire_sweeps_orphaned_tmp_dirs(tmp_path):
    """Crash debris (tmp dirs from a dead pid) is swept by the next
    save's retention pass; a live writer's tmp dir is left alone."""
    save_checkpoint(str(tmp_path), 1, _tree())
    dead = os.path.join(tmp_path, "step_00000099.tmp-999999999-1")
    live = os.path.join(tmp_path, "step_00000098.tmp-1-1")  # pid 1: alive
    os.makedirs(dead)
    os.makedirs(live)
    save_checkpoint(str(tmp_path), 2, _tree())
    assert not os.path.exists(dead), "orphaned tmp dir must be swept"
    assert os.path.exists(live), "a live writer's tmp dir must survive"


@pytest.fixture()
def small():
    rng = np.random.default_rng(3)
    return {"w": torch.from_numpy(rng.standard_normal((6, 6))).float(),
            "step_count": torch.tensor(4, dtype=torch.int32)}


def _failing_after(monkeypatch, name, ok_calls, fails):
    """Make ``ckpt.<name>`` raise OSError ``fails`` times (0: always)
    after ``ok_calls`` good calls; returns the log of calls."""
    real, calls = getattr(ckpt, name), []

    def flaky(*args):
        calls.append(args)
        bad = len(calls) - ok_calls
        if bad > 0 and (fails == 0 or bad <= fails):
            raise OSError(f"injected {name} fault")
        return real(*args)

    monkeypatch.setattr(ckpt, name, flaky)
    return calls


@pytest.mark.parametrize("site,fails", [("_rename", 1), ("_fsync_fd", 2)])
def test_checkpoint_transient_io_faults_absorbed(tmp_path, small,
                                                 monkeypatch, site, fails):
    """fsync / rename hiccups inside the retry budget never surface: the
    save commits and the restored tree crc-verifies."""
    calls = _failing_after(monkeypatch, site, 0, fails)
    save_checkpoint(str(tmp_path), 3, small)
    assert len(calls) > fails
    step, back = restore_checkpoint(str(tmp_path), small)
    assert step == 3
    vr = verify_restored(str(tmp_path), back, step=step)
    assert vr["checked"] == 2 and not vr["mismatches"]


def test_checkpoint_crash_window_old_recovery(tmp_path, small,
                                              monkeypatch):
    """Re-saving the same step moves final -> .old before the tmp
    rename; a persistent failure in that window loses the final dir but
    the read path recovers the complete .old copy."""
    save_checkpoint(str(tmp_path), 2, small)
    tree2 = {"w": small["w"] + 1.0, "step_count": small["step_count"]}
    _failing_after(monkeypatch, "_rename", 1, 0)
    with pytest.raises(OSError, match="injected"):
        save_checkpoint(str(tmp_path), 2, tree2)
    monkeypatch.undo()
    assert not (tmp_path / "step_00000002").is_dir()
    assert (tmp_path / "step_00000002.old").is_dir()
    step, back = restore_checkpoint(str(tmp_path), small)
    assert step == 2 and torch.equal(back["w"], small["w"])
    assert not verify_restored(str(tmp_path), back,
                               step=step)["mismatches"]


def test_verify_restored_reports_divergence(tmp_path, small):
    save_checkpoint(str(tmp_path), 1, small)
    tampered = {"w": small["w"] + 1.0, "step_count": small["step_count"]}
    vr = verify_restored(str(tmp_path), tampered, step=1)
    assert vr["mismatches"] == ["w"]


def test_with_retries_policy():
    calls, seen = [], []

    def flaky(x):
        calls.append(x)
        if len(calls) < 3:
            raise OSError("transient")
        return x * 2

    assert with_retries(flaky, 21, retries=4, backoff=0.001,
                        on_retry=lambda a, e: seen.append(a)) == 42
    assert seen == [0, 1]
    with pytest.raises(OSError):
        with_retries(lambda: (_ for _ in ()).throw(OSError("x")),
                     retries=2, backoff=0.001)
    with pytest.raises(ValueError):      # not in retry_on: no retry
        with_retries(lambda: (calls.append(0), int("x")), retries=5)
    with pytest.raises(OSError):         # the budget ends the retries
        with_retries(lambda: (_ for _ in ()).throw(OSError("x")),
                     retries=50, backoff=0.05, timeout=0.01)


# ---------------------------------------------------------------------------
# optimizer state and monitors through the checkpoint
# ---------------------------------------------------------------------------
def test_gram_monitor_roundtrip(tmp_path):
    """A bf16 monitor's packed EMAs come back bit-exact; an f32 monitor's
    within the bf16 narrowing (1e-2)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((12, 40))).float()
    for dtype in (torch.bfloat16, None):
        mon = GramMonitor(out_dtype=dtype)
        mon.update("a", x)
        mon.update("a", 2 * x)
        mon.update("b", x[:5])
        d = str(tmp_path / str(dtype))
        save_checkpoint(d, 1, {"monitor": mon.state_dict()})
        other = GramMonitor(out_dtype=dtype)
        other.update("a", x)
        other.update("b", x[:5])
        _, back = restore_checkpoint(d, {"monitor": other.state_dict()})
        other.load_state_dict(back["monitor"])
        for name in ("a", "b"):
            got, want = other._state[name], mon._state[name]
            assert got.dtype == want.dtype and other._dims == mon._dims
            if dtype is torch.bfloat16:
                assert torch.equal(got, want), name
            else:
                np.testing.assert_allclose(got.numpy(), want.numpy(),
                                           rtol=1e-2, atol=1e-2)


def test_muon_state_dict_roundtrip(tmp_path):
    """``state_dict`` / ``load_state_dict`` through the checkpoint:
    momentum exact, step an int, the packed Grams and the (0,) f32
    placeholders of the non-matrix leaves in place."""
    params = {("w",): torch.randn(16, 24), ("b",): torch.randn(24),
              ("s",): torch.randn(2, 8, 8)}
    opt = TMuon(gram_decay=0.9)
    grads = {k: torch.randn_like(v) for k, v in params.items()}
    _, state = opt.update(grads, opt.init(params), params)
    save_checkpoint(str(tmp_path), 1, {"opt": tmuon.state_dict(state)},
                    packed_dtype=None)
    _, back = restore_checkpoint(
        str(tmp_path), {"opt": tmuon.state_dict(opt.init(params))})
    got = tmuon.load_state_dict(back["opt"])
    assert got.step == 1 and isinstance(got.step, int)
    for k in params:
        assert torch.equal(got.momentum[k], state.momentum[k])
    assert isinstance(got.gram[("w",)], PackedTriangle)
    assert torch.equal(got.gram[("w",)].vec, state.gram[("w",)].vec)
    for k in (("b",), ("s",)):
        assert got.gram[k].shape == (0,) and got.gram[k].dtype == \
            torch.float32


# ---------------------------------------------------------------------------
# cross-reading with the reference
# ---------------------------------------------------------------------------
def _smoke_cfgs():
    import dataclasses

    from repro.configs import get_smoke_config as jcfg
    from repro_torch.configs import get_smoke_config as tcfg
    over = dict(n_layers=2, d_model=64, d_ff=128)
    return (dataclasses.replace(jcfg("stablelm-1.6b"), **over),
            dataclasses.replace(tcfg("stablelm-1.6b"), **over))


def _smoke_np_params(seed=0):
    params = init_params(_smoke_cfgs()[0], jax.random.key(seed))
    return jax.tree.map(np.asarray, params)


OPTIMIZERS = {
    "muon_gram": (lambda: JMuon(gram_decay=0.99),
                  lambda: TMuon(gram_decay=0.99)),
    "adamw": (JAdamW, TAdamW),
    "adamw8bit": (lambda: JAdamW(quantize_moments=True),
                  lambda: TAdamW(quantize_moments=True)),
}


def _grads(np_params, seed=1):
    """f32 gradients for every param leaf, the same numbers for both
    packages (jax tree, port tree keyed by path)."""
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(np_params)
    arrs = [rng.standard_normal(np.shape(v)).astype(np.float32)
            for _, v in flat]
    keys = [tuple(k.key for k in path) for path, _ in flat]
    return (jax.tree_util.tree_unflatten(treedef, [jnp.asarray(a)
                                                   for a in arrs]),
            {k: torch.from_numpy(a) for k, a in zip(keys, arrs)})


def _jax_state(name, np_params):
    """The reference's params and optimizer state after one update."""
    opt = OPTIMIZERS[name][0]()
    params = jax.tree.map(jnp.asarray, np_params)
    gj, _ = _grads(np_params)
    return opt.update(gj, opt.init(params), params), opt


def _torch_state(name, np_params):
    """The port's stacked params and optimizer state after one update."""
    opt = OPTIMIZERS[name][1]()
    model = from_jax_params(np_params, _smoke_cfgs()[1], device="cpu")
    params = model.stacked()
    _, gt = _grads(np_params)
    return opt.update(gt, opt.init(params), params), opt, model


def _bytes(x):
    """(dtype name, shape, raw bytes) of a leaf of either package."""
    if isinstance(x, (PackedTriangle, JPacked)):
        x = x.vec
    if isinstance(x, torch.Tensor):
        return (ckpt._dtype_name(x.dtype), tuple(x.shape),
                x.contiguous().reshape(-1).view(torch.uint8).numpy()
                .tobytes())
    if isinstance(x, int):
        x = np.int32(x)
    a = np.asarray(x)
    return str(a.dtype), a.shape, a.tobytes()


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_reference_checkpoint_restores_in_the_port(tmp_path, name):
    """The reference saves params + optimizer state; the port restores
    into its own live trees with the same keys, every leaf bitwise what
    the reference restores itself."""
    np_params = _smoke_np_params()
    (params, state), jopt = _jax_state(name, np_params)
    d = str(tmp_path)
    j_save(d, 3, {"params": params, "opt": state}, extra={"by": "repro"})
    (_, _), topt, model = _torch_state(name, np_params)
    like = {"params": model.stacked(), "opt": topt.init(model.stacked())}
    assert {k for k, _ in ckpt._flatten(like)} == \
        set(read_manifest(d)["leaves"])
    step, back = restore_checkpoint(d, like)
    assert step == 3 and type(back["opt"]) is type(like["opt"])
    assert isinstance(back["opt"].step, int) and back["opt"].step == 1
    params_shape = jax.eval_shape(lambda: params)
    _, want = j_restore(d, {"params": params_shape,
                            "opt": jax.eval_shape(jopt.init, params_shape)})
    from repro.distributed.checkpoint import _flatten as j_flatten
    want = dict(j_flatten(want))
    got = ckpt._flatten(back)
    assert [k for k, _ in got] == list(want)
    for k, v in got:
        assert _bytes(v) == _bytes(want[k]), k
        assert isinstance(v, PackedTriangle) == isinstance(want[k], JPacked)
    # the plain leaves are the reference's live values, bit for bit
    live = dict(j_flatten({"params": params, "opt": state}))
    for k, v in got:
        if not isinstance(v, PackedTriangle):
            assert _bytes(v) == _bytes(live[k]), k
    assert not verify_restored(d, back)["mismatches"]


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_port_checkpoint_restores_in_the_reference(tmp_path, name):
    """The port saves params + optimizer state; the reference restores
    them with a ``jax.eval_shape`` like and its ``verify_restored``
    finds every leaf's crc."""
    np_params = _smoke_np_params()
    (params, state), _, _ = _torch_state(name, np_params)
    d = str(tmp_path)
    save_checkpoint(d, 4, {"params": params, "opt": state})
    jopt = OPTIMIZERS[name][0]()
    params_shape = jax.eval_shape(lambda: jax.tree.map(jnp.asarray,
                                                       np_params))
    step, back = j_restore(d, {"params": params_shape,
                               "opt": jax.eval_shape(jopt.init,
                                                     params_shape)})
    assert step == 4 and int(back["opt"].step) == 1
    vr = j_verify(d, back, step=step)
    assert vr["mismatches"] == [] and vr["checked"] == \
        len(read_manifest(d)["leaves"])
    from repro.distributed.checkpoint import _flatten as j_flatten
    got = dict(j_flatten(back))
    for k, v in ckpt._flatten({"params": params, "opt": state}):
        if isinstance(v, PackedTriangle):
            assert isinstance(got[k], JPacked) and got[k].n == v.n
            assert _bytes(got[k].vec.astype(jnp.bfloat16)) == \
                _bytes(v.vec.bfloat16()), k
        else:
            assert _bytes(got[k]) == _bytes(v), k


def test_bf16_files_are_the_reference_bytes(tmp_path):
    """For the same values, every .npy file (bf16 params, f32 norms) and
    every manifest entry the port writes is the reference's."""
    np_params = _smoke_np_params()
    model = from_jax_params(np_params, _smoke_cfgs()[1], device="cpu")
    j_save(str(tmp_path / "ref"), 1,
           {"params": jax.tree.map(jnp.asarray, np_params),
            "step": jnp.asarray(7, jnp.int32)})
    save_checkpoint(str(tmp_path / "port"), 1,
                    {"params": model.stacked(), "step": 7})
    dr, dp = (tmp_path / "ref" / "step_00000001",
              tmp_path / "port" / "step_00000001")
    names = sorted(os.listdir(dr))
    assert names == sorted(os.listdir(dp))
    bf16 = 0
    for f in names:
        if f.endswith(".npy"):
            assert (dr / f).read_bytes() == (dp / f).read_bytes(), f
            bf16 += np.load(dr / f).dtype.kind == "V"
    assert bf16 >= 4
    assert json.loads((dr / "manifest.json").read_text()) == \
        json.loads((dp / "manifest.json").read_text())
