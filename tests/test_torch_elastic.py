"""Elastic mesh training state: Muon's packed momentum Grams on a (data,
model) mesh, mesh checkpoints restored onto any layout, ``--fail-at`` /
``train:step`` kills on a mesh and ``run_recovery`` onto another device
count, on gloo CPU ranks at the stablelm smoke config.

* The Grams (``Muon(specs=, gram_decay=0.99)``) on (2, 1), (1, 2) and
  (1, 4) after two updates from the same gradients, gathered, against
  the single-device ``Muon.update`` the trainer runs and the
  reference's ``Muon(gram_decay=0.99).update`` on the same momentum,
  ``rtol=1e-5``, and ``1e-5`` of the Gram's largest entry beside the
  off-diagonal entries near 0 (the ranks' partial Grams, and the
  reference's products, sum in another order: measured 5.5e-4 of an
  entry 2.6e-6 of the largest, from the reference on one device); the
  momentum bit-equal; the Gram's words a rank the 1D SYRK's
  reduce-scatter, (1 - 1/P)·Lp for each leaf split along its width
  (embed, unembed), Lp = n(n+1)/2 padded to a multiple of P, and none
  where 'model' is 1.
* A (2, 2) run killed by ``train:step`` before step 3 and resumed on
  (2, 2) equals the uninterrupted (2, 2) run bit for bit: its losses,
  and every leaf of the step-2 checkpoint and, apart from the Grams, of
  the step-4 one (parameters, momentum); the Grams resume from their
  bf16 words, so at step 4 they are held to 1e-2 of their largest word,
  the single-device resume test's bound.
* Resumes onto other layouts: (2, 2) -> (1, 2), 4 ranks -> 1 device,
  1 device -> (2, 2), and ``run_recovery`` (1, 4) -> (1, 2): 0
  mismatches, and every loss within ``5e-4`` of the uninterrupted
  single-device run's (``tests/test_torch_train_mesh.py``'s bound).
* A mesh checkpoint has the single-device checkpoint's keys, shapes and
  packed layouts, one whole ``PackedTriangle`` a Gram, and the
  reference's ``restore_checkpoint`` reads it bit-equal to the port's
  own restore of it (the Grams as bf16 words), its
  ``verify_restored`` finding every crc.
* The elastic helpers (``wire_c``, ``reshard_tritiles``,
  ``reshard_packed_state``, ``spec_tree_like``,
  ``validate_divisibility``) against the reference's on the same
  inputs; ``reshard_tree`` on (2, 2) gives each rank the block the
  reference's ``NamedSharding`` places on that device.
* ``run_recovery`` at the reference's defaults (8 -> 6 ranks, global
  batch 12, ``--max-model 2``; 8 steps, not 40), a straggler
  ``checkpoint`` on one rank that the others follow, the refusals of
  rank-local state (ROADMAP A8b) and the device string ``run_ranks``
  gives its ranks.
"""
import argparse
import os
import shutil
import types

import numpy as np
import pytest
import torch

from repro_torch.distributed import faults
from repro_torch.distributed import launch as tlaunch
from repro_torch.distributed.checkpoint import read_manifest
from repro_torch.distributed.launch import run_ranks
from repro_torch.launch import train as ttrain
from repro_torch.launch.recovery import run_recovery
from test_torch_hygiene import limit_torch_threads  # noqa: F401

TESTS = os.path.dirname(os.path.abspath(__file__))
STEPS, KILL, EVERY = 4, 3, 2
LOSS_RTOL = 5e-4
GRAM_RTOL = 1e-5
GRAM_BF16 = 1e-2
#: the reference's run_recovery summary keys (repro/launch/recovery.py:125)
RECOVERY_KEYS = {"killed", "kill_step", "resumed_step", "verified_leaves",
                 "mismatches", "completed", "final"}


def _args(**kw):
    args = ttrain.build_argparser().parse_args([])
    for k, v in dict(device="cpu", steps=STEPS, global_batch=4, seq_len=32,
                     loss_chunk=16, log_every=1, optimizer="muon-syrk",
                     track_gram=True, ckpt_every=EVERY,
                     max_model=2).items():
        setattr(args, k, v)
    for k, v in kw.items():
        setattr(args, k, v)
    return args


# ---------------------------------------------------------------------------
# the Grams, one update at a time
# ---------------------------------------------------------------------------
_REF = {}


def _reference_params():
    if "params" not in _REF:
        import jax

        from repro.configs import get_smoke_config
        from repro.models.model import init_params
        params = init_params(get_smoke_config("stablelm-1.6b"),
                             jax.random.key(0))
        _REF["params"] = jax.tree.map(np.asarray, params)
    return _REF["params"]


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {path: tree}


def _nest(flat):
    out = {}
    for path, v in flat.items():
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


def _gradients(n=2):
    """``n`` sets of f32 gradients, one array per parameter path."""
    rng = np.random.default_rng(7)
    shapes = {k: np.shape(v) for k, v in _flat(_reference_params()).items()}
    return [{k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()} for _ in range(n)]


def gram_rank(mesh_x, cases, np_tree, grads):
    """Each (data, model) case: two Muon updates with Grams on this
    rank's blocks, the Grams gathered, the momentum gathered, and the
    words of the Gram (an update with Grams less one without)."""
    from repro_torch.core.packing import PackedTriangleSlice
    from repro_torch.distributed import collectives
    from repro_torch.distributed.mesh import make_mesh
    from repro_torch.models.model import from_jax_params
    from repro_torch.models.sharding import gather_leaf, shard_leaf
    from repro_torch.optim.muon import Muon
    out = []
    for data, model_ax in cases:
        mesh = make_mesh({"data": data, "model": model_ax}, device="cpu")
        cfg = ttrain.build_config(_args())
        model = from_jax_params(np_tree, cfg, device="cpu", mesh=mesh)
        specs = model.specs
        kw = dict(lr=2e-2, mode="syrk-1d", mesh=mesh, specs=specs)
        opt, plain = Muon(gram_decay=0.99, **kw), Muon(**kw)
        params = model.stacked()
        state = opt.init(params)
        kinds, words = {}, []
        for g in grads:
            gl = {k: shard_leaf(torch.from_numpy(g[k]), specs[k], mesh)
                  for k in params}
            collectives.reset_word_counts()
            plain.update(gl, state._replace(gram=None), params)
            without = collectives.word_counts()
            collectives.reset_word_counts()
            params, state = opt.update(gl, state, params)
            got = collectives.word_counts()
            words.append({k: v - without.get(k, 0) for k, v in got.items()
                          if v != without.get(k, 0)})
        gram = {}
        for k, gm in state.gram.items():
            kinds[k] = type(gm).__name__
            if isinstance(gm, PackedTriangleSlice):     # every slice
                parts = collectives.all_gather(gm.vec[None],
                                               mesh.comm("model"))
                gram[k] = PackedTriangleSlice.join(
                    [PackedTriangleSlice(v, gm.n, gm.parts, i)
                     for i, v in enumerate(parts)]).numpy()
            elif not isinstance(gm, torch.Tensor):      # a whole Gram
                gram[k] = gm.vec.numpy()
        out.append({
            "mesh": (data, model_ax), "kinds": kinds, "words": words,
            "gram": gram,
            "momentum": {k: gather_leaf(m, specs[k], mesh).numpy()
                         for k, m in state.momentum.items()}})
    return out


def reshard_rank(mesh_x, tree, specs):
    """``reshard_tree`` on a (2, 2) mesh: this rank's blocks."""
    from repro_torch.distributed.elastic import reshard_tree
    from repro_torch.distributed.mesh import make_mesh
    mesh = make_mesh({"data": 2, "model": 2}, device="cpu")
    got = reshard_tree(tree, specs, mesh)
    return {"coords": (mesh.index("data"), mesh.index("model")),
            "blocks": {k: v.numpy() for k, v in got.items()}}


def gram_rank_all(mesh_x, cases, np_tree, grads, tree=None, specs=None):
    out = {"gram": gram_rank(mesh_x, cases, np_tree, grads)}
    if tree is not None:
        out["reshard"] = reshard_rank(mesh_x, tree, specs)
    return out


#: (data, model) per world size
GRAM_CASES = {2: [(2, 1), (1, 2)], 4: [(1, 4)]}
RESHARD_TREE = {"w": np.arange(8 * 6, dtype=np.float32).reshape(8, 6),
                "b": np.arange(6, dtype=np.float32),
                "s": np.arange(4 * 8 * 6, dtype=np.float32).reshape(4, 8, 6)}
RESHARD_SPECS = {"w": ("data", "model"), "b": (), "s": (None, "model")}
_RANKS = {}


def _gram_runs(world):
    if world not in _RANKS:
        kw = {"cases": GRAM_CASES[world], "np_tree": _reference_params(),
              "grads": _gradients()}
        if world == 4:
            kw.update(tree=RESHARD_TREE, specs=RESHARD_SPECS)
        _RANKS[world] = run_ranks("test_torch_elastic:gram_rank_all", world,
                                  device="cpu", paths=[TESTS], timeout=300,
                                  kwargs=kw)
    return _RANKS[world]


def _single_grams():
    """The single-device port's and the reference's Grams and momentum
    after the same two updates."""
    if "single" not in _REF:
        import jax
        import jax.numpy as jnp

        from repro.core.packing import PackedTriangle as JPacked
        from repro.optim import Muon as JMuon
        from repro_torch.core.packing import PackedTriangle
        from repro_torch.models.model import from_jax_params
        from repro_torch.optim.muon import Muon
        np_tree = _reference_params()
        model = from_jax_params(np_tree, ttrain.build_config(_args()),
                                device="cpu")
        opt = Muon(lr=2e-2, mode="syrk-1d", gram_decay=0.99)
        params = model.stacked()
        state = opt.init(params)
        jopt = JMuon(gram_decay=0.99)
        jparams = jax.tree.map(jnp.asarray, np_tree)
        jstate = jopt.init(jparams)
        for g in _gradients():
            params, state = opt.update(
                {k: torch.from_numpy(v) for k, v in g.items()}, state,
                params)
            jparams, jstate = jopt.update(
                jax.tree.map(jnp.asarray, _nest(g)), jstate, jparams)
        jgram = _flat(jax.tree.map(
            lambda x: np.asarray(x.vec if isinstance(x, JPacked) else x),
            jstate.gram,
            is_leaf=lambda x: isinstance(x, JPacked)))
        _REF["single"] = (
            {k: gm.vec.numpy() for k, gm in state.gram.items()
             if isinstance(gm, PackedTriangle)},
            {k: v for k, v in jgram.items() if np.size(v)},
            {k: m.numpy() for k, m in state.momentum.items()})
    return _REF["single"]


GRAM_ALL = [(w, i) for w in GRAM_CASES for i in range(len(GRAM_CASES[w]))]


@pytest.mark.parametrize("world,i", GRAM_ALL)
def test_mesh_grams_follow_one_device_and_the_reference(world, i):
    port, ref, momentum = _single_grams()
    assert sorted(port) == sorted(ref) == [("embed",), ("unembed",)]
    for r in _gram_runs(world):
        got = r["gram"][i]
        assert sorted(got["gram"]) == sorted(port)
        for k in port:
            for want in (port[k], ref[k]):
                np.testing.assert_allclose(
                    got["gram"][k], want, rtol=GRAM_RTOL,
                    atol=GRAM_RTOL * np.abs(want).max())
        for k, m in momentum.items():
            assert np.array_equal(got["momentum"][k], m), k


@pytest.mark.parametrize("world,i", GRAM_ALL)
def test_mesh_gram_words_are_the_1d_reduce_scatter(world, i):
    """Each split leaf's Gram is one packed reduce-scatter a step, kept
    as this rank's slice; 'model' of 1 keeps whole Grams and moves
    nothing."""
    from repro_torch.core.packing import padded_tril_size
    data, P = GRAM_CASES[world][i]
    n = 64                                       # the smoke d_model
    for r in _gram_runs(world):
        got = r["gram"][i]
        if P == 1:
            assert got["words"] == [{}, {}]
            assert got["kinds"][("embed",)] == "PackedTriangle"
            continue
        assert got["kinds"][("embed",)] == "PackedTriangleSlice"
        assert got["kinds"][("unembed",)] == "PackedTriangleSlice"
        lp = padded_tril_size(n, P)
        assert got["words"] == [{"reduce_scatter": 2 * (lp * (P - 1)
                                                        // P)}] * 2


# ---------------------------------------------------------------------------
# kills and resumes
# ---------------------------------------------------------------------------
_RUNS = {}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("elastic")


def _with_kill(fn):
    """``fn()`` with a ``train:step`` kill before step ``KILL`` armed
    through the environment (every rank process inherits it)."""
    env = faults.env_dict([faults.FaultSpec(site="train:step", kind="kill",
                                            step=KILL)])
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        with pytest.raises(faults.DeviceLossError,
                           match="injected device loss at train:step"):
            fn()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _run(root, name):
    """The runs, each once: ``u*`` uninterrupted, ``k*`` killed before
    step 3 (their step-2 checkpoints copied aside for the other
    resumes first), ``r*`` resumed."""
    if name in _RUNS:
        return _RUNS[name]
    d = lambda n: str(root / n)                       # noqa: E731
    mesh22 = dict(devices=4, max_model=2)
    if name == "u1":
        out = ttrain.train(_args(ckpt_dir=d("u1")))
    elif name == "u22":
        out = ttrain.train(_args(ckpt_dir=d("u22"), **mesh22))
    elif name == "k22":
        _with_kill(lambda: ttrain.train(_args(ckpt_dir=d("k22"), **mesh22)))
        for copy in ("k22_to12", "k22_to1"):
            shutil.copytree(d("k22"), d(copy))
        out = None
    elif name == "r22":
        _run(root, "k22")
        out = ttrain.train(_args(ckpt_dir=d("k22"), **mesh22))
    elif name == "r12":
        _run(root, "k22")
        out = ttrain.train(_args(ckpt_dir=d("k22_to12"), devices=2))
    elif name == "r1":
        _run(root, "k22")
        out = ttrain.train(_args(ckpt_dir=d("k22_to1")))
    elif name == "k1":
        with pytest.raises(ttrain.InjectedFailure, match="step 3"):
            ttrain.train(_args(ckpt_dir=d("k1"), fail_at=KILL))
        out = None
    elif name == "r1to22":
        _run(root, "k1")
        out = ttrain.train(_args(ckpt_dir=d("k1"), **mesh22))
    elif name == "rec14":
        out = run_recovery(d("rec14"), device="cpu", devices=4,
                           devices_after=2, max_model=4, steps=STEPS,
                           kill_step=KILL, ckpt_every=EVERY, global_batch=4,
                           seq_len=32, layers=0, optimizer="muon-syrk",
                           track_gram=True, timeout=300,
                           extra_args=["--loss-chunk", "16"])
    else:
        raise KeyError(name)
    _RUNS[name] = out
    return out


def _leaves(root, name, step):
    return read_manifest(str(root / name), step)["leaves"]


def _gram_words(path):
    return torch.from_numpy(np.load(path).view(np.int16)) \
        .view(torch.bfloat16).float()


def test_mesh_kill_then_resume_is_bit_exact(root):
    u = _run(root, "u22")
    assert u["mesh"] == {"data": 2, "model": 2} and not u["resumed"]
    _run(root, "k22")
    assert sorted(os.listdir(root / "k22")) == ["step_00000002"]
    r = _run(root, "r22")
    assert r["resumed"] and r["start_step"] == 2 and r["steps"] == 2
    assert r["restore_verified"]["mismatches"] == []
    assert r["losses"] == u["losses"][2:]
    assert all(x["losses"] == r["losses"] for x in r["ranks"])
    assert r["ckpt_bytes"] == u["ckpt_bytes"] > 0
    # the state at the kill's checkpoint, Grams included, and at step 4
    # every leaf but the Grams (which resumed from their bf16 words)
    assert _leaves(root, "u22", 2) == _leaves(root, "k22", 2)
    lu, lr = _leaves(root, "u22", 4), _leaves(root, "k22", 4)
    assert sorted(lu) == sorted(lr)
    grams = [k for k in lu if k.startswith("opt__.gram__") and "packed" in lu[k]]
    assert len(grams) == 2
    assert [k for k in lu if lu[k]["crc"] != lr[k]["crc"]
            and k not in grams] == []
    assert any(k.startswith("opt__.momentum__") for k in lu)
    for k in grams:
        a = _gram_words(root / "u22" / "step_00000004" / (k + ".npy"))
        b = _gram_words(root / "k22" / "step_00000004" / (k + ".npy"))
        assert float((a - b).abs().max() / a.abs().max()) <= GRAM_BF16, k


@pytest.mark.parametrize("name,mesh", [
    ("r12", {"data": 1, "model": 2}), ("r1", {"data": 1, "model": 1}),
    ("r1to22", {"data": 2, "model": 2})])
def test_resume_onto_another_layout(root, name, mesh):
    """(2, 2) -> (1, 2), 4 ranks -> 1 device, 1 device -> (2, 2): every
    leaf placed and verified (0 mismatches), the losses within
    ``LOSS_RTOL`` of the uninterrupted single-device run."""
    want = _run(root, "u1")["losses"]
    out = _run(root, name)
    assert out["mesh"] == mesh
    assert out["resumed"] and out["start_step"] == 2 and out["steps"] == 2
    assert out["restore_verified"]["mismatches"] == []
    assert out["restore_verified"]["packed"] == 2
    np.testing.assert_allclose(out["losses"], want[2:], rtol=LOSS_RTOL)
    d = {"r12": "k22_to12", "r1": "k22_to1", "r1to22": "k1"}[name]
    assert sorted(_leaves(root, d, 4)) == sorted(_leaves(root, "u1", 4))


def test_run_recovery_onto_fewer_ranks(root):
    """The reference's elastic kill -> resume: phase 1 on (1, 4) killed
    before step 3, phase 2 on (1, 2) from step 2."""
    out = _run(root, "rec14")
    assert RECOVERY_KEYS <= set(out)
    assert out["killed"] and out["kill_step"] == KILL
    assert out["resumed_step"] == 2 and out["mismatches"] == 0
    assert out["completed"] and out["verified_leaves"] > 0
    assert out["final"]["mesh"] == {"data": 1, "model": 2}
    p1, p2 = out["phases"]
    assert len(p1["losses"]) == 3 and p2["start_step"] == 2
    want = _run(root, "u1")["losses"]
    np.testing.assert_allclose(p1["losses"], want[:3], rtol=LOSS_RTOL)
    np.testing.assert_allclose(p2["losses"], want[2:], rtol=LOSS_RTOL)
    # the Grams' reduce-scatter a step: (1 - 1/P)·Lp each of embed and
    # unembed, beside the NS words of the optimizer phase
    from repro_torch.core.packing import padded_tril_size
    for p, P in ((p1, 4), (p2, 2)):
        lp = padded_tril_size(64, P)
        # the checkpoint's gathers: each rank but rank 0 sends its
        # blocks once (rank 0 receives)
        ckpt = p["ranks"]["ckpt_words"]
        assert len(ckpt) == P and "gather" not in ckpt[0]
        assert all(w["gather"] > 0 and "all_gather" not in w
                   for w in ckpt[1:])
        for step in p["words"]:
            assert step["opt"]["reduce_scatter"] >= 2 * (lp * (P - 1) // P)


def test_mesh_checkpoint_is_the_single_device_layout(root):
    """The (2, 2) run's files: the single-device run's keys, shapes,
    dtypes and packed layouts, a whole PackedTriangle a Gram."""
    _run(root, "u22")
    mesh_leaves, one = _leaves(root, "u22", 4), _leaves(root, "u1", 4)
    assert sorted(mesh_leaves) == sorted(one)
    for k, m in one.items():
        got = mesh_leaves[k]
        assert (got["shape"], got["dtype"], got.get("packed")) == \
            (m["shape"], m["dtype"], m.get("packed")), k
    grams = [m for m in mesh_leaves.values() if "packed" in m]
    assert [m["packed"]["format"] for m in grams] == \
        ["packed_triangle"] * 2
    assert all(m["shape"] == [64 * 65 // 2] for m in grams)


def test_reference_restores_a_mesh_checkpoint(root):
    """``repro.distributed.restore_checkpoint`` reads the (2, 2) run's
    step-4 checkpoint, every leaf bit-equal to the port's own restore
    of it (the Grams' bf16 words), and its ``verify_restored`` finds
    every crc."""
    import jax
    import jax.numpy as jnp

    from repro.core.packing import PackedTriangle as JPacked
    from repro.distributed import restore_checkpoint as j_restore
    from repro.distributed import verify_restored as j_verify
    from repro.distributed.checkpoint import _flatten as j_flatten
    from repro.optim import Muon as JMuon
    from repro_torch.core.packing import PackedTriangle
    from repro_torch.distributed import restore_checkpoint
    from repro_torch.distributed.checkpoint import _flatten
    from repro_torch.models.model import from_jax_params
    from repro_torch.optim.muon import Muon
    _run(root, "u22")
    d = str(root / "u22")
    np_tree = _reference_params()
    shapes = jax.eval_shape(lambda: jax.tree.map(jnp.asarray, np_tree))
    step, back = j_restore(d, {"params": shapes, "opt": jax.eval_shape(
        JMuon(gram_decay=0.99).init, shapes)}, step=4)
    assert step == 4 and int(back["opt"].step) == 4
    vr = j_verify(d, back, step=4)
    assert vr["mismatches"] == [] and vr["checked"] == len(_leaves(
        root, "u22", 4)) and vr["packed"] == 2
    model = from_jax_params(np_tree, ttrain.build_config(_args()),
                            device="cpu")
    like = {"params": model.stacked(), "opt": Muon(gram_decay=0.99).init(
        model.stacked())}
    _, mine = restore_checkpoint(d, like, step=4)
    ref = dict(j_flatten(back))
    got = _flatten(mine)
    assert [k for k, _ in got] == list(ref)
    for k, v in got:
        if isinstance(v, PackedTriangle):
            assert isinstance(ref[k], JPacked) and ref[k].n == v.n == 64
            a = np.asarray(ref[k].vec.astype(jnp.bfloat16)).view(np.int16)
            b = v.vec.bfloat16().view(torch.int16).numpy()
        elif isinstance(v, int):
            a, b = np.int32(ref[k]), np.int32(v)
        else:
            a = np.asarray(ref[k])
            b = (v.view(torch.int16) if v.dtype == torch.bfloat16
                 else v).numpy()
            a = a.view(np.int16) if a.dtype.kind == "V" or \
                str(a.dtype) == "bfloat16" else a
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), k


def test_run_recovery_at_the_reference_defaults(tmp_path):
    """8 ranks -> 6 (data 4 -> 3, model 2), global batch 12, Muon with
    the Grams, killed before step 4 of 8, resumed from step 4."""
    out = run_recovery(str(tmp_path / "ckpt"), device="cpu", devices=8,
                       devices_after=6, steps=8, kill_step=4, ckpt_every=2,
                       timeout=600)
    assert RECOVERY_KEYS <= set(out)
    assert out["killed"] and out["resumed_step"] == 4
    assert out["mismatches"] == 0 and out["completed"]
    assert out["final"]["mesh"] == {"data": 3, "model": 2}
    p1, p2 = out["phases"]
    assert len(p1["losses"]) == 4 and len(p2["losses"]) == 4
    assert all(np.isfinite(p1["losses"] + p2["losses"]))


# ---------------------------------------------------------------------------
# a straggler's checkpoint, the refusals, the launcher's device string
# ---------------------------------------------------------------------------
def straggler_rank(mesh_x, flags, slow_rank, at):
    """The trainer on (1, 2) with rank ``slow_rank``'s monitor asking for
    a checkpoint at its ``at``-th step."""
    import torch.distributed as dist

    from repro_torch.distributed import straggler
    from repro_torch.distributed.mesh import make_mesh

    class Monitor(straggler.StragglerMonitor):
        def record(self, step, seconds):
            ev = super().record(step, seconds)
            if dist.get_rank() == slow_rank and step == at:
                ev = straggler.StragglerEvent(step, seconds, seconds, 9.0,
                                              "checkpoint")
            return ev

    ttrain.StragglerMonitor = Monitor
    args = argparse.Namespace(**flags)
    mesh = make_mesh({"data": 1, "model": 2}, device="cpu")
    out = ttrain._run(args, ttrain.build_config(args), mesh.device,
                      mesh=mesh, say=lambda line: None)
    return out["losses"]


def test_a_straggler_checkpoint_on_one_rank_does_not_hang(tmp_path):
    """Rank 1 alone asks for a checkpoint after step 1: both ranks save
    step 2 (the gathers would wait forever if rank 0 did not), then the
    last step 3."""
    d = str(tmp_path)
    flags = vars(_args(ckpt_dir=d, steps=3, ckpt_every=0, devices=2))
    losses = run_ranks("test_torch_elastic:straggler_rank", 2, device="cpu",
                       paths=[TESTS], timeout=120,
                       kwargs={"flags": flags, "slow_rank": 1, "at": 2})
    assert losses[0] == losses[1] and len(losses[0]) == 3
    assert sorted(os.listdir(d)) == ["step_00000002", "step_00000003"]
    assert read_manifest(d, 2)["step"] == 2


@pytest.mark.parametrize("optimizer,compress,max_model", [
    ("adamw8bit", False, 2), ("adamw", True, 1)])
def test_rank_local_state_refuses_a_mesh_checkpoint(tmp_path, optimizer,
                                                    compress, max_model):
    """8-bit AdamW's moments (quantized in each rank's blocks) and the
    EF residuals of a compressed data axis (each data rank's own) have
    no layout-free form: ``--ckpt-dir`` on a mesh raises, naming
    ROADMAP A8b, and writes nothing."""
    with pytest.raises(NotImplementedError, match="ROADMAP A8b"):
        ttrain.train(_args(devices=2, max_model=max_model,
                           optimizer=optimizer, compress_grads=compress,
                           track_gram=False, ckpt_dir=str(tmp_path / "c")))
    assert not (tmp_path / "c").exists()


def test_run_ranks_gives_the_ranks_cuda_by_default(monkeypatch):
    """With no device asked for, the ranks get "cuda" whatever the
    backend, which puts rank r on card r mod the cards present; an
    explicit device is passed on; no card and no device raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert tlaunch.spec_device(None) == "cuda"
    assert tlaunch.spec_device("cuda:0") == "cuda:0"
    assert tlaunch.spec_device("cpu") == "cpu"
    assert [tlaunch.rank_device("cuda", r, 4) for r in range(6)] == \
        ["cuda:0", "cuda:1", "cuda:2", "cuda:3", "cuda:0", "cuda:1"]
    assert [tlaunch.rank_device("cuda", r, 1) for r in range(3)] == \
        ["cuda:0"] * 3
    assert tlaunch.rank_device("cuda:0", 3, 4) == "cuda:0"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlaunch.spec_device(None)


# ---------------------------------------------------------------------------
# the elastic helpers against the reference's
# ---------------------------------------------------------------------------
def _sym(n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)).astype(np.float32)
    return a + a.T


def test_wire_c_and_validate_divisibility_match_the_reference():
    from repro.distributed import elastic as jel
    from repro_torch.distributed import elastic as tel
    assert [tel.wire_c(n) for n in range(40)] == \
        [jel.wire_c(n) for n in range(40)]
    for shape in ({"data": 2, "model": 2}, {"data": 3, "model": 2},
                  {"pod": 2, "data": 2, "model": 4}, {"model": 8}):
        mesh = types.SimpleNamespace(shape=shape)
        for gb in (4, 6, 12):
            for dims in ((64, 160), (64, 100), (512,)):
                assert tel.validate_divisibility(
                    mesh, global_batch=gb, model_dims=dims) == \
                    jel.validate_divisibility(mesh, global_batch=gb,
                                              model_dims=dims)


@pytest.mark.parametrize("n,c,c_new", [(37, 2, 3), (64, 3, 2), (40, 2, 4)])
def test_reshard_tritiles_matches_the_reference(n, c, c_new):
    """The new wire's off-diagonal slots and the triangle it holds
    bit-equal to the reference's.  Which device holds which diagonal
    block the reference decides by a networkx matching whose result
    depends on PYTHONHASHSEED (ROADMAP's ground rules), so the diagonal
    slots are held through the packed words alone."""
    import jax.numpy as jnp

    from repro.core.packing import ShardedTriTiles as JST
    from repro.distributed import reshard_tritiles as j_reshard
    from repro_torch.core.packing import ShardedTriTiles
    from repro_torch.distributed import reshard_tritiles
    x = np.tril(_sym(n))
    want = j_reshard(JST.from_tril(jnp.asarray(x), c), c_new)
    got = reshard_tritiles(ShardedTriTiles.from_tril(torch.from_numpy(x), c),
                           c_new)
    assert (got.n, got.c) == (want.n, want.c) == (n, c_new)
    assert got.diag.shape == np.shape(want.diag)
    assert np.array_equal(got.off.numpy(), np.asarray(want.off))
    assert np.array_equal(got.to_packed().numpy(),
                          np.asarray(want.to_packed()))
    assert np.array_equal(got.to_packed().numpy(), x[np.tril_indices(n)])


def test_reshard_packed_state_and_spec_tree_like_match_the_reference():
    import jax.numpy as jnp

    from repro.core.packing import PackedTriangle as JPT
    from repro.core.packing import ShardedTriTiles as JST
    from repro.distributed import reshard_packed_state as j_rps
    from repro.distributed import spec_tree_like as j_stl
    from repro_torch.core.packing import PackedTriangle, ShardedTriTiles
    from repro_torch.distributed import (reshard_packed_state,
                                         spec_tree_like)
    x = np.tril(_sym(40, seed=3))
    vec = x[np.tril_indices(40)]
    dense = np.arange(12, dtype=np.float32).reshape(3, 4)
    jtree = {"w": JST.from_tril(jnp.asarray(x), 2),
             "g": JPT(jnp.asarray(vec), 40), "m": jnp.asarray(dense)}
    ttree = {"w": ShardedTriTiles.from_tril(torch.from_numpy(x), 2),
             "g": PackedTriangle(torch.from_numpy(vec), 40),
             "m": torch.from_numpy(dense)}
    want, got = j_rps(jtree, 12), reshard_packed_state(ttree, 12)
    assert got["w"].c == want["w"].c == 3
    assert np.array_equal(got["w"].off.numpy(), np.asarray(want["w"].off))
    assert np.array_equal(got["w"].to_packed().numpy(),
                          np.asarray(want["w"].to_packed()))
    assert got["g"] is ttree["g"] and got["m"] is ttree["m"]
    js = j_stl(jtree, shard_axis="x")
    ts = spec_tree_like(ttree, shard_axis="x")
    assert isinstance(ts["w"], ShardedTriTiles) and ts["w"].c == 2
    assert ts["w"].off == tuple(js["w"].off) == ("x",)
    assert ts["w"].diag == tuple(js["w"].diag)
    assert ts["g"].vec == tuple(js["g"].vec) == () and ts["g"].n == 40
    assert ts["m"] == tuple(js["m"]) == ()
    assert spec_tree_like(ttree)["w"].off == tuple(j_stl(jtree)["w"].off)


def test_reshard_tree_places_the_reference_blocks():
    """Each rank of (data 2, model 2) holds the block of each leaf that
    a ``NamedSharding`` of its spec puts on the device at its mesh
    coordinates (a spec names the leading dims; ``()`` replicates)."""
    ranks = _gram_runs(4)
    for r in ranks:
        i, j = r["reshard"]["coords"]
        blocks = r["reshard"]["blocks"]
        t = RESHARD_TREE
        assert np.array_equal(blocks["w"], t["w"][4 * i:4 * i + 4,
                                                  3 * j:3 * j + 3])
        assert np.array_equal(blocks["b"], t["b"])
        assert np.array_equal(blocks["s"], t["s"][:, 4 * j:4 * j + 4])
