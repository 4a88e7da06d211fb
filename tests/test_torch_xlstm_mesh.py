"""xlstm on a (data, model) mesh of gloo CPU ranks: the tensor-parallel
mLSTM / sLSTM mixers and ``train --devices N`` at the xlstm smoke
config (d 64, 2 heads) and its 4-head variant (``hd`` 16), against the
JAX package on the same numpy inputs.

* The mixers (``models.ssm`` with ``tp`` set, each rank its
  ``param_specs`` block of weights drawn by the reference's
  ``mlstm_params`` / ``slstm_params``) at |model| = 2 and 4: the output
  and the gradients of every weight (each rank's, gathered) and of the
  input against the reference's mixers and ``jax.grad`` from the same
  weights, ``max |Δ| <= 3e-2 · max |g|`` a leaf, the single-device
  mixers' rule in ``tests/test_torch_xlstm_train.py``; the mLSTM at
  s = 256 takes the chunkwise form on one head a rank, the sLSTM at
  s = 256 the scan with its stash and backward on 32 channels a rank.
* The trainer's own loop (``launch.train._run``) from the reference's
  weights (``from_jax_params(mesh=)``) on (2, 1), (1, 2), (2, 2) with
  2 heads and (1, 4) with 4 heads, ``muon-syrk`` (the mesh AdamW path is
  the stablelm tests'), 3 steps: every rank's losses identical, within ``LOSS_RTOL`` = 5e-4
  of the port's single-device trainer and of the reference's jitted
  single-device train step; data replicas hold bit-equal blocks.
* Muon's words a rank a step on the xlstm leaves, leaf by leaf, are the
  1D schedule's closed form where ``_use_1d`` holds on a long-side split
  and one gather of the block where it declines; the routes at these
  shapes: ``wx`` (64, 256), embed (256, 64) and unembed (64, 256) take
  the 1D schedule on every mesh, the mLSTM's (64, 64) projections and
  both ``wo`` are gathered, ``wif`` (64, 8) at 4 heads is gathered (at
  2 heads it is (64, 4), no Muon matrix); the optimizer phase's words
  a step are their sum.
* ``--ckpt-dir`` on (2, 2) (``muon-syrk --track-gram``): a run killed by
  ``--fail-at 3`` and resumed on (2, 2) equals the uninterrupted run bit
  for bit; the same checkpoint resumed through the CLI's own launch on
  2 ranks, (1, 2), within ``LOSS_RTOL`` of the uninterrupted run, 0
  mismatches.
* A model axis that does not divide ``n_heads`` raises ``ValueError``
  naming ``n_heads``, the axis and ``--max-model``: from the launcher
  before any rank starts, and from ``Model.shard_`` on a rank.
"""
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config as tcfg
from repro_torch.core.onedim import _padded_tril_len
from repro_torch.distributed.launch import run_ranks
from repro_torch.launch import train as ttrain
from repro_torch.models.common import ArchConfig
from repro_torch.models.model import from_jax_params
from test_torch_hygiene import limit_torch_threads  # noqa: F401

TESTS = os.path.dirname(os.path.abspath(__file__))
ARCH = "xlstm-350m"
STEPS = 3
LOSS_RTOL = 5e-4
LEAF_RTOL = 3e-2            # tests/test_torch_xlstm_train.py's mixer rule
D_MODEL, B = 64, 2
#: (kind, s, heads) of the mixer cases per world size (= |model|)
MIXERS = {2: [("mlstm", 32, 2), ("slstm", 256, 2)],
          4: [("mlstm", 256, 4), ("slstm", 32, 4)]}
#: (data, model, optimizer, heads) of the trainer cases per world size
CASES = {2: [(2, 1, "muon-syrk", 2), (1, 2, "muon-syrk", 2)],
         4: [(2, 2, "muon-syrk", 2), (1, 4, "muon-syrk", 4)]}
ALL = [(w, i) for w in CASES for i in range(len(CASES[w]))]
#: the Muon route of each matrix leaf of the smoke model on (data, P)
ROUTES = {
    2: {"embed": "1d", "unembed": "1d", "b3/mixer/wx": "1d",
        "b3/mixer/wo": "gather",
        **{f"b{i}/mixer/{w}": "gather" for i in range(3)
           for w in ("wq", "wk", "wv", "wo_gate", "wo")}},
    4: {"embed": "1d", "unembed": "1d", "b3/mixer/wx": "1d",
        "b3/mixer/wo": "gather",
        **{f"b{i}/mixer/{w}": "gather" for i in range(3)
           for w in ("wq", "wk", "wv", "wo_gate", "wo", "wif")}},
}


def _cfg(heads):
    """The port's smoke config with ``heads`` heads."""
    return dataclasses.replace(tcfg(ARCH), n_heads=heads, n_kv_heads=heads)


def _jcfg(heads):
    """The reference's smoke config with ``heads`` heads, checked equal
    to the port's."""
    from repro.configs import get_smoke_config
    cj = dataclasses.replace(get_smoke_config(ARCH), n_heads=heads,
                             n_kv_heads=heads)
    ref, mine = dataclasses.asdict(cj), dataclasses.asdict(_cfg(heads))
    assert mine == {k: ref[k] for k in mine}
    return cj


def _args(**kw):
    args = ttrain.build_argparser().parse_args([])
    for k, v in dict(device="cpu", arch=ARCH, steps=STEPS, global_batch=4,
                     seq_len=32, loss_chunk=16, log_every=1).items():
        setattr(args, k, v)
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def _capture(fn, np_tree=None):
    """``fn()`` with ``launch.train.init_model`` building from the
    reference's weights ``np_tree`` (from the seed when None): (fn's
    result, the model)."""
    made, init = [], ttrain.init_model

    def keep(cfg, seed, device, **kw):
        made.append(init(cfg, seed=seed, device=device, **kw)
                    if np_tree is None
                    else from_jax_params(np_tree, cfg, device=device, **kw))
        return made[-1]

    ttrain.init_model = keep
    try:
        return fn(), made[-1]
    finally:
        ttrain.init_model = init


# ---------------------------------------------------------------------------
# the reference (this process only: the ranks never import jax)
# ---------------------------------------------------------------------------
_REF = {}


def _mixer_inputs(kind, s, heads):
    """The reference's mixer weights, x and the output's cotangent, as
    numpy."""
    import jax

    from repro.models import ssm as jssm
    from repro.models.common import ArchConfig as JArchConfig
    kw = dict(name="mixer", n_layers=1, d_model=D_MODEL, n_heads=heads,
              n_kv_heads=heads, d_ff=0, vocab=16)
    init = jssm.mlstm_params if kind == "mlstm" else jssm.slstm_params
    params = init(JArchConfig(**kw), jax.random.key(s + heads))
    r = np.random.default_rng(s + 10 * heads)
    x = r.standard_normal((B, s, D_MODEL)).astype(np.float32)
    w = r.standard_normal((B, s, D_MODEL)).astype(np.float32)
    return ({k: np.asarray(v, np.float32) for k, v in params.items()}, x, w,
            kw)


def _mixer_reference(kind, s, heads):
    """The reference mixer's output and ``jax.grad`` of the weights and
    x, bf16 as the model runs it."""
    import jax
    import jax.numpy as jnp

    from repro.models import ssm as jssm
    from repro.models.common import ArchConfig as JArchConfig
    params, x, w, kw = _mixer_inputs(kind, s, heads)
    cfg = JArchConfig(**kw)
    mix = jssm.mlstm_mixer if kind == "mlstm" else jssm.slstm_mixer

    def f(p, xb):
        out, _ = mix(cfg, p, xb)
        return (out.astype(jnp.float32) * w).sum(), out

    bf = lambda a: jnp.asarray(a, jnp.bfloat16)       # noqa: E731
    (_, out), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(jax.tree.map(bf, params), bf(x))
    return (np.asarray(out, np.float32),
            {k: np.asarray(v, np.float32) for k, v in gp.items()},
            np.asarray(gx, np.float32))


def _reference_init(heads):
    """The reference's init of the smoke config with ``heads`` heads, as
    jax arrays and as numpy."""
    if ("init", heads) not in _REF:
        import jax

        from repro.models.model import init_params
        params = init_params(_jcfg(heads), jax.random.key(_args().seed))
        _REF["init", heads] = (params, jax.tree.map(np.asarray, params))
    return _REF["init", heads]


def _reference_losses(optimizer, heads):
    """The reference's jitted single-device train step from its init on
    the same data: its losses (its "muon" runs muon-syrk's chain on one
    device)."""
    key = (optimizer, heads)
    if key not in _REF:
        import jax

        from repro.data import DataConfig, make_train_iterator
        from repro.launch.steps import make_optimizer, make_train_step
        cj = _jcfg(heads)
        params, _ = _reference_init(heads)
        args = _args(optimizer=optimizer)
        opt = make_optimizer(cj, "muon" if optimizer.startswith("muon")
                             else optimizer, lr=args.lr)
        step = jax.jit(make_train_step(cj, opt, loss_chunk=args.loss_chunk))
        state = opt.init(params)
        it = make_train_iterator(DataConfig(
            seq_len=args.seq_len, global_batch=args.global_batch,
            vocab_size=cj.vocab, seed=args.data_seed))
        losses = []
        try:
            for _ in range(STEPS):
                params, state, metrics = step(params, state, next(it))
                losses.append(float(metrics["loss"]))
        finally:
            it.close()
        _REF[key] = losses
    return _REF[key]


# ---------------------------------------------------------------------------
# one rank
# ---------------------------------------------------------------------------
def _mixer_case(kind, s, heads, params, x, w, kw):
    """The tensor-parallel mixer on this rank's block of ``params`` on
    (1, world): the output and the gradients, each gathered whole."""
    from repro_torch.distributed.mesh import make_mesh
    from repro_torch.models import ssm
    from repro_torch.models.sharding import (gather_leaf, leaf_spec,
                                             shard_leaf)
    cfg = ArchConfig(**kw)
    mesh = make_mesh({"data": 1, "model": torch.distributed.get_world_size()},
                     device="cpu")
    p = torch.nn.Module()
    specs = {}
    for k, v in params.items():
        specs[k] = leaf_spec(cfg, k, v.shape, mesh)
        whole = torch.tensor(v).to(torch.bfloat16)
        setattr(p, k, torch.nn.Parameter(
            shard_leaf(whole, specs[k], mesh).clone()))
    assert all("model" in sp for sp in specs.values()), specs
    p.tp = mesh.comm("model")
    xt = torch.tensor(x).to(torch.bfloat16).requires_grad_(True)
    mix = ssm.mlstm_mixer if kind == "mlstm" else ssm.slstm_mixer
    out, _ = mix(cfg, p, xt)
    (out.float() * torch.tensor(w)).sum().backward()
    return {"out": out.detach().float().numpy(),
            "gx": xt.grad.float().numpy(),
            "gp": {k: gather_leaf(getattr(p, k).grad, specs[k], mesh)
                   .float().numpy() for k in params},
            "local": {k: tuple(getattr(p, k).shape) for k in params}}


def _train_case(np_tree, data, model_ax, optimizer, heads):
    from repro_torch.distributed import collectives
    from repro_torch.distributed.mesh import make_mesh
    mesh = make_mesh({"data": data, "model": model_ax}, device="cpu")
    args = _args(optimizer=optimizer, devices=data * model_ax)
    cfg = _cfg(heads)
    out, model = _capture(lambda: ttrain._run(args, cfg, mesh.device,
                                              mesh=mesh, say=lambda s: None),
                          np_tree)
    res = {"coords": {a: mesh.index(a) for a in mesh.shape},
           "losses": out["losses"], "words": out["words"],
           "specs": model.specs,
           "blocks": {k: v.float().numpy()
                      for k, v in model.stacked().items()}}
    if optimizer == "muon-syrk":
        # Muon's words leaf by leaf, on this run's shapes
        opt = ttrain.make_optimizer(cfg, optimizer, mesh=mesh,
                                    specs=model.specs)
        gen = torch.Generator().manual_seed(mesh.rank)
        res["ns_words"] = {}
        for k, v in model.stacked().items():
            shape = tuple(n * (model_ax if a else 1)
                          for n, a in zip(v.shape, model.specs[k]))
            if len(shape) < 2 or min(shape[-2:]) < 8:
                continue
            collectives.reset_word_counts()
            opt._orthogonalize_shard(torch.randn(v.shape, generator=gen),
                                     model.specs[k])
            res["ns_words"][k] = collectives.word_counts()
    return res


def _ckpt_runs(root):
    """On (2, 2), ``muon-syrk --track-gram`` 4 steps saving every 2:
    uninterrupted (``u22``), killed by ``--fail-at 3`` (``k22``, whose
    step-2 checkpoint rank 0 then copies to ``k22_to12``) and resumed on
    the same mesh."""
    from repro_torch.distributed.mesh import make_mesh
    mesh = make_mesh({"data": 2, "model": 2}, device="cpu")
    cfg = _cfg(2)

    def run(name, **kw):
        args = _args(optimizer="muon-syrk", track_gram=True, steps=4,
                     ckpt_every=2, devices=4, max_model=2,
                     ckpt_dir=os.path.join(root, name), **kw)
        return ttrain._run(args, cfg, mesh.device, mesh=mesh,
                           say=lambda s: None)

    u = run("u22")
    with pytest.raises(ttrain.InjectedFailure):
        run("k22", fail_at=3)
    if mesh.rank == 0:               # the writer: its saves are committed
        shutil.copytree(os.path.join(root, "k22"),
                        os.path.join(root, "k22_to12"))
    r = run("k22")
    return {"u": u["losses"], "r": r["losses"],
            "r_start": r["start_step"], "r_resumed": r["resumed"],
            "r_mismatches": r["restore_verified"]["mismatches"]}


def _refused_split():
    """``init_model`` of the 2-head config on (1, 4): the message."""
    from repro_torch.distributed.mesh import make_mesh
    from repro_torch.models.model import init_model
    mesh = make_mesh({"data": 1, "model": 4}, device="cpu")
    try:
        init_model(_cfg(2), device="cpu", mesh=mesh)
    except ValueError as e:
        return str(e)
    return None


def rank_main(mesh_x, mixers, cases, trees, root):
    world = torch.distributed.get_world_size()
    out = {"mixers": [_mixer_case(*m) for m in mixers],
           "train": [_train_case(trees[c[3]], *c) for c in cases]}
    if world == 4:
        out["ckpt"] = _ckpt_runs(root)
        out["refused"] = _refused_split()
    return out


_RESULTS = {}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("xlstm_mesh")


def _results(world, root):
    if world not in _RESULTS:
        mixers = [(k, s, h, *_mixer_inputs(k, s, h))
                  for k, s, h in MIXERS[world]]
        trees = {h: _reference_init(h)[1] for h in (2, 4)}
        _RESULTS[world] = run_ranks(
            "test_torch_xlstm_mesh:rank_main", world, device="cpu",
            paths=[TESTS], timeout=600,
            kwargs={"mixers": mixers, "cases": CASES[world],
                    "trees": trees, "root": str(root)})
    return _RESULTS[world]


_SINGLE = {}


def _single(optimizer, heads):
    """The port's single-device trainer from the reference's init on the
    same data: its losses."""
    key = (optimizer, heads)
    if key not in _SINGLE:
        cfg = _cfg(heads)
        args = _args(optimizer=optimizer)
        out, _ = _capture(lambda: ttrain._run(args, cfg, torch.device("cpu"),
                                              say=lambda s: None),
                          _reference_init(heads)[1])
        _SINGLE[key] = out["losses"]
    return _SINGLE[key]


def _close(got, want, key):
    err = np.abs(got - want).max()
    assert err <= LEAF_RTOL * np.abs(want).max(), (key, err)


# ---------------------------------------------------------------------------
# the mixers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world,i", [(w, i) for w in MIXERS
                                     for i in range(len(MIXERS[w]))])
def test_tensor_parallel_mixers_match_jax_grad(root, world, i):
    kind, s, heads = MIXERS[world][i]
    out, gp, gx = _mixer_reference(kind, s, heads)
    ranks = [r["mixers"][i] for r in _results(world, root)]
    # each rank holds its heads or channels: a 1/P column block of the
    # projections, a 1/P row block of wo
    for k, shape in ranks[0]["local"].items():
        whole = gp[k].shape
        split = 0 if k == "wo" else 1
        assert shape[split] * world == whole[split], (k, shape, whole)
    for r in ranks:
        _close(r["out"], out, "out")
        _close(r["gx"], gx, "x")
        assert r["gp"].keys() == gp.keys()
        for k in gp:
            _close(r["gp"][k], gp[k], k)
    for r in ranks[1:]:                 # replicated results, every rank
        assert np.array_equal(r["out"], ranks[0]["out"])
        assert np.array_equal(r["gx"], ranks[0]["gx"])


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------
def _case(world, i, root):
    return [r["train"][i] for r in _results(world, root)]


@pytest.mark.parametrize("world,i", ALL)
def test_mesh_trainer_follows_one_device_and_the_reference(root, world, i):
    ranks = _case(world, i, root)
    _, _, optimizer, heads = CASES[world][i]
    losses = ranks[0]["losses"]
    assert len(losses) == STEPS and all(np.isfinite(losses))
    for r in ranks[1:]:
        assert r["losses"] == losses, "ranks disagree"
    np.testing.assert_allclose(losses, _single(optimizer, heads),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(losses, _reference_losses(optimizer, heads),
                               rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("world,i", ALL)
def test_data_replicas_hold_bit_equal_blocks(root, world, i):
    ranks = _case(world, i, root)
    data, model_ax = CASES[world][i][:2]
    pairs = 0
    for a in ranks:
        for b in ranks:
            if a is not b and a["coords"]["model"] == b["coords"]["model"]:
                pairs += 1
                for k in a["blocks"]:
                    assert np.array_equal(a["blocks"][k], b["blocks"][k]), k
    assert pairs == data * (data - 1) * model_ax
    # the mixers' projections are split over 'model' (a trivial split
    # where it is 1), their blocks 1/|model| of the columns
    specs, blocks = ranks[0]["specs"], ranks[0]["blocks"]
    for w in ("wq", "wk", "wv", "wif", "wo_gate", "wx"):
        k = ("periods", "b3" if w == "wx" else "b0", "mixer", w)
        assert specs[k] == (None, None, "model"), (w, specs[k])
        d = _cfg(CASES[world][i][3]).d_model
        cols = {"wif": 2 * CASES[world][i][3], "wx": 4 * d}.get(w, d)
        assert blocks[k].shape[-1] * model_ax == cols, (w, blocks[k].shape)


def _ns_closed_form(shape, spec, P, use_1d, steps=5):
    """A rank's words for one Muon leaf block of ``shape`` under
    ``spec``: the 1D schedule (packed reduce-scatter and all-gather of
    the short side's padded triangle each NS step, one all-reduce of
    the norms) or one gather of the block."""
    if P == 1 or all(a is None for a in spec):
        return {}
    lead = int(np.prod(shape[:-2]))
    if use_1d:
        m = min(shape[-2] * (P if spec[-2] else 1),
                shape[-1] * (P if spec[-1] else 1))
        lp = lead * _padded_tril_len(m, P)
        return {"reduce_scatter": steps * (lp * (P - 1) // P),
                "all_gather": steps * (lp // P * (P - 1)),
                "all_reduce": 2 * lead * (P - 1) // P}
    return {"all_gather": int(np.prod(shape)) * (P - 1)}


@pytest.mark.parametrize("world,i", [(w, i) for w, i in ALL
                                     if CASES[w][i][2] == "muon-syrk"])
def test_muon_words_are_the_closed_forms(root, world, i):
    from repro_torch.core.dispatch import choose_algorithm
    ranks = _case(world, i, root)
    _, P, _, _ = CASES[world][i]
    for r in ranks:
        total, routes = {}, {}
        for k, words in r["ns_words"].items():
            spec, shape = r["specs"][k], r["blocks"][k].shape
            gshape = [n * (P if a else 1) for n, a in zip(shape, spec)]
            rows, cols = gshape[-2:]
            use_1d = P > 1 and choose_algorithm(
                min(rows, cols), max(rows, cols), P, m=1).case == 1 and (
                (spec[-1] is not None and rows <= cols)
                or (spec[-2] is not None and rows >= cols))
            want = _ns_closed_form(shape, spec, P, use_1d)
            assert words == want, (k, spec, gshape, words, want)
            if want:
                routes["/".join(k[1:] if k[0] == "periods" else k)] = \
                    "1d" if use_1d else "gather"
            for kind, w in want.items():
                total[kind] = total.get(kind, 0) + w
        assert routes == ({} if P == 1 else ROUTES[P]), routes
        for step in r["words"]:
            assert step["opt"] == total


# ---------------------------------------------------------------------------
# checkpoints, and resumes on the same and on another device count
# ---------------------------------------------------------------------------
def test_mesh_kill_then_resume_is_bit_exact(root):
    ranks = [r["ckpt"] for r in _results(4, root)]
    u = ranks[0]["u"]
    assert len(u) == 4 and all(np.isfinite(u))
    for r in ranks:
        assert r["u"] == u
        assert r["r_resumed"] and r["r_start"] == 2
        assert r["r_mismatches"] == []
        assert r["r"] == u[2:]


def test_resume_onto_another_device_count(root):
    """The (2, 2) run's step-2 checkpoint resumed by ``train --devices 2
    --max-model 2``, (1, 2), through the CLI's own launch."""
    u = _results(4, root)[0]["ckpt"]["u"]
    out = ttrain.train(_args(
        optimizer="muon-syrk", track_gram=True, steps=4, ckpt_every=2,
        devices=2, max_model=2, ckpt_dir=str(root / "k22_to12")))
    assert out["mesh"] == {"data": 1, "model": 2}
    assert out["resumed"] and out["start_step"] == 2 and out["steps"] == 2
    assert out["restore_verified"]["mismatches"] == []
    assert all(r["losses"] == out["losses"] for r in out["ranks"])
    np.testing.assert_allclose(out["losses"], u[2:], rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# a model axis that would cut a head
# ---------------------------------------------------------------------------
def test_a_model_axis_that_cuts_a_head_raises(root):
    with pytest.raises(ValueError, match=r"n_heads=2 does not split over "
                       r"model=4.*--max-model"):
        ttrain.train(_args(devices=4, max_model=4))
    msg = _results(4, root)[0]["refused"]
    assert msg is not None and "n_heads=2" in msg and "model=4" in msg
