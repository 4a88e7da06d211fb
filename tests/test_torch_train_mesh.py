"""``train --devices N`` on a (data, model) mesh of gloo CPU ranks
against the reference's jitted train step and the port's single-device
trainer, at the stablelm smoke config, every run from the reference's
init (``from_jax_params(..., mesh=)``).

The reference's mesh trainer raises ``ShardingTypeError`` on this jax
(ROADMAP queue C), so the oracles are the reference's single-device
train step (``repro.launch.steps.make_train_step`` under ``jax.jit``, as
``tests/test_torch_train.py`` follows it), the port's single-device
trainer on the same weights and data, and the closed forms of the 1D
schedule's words.  One launch per world size (2 and 4 ranks) runs every
case of that size in turn, each through the trainer's own loop
(``launch.train._run``) on a mesh made with
``distributed.mesh.make_mesh``:

* meshes (2, 1), (1, 2), (1, 4) and (2, 2), AdamW and ``muon-syrk``, 3
  steps: every rank's losses identical; the losses within
  ``rtol=5e-4`` of the reference's and of the single-device run's (a
  step moves the loss by 5e-3 of itself with AdamW, 3e-2 with Muon;
  measured at most 2.8e-4 and 2.0e-4),
  step 0's within ``1e-6`` of the single-device run's where 'model'
  is 1 (the f32 sum of the token losses, split by data rank, is
  reassociated: one ulp on these weights; tensor parallelism also sums
  the bf16 products in another order); the
  parameters after 3 steps, gathered, within ``2e-3`` of the
  single-device run's in relative Frobenius norm over the whole model,
  and each matrix leaf within ``1e-2`` of its own norm.  Element by
  element no such bound holds: the weights are bf16, a rank's bf16
  gradients of its rows sum to another rounding than the whole
  batch's, and a step of ``p − lr·Δ`` then rounds some elements one ulp
  (2^-9 to 2^-8 of themselves) the other way — in 1-25 % of a matrix's
  elements after 3 Muon steps, on every mesh, (2, 1) too;
* ``--compress-grads`` with AdamW on (2, 1) (the int8 mean over 'data',
  each rank's own residual, before the clip) and on (1, 2) (clip, then
  compress, as on one device, on each rank's blocks): the losses and
  parameters held as above to the reference's and the single-device
  trainer's compressed steps; on (2, 1) each rank's bytes on the data
  axis are ``wire_bytes_per_device`` of each leaf's padded length;
* data replicas hold bit-equal blocks; the norms' gradients are
  bit-equal across model ranks; init on the mesh (``init_model`` and
  ``from_jax_params``) is the single-device init, bit for bit, and
  ``gather_leaf`` ∘ ``shard_leaf`` round-trips;
* Muon's words a step, leaf by leaf, are the 1D schedule's closed form
  where ``_use_1d`` holds (no gather) and one gather of the block
  where it declines; the optimizer phase's words a step are their sum;
* AdamW-8bit on (2, 2): its ``qblock`` blocks fall across a shard
  differently from the whole leaf; its losses are held to the
  single-device trainer's at the same ``rtol=5e-4`` (measured 6.0e-5),
  its parameters not compared (1.5e-3 of the model's norm, too near
  the bound to hold), and the reference's 8-bit AdamW does not trace
  under ``jax.jit`` on this jax, so it has no reference run;
* the refusals name their ROADMAP items, and the CLI's own launch
  (``train --devices 2``, init from the seed) follows the single-device
  trainer and reports the mesh and each rank's losses.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.core.onedim import _padded_tril_len
from repro_torch.distributed.compression import wire_bytes_per_device
from repro_torch.distributed.launch import run_ranks
from repro_torch.launch import train as ttrain
from repro_torch.models.model import from_jax_params

TESTS = os.path.dirname(os.path.abspath(__file__))
STEPS = 3
#: (data, model, optimizer, compress) per world size
CASES = {
    2: [(2, 1, "adamw", False), (2, 1, "muon-syrk", False),
        (1, 2, "adamw", False), (1, 2, "muon-syrk", False),
        (2, 1, "adamw", True), (1, 2, "adamw", True)],
    4: [(1, 4, "adamw", False), (1, 4, "muon-syrk", False),
        (2, 2, "adamw", False), (2, 2, "muon-syrk", False),
        (2, 2, "adamw8bit", False)],
}
LOSS_RTOL = 5e-4
STEP0_RTOL = 1e-6           # step 0 where 'model' is 1: f32 reordering
PARAM_TOL = 2e-3            # the whole model, relative Frobenius norm
LEAF_TOL = 1e-2             # each matrix leaf, relative Frobenius norm


def _args(**kw):
    args = ttrain.build_argparser().parse_args([])
    for k, v in dict(device="cpu", steps=STEPS, global_batch=4, seq_len=32,
                     loss_chunk=16, log_every=1).items():
        setattr(args, k, v)
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def _capture(fn, np_tree=None):
    """Run ``fn()`` with ``launch.train.init_model`` wrapped to keep the
    model it builds, from the reference's weights ``np_tree`` when given:
    (fn's result, the model)."""
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


def _reference_init():
    """The reference's init of the smoke config: (its config, its
    params, them as numpy)."""
    if "init" not in _REF:
        import dataclasses

        import jax

        from repro.configs import get_smoke_config
        from repro.models.model import init_params
        cj = get_smoke_config("stablelm-1.6b")
        args = _args()
        mine, ref = (dataclasses.asdict(c) for c in
                     (ttrain.build_config(args), cj))
        assert mine == {k: ref[k] for k in mine}
        params = init_params(cj, jax.random.key(args.seed))
        _REF["init"] = (cj, params, jax.tree.map(np.asarray, params))
    return _REF["init"]


def _reference_losses(optimizer, compress):
    """The reference's jitted train step from its init on the same data
    (``ErrorFeedbackInt8`` under ``compress``): its losses."""
    key = (optimizer, compress)
    if key not in _REF:
        import jax

        from repro.data import DataConfig, make_train_iterator
        from repro.distributed import ErrorFeedbackInt8
        from repro.launch.steps import make_optimizer, make_train_step
        cj, params, _ = _reference_init()
        args = _args(optimizer=optimizer)
        opt = make_optimizer(cj, optimizer, lr=args.lr)
        comp = ErrorFeedbackInt8() if compress else None
        step = jax.jit(make_train_step(cj, opt, loss_chunk=args.loss_chunk,
                                       compressor=comp))
        state = opt.init(params)
        if comp is not None:
            state = (state, comp.init(params))
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
def _one_case(np_tree, data, model_ax, optimizer, compress):
    from repro_torch.data import DataConfig, make_train_iterator
    from repro_torch.distributed import collectives
    from repro_torch.distributed.mesh import make_mesh
    from repro_torch.models.model import init_model, lm_loss_terms
    from repro_torch.models.sharding import (batch_specs, gather_leaf,
                                             is_sharded, shard_leaf)
    mesh = make_mesh({"data": data, "model": model_ax}, device="cpu")
    args = _args(optimizer=optimizer, compress_grads=compress,
                 devices=data * model_ax)
    cfg = ttrain.build_config(args)
    out, model = _capture(lambda: ttrain._run(args, cfg, mesh.device,
                                              mesh=mesh, say=lambda s: None),
                          np_tree)
    res = {"mesh": (data, model_ax), "rank": mesh.rank,
           "coords": {a: mesh.index(a) for a in mesh.shape},
           "losses": out["losses"], "words": out["words"],
           "bytes": out["bytes"], "specs": model.specs,
           "blocks": {k: v.float().numpy()
                      for k, v in model.stacked().items()}}
    # init on the mesh is the single-device init, and the blocks
    # round-trip through gather_leaf
    trips = []
    for make in (lambda **kw: init_model(cfg, seed=args.seed, device="cpu",
                                         **kw),
                 lambda **kw: from_jax_params(np_tree, cfg, device="cpu",
                                              **kw)):
        fresh, whole = make(mesh=mesh), make().stacked()
        for k, v in fresh.stacked().items():
            full = gather_leaf(v, fresh.specs[k], mesh)
            trips.append(torch.equal(full, whole[k]) and torch.equal(
                shard_leaf(full, fresh.specs[k], mesh), v))
    res["init_roundtrip"] = all(trips)
    res["params"] = {k: gather_leaf(v, model.specs[k], mesh).float().numpy()
                     for k, v in model.stacked().items()}
    # the replicated leaves' gradients on this rank's rows
    it = make_train_iterator(DataConfig(
        seq_len=args.seq_len, global_batch=args.global_batch,
        vocab_size=cfg.vocab, seed=args.data_seed), device="cpu")
    try:
        batch = next(it)
    finally:
        it.close()
    bs = batch_specs(cfg, mesh, args.global_batch, False)
    batch = {k: shard_leaf(v, bs[k], mesh) for k, v in batch.items()}
    model.zero_grad(set_to_none=True)
    tot, cnt = lm_loss_terms(model, batch, chunk=args.loss_chunk)
    (tot / cnt).backward()
    res["rep_grads"] = {k: g.float().numpy() for k, g in
                        model.stacked(lambda p: p.grad).items()
                        if not is_sharded(model.specs[k])}
    # Muon's words leaf by leaf, on this run's shapes
    if optimizer == "muon-syrk":
        opt = ttrain.make_optimizer(cfg, optimizer, mesh=mesh,
                                    specs=model.specs)
        per_leaf = {}
        gen = torch.Generator().manual_seed(mesh.rank)
        for k, v in model.stacked().items():
            if v.ndim < 2 or min(v.shape[-2:]) < 8:
                continue
            collectives.reset_word_counts()
            opt._orthogonalize_shard(
                torch.randn(v.shape, generator=gen), model.specs[k])
            per_leaf[k] = collectives.word_counts()
        res["ns_words"] = per_leaf
    return res


def rank_main(mesh_x, cases, np_tree):
    return [_one_case(np_tree, *c) for c in cases]


_RESULTS = {}


def _results(world):
    if world not in _RESULTS:
        _RESULTS[world] = run_ranks(
            "test_torch_train_mesh:rank_main", world, device="cpu",
            paths=[TESTS], timeout=400,
            kwargs={"cases": CASES[world], "np_tree": _reference_init()[2]})
    return _RESULTS[world]


_SINGLE = {}


def _single(optimizer, compress=False, from_reference=True):
    """The single-device trainer on the same data, from the reference's
    init (or from the seed): (summary, final params)."""
    key = (optimizer, compress, from_reference)
    if key not in _SINGLE:
        out, model = _capture(lambda: ttrain.train(_args(
            optimizer=optimizer, compress_grads=compress)),
            _reference_init()[2] if from_reference else None)
        _SINGLE[key] = (out, {k: v.float().numpy() for k, v in
                              model.stacked().items()})
    return _SINGLE[key]


def _case(world, i):
    return [r[i] for r in _results(world)]


ALL = [(w, i) for w in CASES for i in range(len(CASES[w]))]


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world,i", ALL)
def test_ranks_agree_and_follow_the_single_device_trainer(world, i):
    ranks = _case(world, i)
    data, model_ax, optimizer, compress = CASES[world][i]
    losses = ranks[0]["losses"]
    assert len(losses) == STEPS and all(np.isfinite(losses))
    for r in ranks[1:]:
        assert r["losses"] == losses, "ranks disagree"
    want, params = _single(optimizer, compress)
    np.testing.assert_allclose(losses, want["losses"], rtol=LOSS_RTOL)
    if model_ax == 1:                   # before any update
        np.testing.assert_allclose(losses[0], want["losses"][0],
                                   rtol=STEP0_RTOL)
    if optimizer == "adamw8bit":
        return
    got = ranks[0]["params"]
    assert got.keys() == params.keys()
    diff = sum(float(np.sum((got[k] - p) ** 2)) for k, p in params.items())
    norm = sum(float(np.sum(p ** 2)) for p in params.values())
    assert diff <= PARAM_TOL ** 2 * norm, (diff / norm) ** 0.5
    for k, p in params.items():
        if p.ndim >= 2 and min(p.shape[-2:]) >= 8:
            rel = np.linalg.norm(got[k] - p) / np.linalg.norm(p)
            assert rel <= LEAF_TOL, (k, rel)


@pytest.mark.parametrize("world,i", [(w, i) for w, i in ALL
                                     if CASES[w][i][2] != "adamw8bit"])
def test_follows_the_reference_train_step(world, i):
    """The mesh run's losses against the reference's jitted train step
    from the same weights on the same data."""
    _, _, optimizer, compress = CASES[world][i]
    np.testing.assert_allclose(_case(world, i)[0]["losses"],
                               _reference_losses(optimizer, compress),
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("world,i", ALL)
def test_replicas_bit_equal_and_init_round_trips(world, i):
    """Data replicas hold the same blocks; the norms' gradients are
    the same on every model rank of a data row; init and the gather
    round-trip."""
    ranks = _case(world, i)
    assert all(r["init_roundtrip"] for r in ranks)
    for a in ranks:
        for b in ranks:
            if a["coords"]["model"] == b["coords"]["model"]:
                for k in a["blocks"]:
                    assert np.array_equal(a["blocks"][k], b["blocks"][k]), k
            if a["coords"]["data"] == b["coords"]["data"]:
                assert a["rep_grads"].keys() == b["rep_grads"].keys()
                for k in a["rep_grads"]:
                    assert np.array_equal(a["rep_grads"][k],
                                          b["rep_grads"][k]), k
    assert ("final_norm", "scale") in ranks[0]["rep_grads"]


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
def test_muon_words_are_the_closed_forms(world, i):
    from repro_torch.core.dispatch import choose_algorithm
    ranks = _case(world, i)
    data, P, _, _ = CASES[world][i]
    for r in ranks:
        total = {}
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
            for kind, w in want.items():
                total[kind] = total.get(kind, 0) + w
        for step in r["words"]:
            assert step["opt"] == total
    # the smoke model's embeddings take the 1D schedule on every mesh
    assert "reduce_scatter" in ranks[0]["ns_words"][("embed",)] or P == 1


def test_compressed_bytes_are_the_byte_model():
    world, i = 2, CASES[2].index((2, 1, "adamw", True))
    for r in _case(world, i):
        want = 0.0
        for v in r["blocks"].values():
            nb = -(-v.size // 256)
            nb += (-nb) % 2
            want += wire_bytes_per_device(nb * 256, 2, compressed=True)
        for step in r["bytes"]:
            assert sum(step["reduce"].values()) == want
            assert set(step["reduce"]) == {"all_to_all", "all_gather"}


@pytest.mark.parametrize("flags,item", [
    (dict(arch="xlstm-350m"), "ROADMAP A9"),
])
def test_mesh_refusals_name_their_items(flags, item):
    with pytest.raises(NotImplementedError, match=item):
        ttrain.train(_args(devices=2, **flags))


def test_global_batch_must_divide_the_data_axis():
    with pytest.raises(SystemExit, match="data axis 2"):
        ttrain.train(_args(devices=2, max_model=1, global_batch=3))


def test_cli_launch_reports_the_mesh_and_every_rank():
    """``train --devices 2`` through ``run_ranks``: planned to (1, 2) at
    ``--max-model 2``, init from the seed: every rank's losses identical
    and within ``LOSS_RTOL`` of the single-device trainer's from the
    same seed."""
    out = ttrain.train(_args(devices=2, max_model=2, optimizer="muon-syrk"))
    assert out["mesh"] == {"data": 1, "model": 2}
    assert len(out["ranks"]) == 2
    assert all(r["losses"] == out["losses"] for r in out["ranks"])
    want, _ = _single("muon-syrk", from_reference=False)
    np.testing.assert_allclose(out["losses"], want["losses"],
                               rtol=LOSS_RTOL)
    assert out["words_a_rank"]["reduce_scatter"] > 0
    assert all(r["peak_memory_bytes"] is None for r in out["ranks"])
