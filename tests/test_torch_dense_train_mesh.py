"""The dense families trained on a (data, model) mesh of gloo CPU ranks
with ``fsdp_params`` (ZeRO-3: every attention, MLP, embed and unembed
weight also split over 'data', gathered where it is used and again in
the per-period recompute, its gradient reduce-scattered), against the
port's single-device run and the reference's jitted train step from the
same init (``from_jax_params``) on the same data.

The smoke configs are the reference's, with ``fsdp_params`` turned on
as the published gemma2 / gemma3 / granite / pixtral configs set it
(musicgen's too, so that its frames model, which has no embed table,
splits its head over 'data').  One launch of 4 ranks runs every case in
turn, 3 steps each: gemma2-9b (AdamW, and ``muon-syrk``: Muon's gather
of a block split over both axes), gemma3-12b, pixtral-12b (text tokens,
as the trainer feeds it; and with a tied head, ``embed.T`` split over
'model' on its vocab columns) and musicgen-large (frames through
``make_train_step``, as the trainer refuses it) on (2, 2), and
granite-20b on (4, 1) (its single KV head keeps the model axis at 1).
The token families run through the trainer's own loop
(``launch.train._run``).

* every rank's losses identical; within ``rtol=5e-4`` of the port's
  single-device run and of the reference's train step a step
  (``tests/test_torch_train_mesh.py``'s bound); the parameters after 3
  steps, gathered, within ``2e-3`` of the single-device run's in
  relative Frobenius norm over the whole model (bf16 weights: see that
  file for why no elementwise bound holds);
* each rank's words a step in the loss + backward phase: the all-gather
  of every block split over 'data', (D − 1) times the block, twice for a
  layer's weights (the forward and the per-period recompute) and once
  for embed and the head (a tied embed twice: the rows and the head),
  and one reduce-scatter of each gradient, (D − 1) times the block, as
  the closed form from the shapes and specs;
* the (2, 2) AdamW run's last checkpoint (each leaf gathered over both
  axes to rank 0, which writes) restores on one device equal to the
  gathered parameters, bit for bit, and the reference's
  ``restore_checkpoint`` reads it, leaf for leaf the port's.
"""
import dataclasses
import functools
import math
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.distributed.launch import run_ranks
from repro_torch.launch import train as ttrain
from repro_torch.models.model import from_jax_params
from test_torch_hygiene import limit_torch_threads  # noqa: F401

TESTS = os.path.dirname(os.path.abspath(__file__))
STEPS = 3
#: (arch, data, model, optimizer, tied head); the first saves a checkpoint
CASES = [("gemma2-9b", 2, 2, "adamw", False),
         ("gemma2-9b", 2, 2, "muon-syrk", False),
         ("gemma3-12b", 2, 2, "adamw", False),
         ("pixtral-12b", 2, 2, "adamw", False),
         ("pixtral-12b", 2, 2, "adamw", True),
         ("musicgen-large", 2, 2, "adamw", False),
         ("granite-20b", 4, 1, "adamw", False)]
ARCHS = sorted({(c[0], c[4]) for c in CASES})
LOSS_RTOL = 5e-4
PARAM_TOL = 2e-3            # the whole model, relative Frobenius norm


def _cfg(arch, tied=False):
    return dataclasses.replace(get_smoke_config(arch), fsdp_params=True,
                               tie_embeddings=tied)


def _args(**kw):
    args = ttrain.build_argparser().parse_args([])
    for k, v in dict(device="cpu", steps=STEPS, global_batch=4, seq_len=32,
                     loss_chunk=16, log_every=1).items():
        setattr(args, k, v)
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def _frames_run(np_tree, cfg, args, mesh=None):
    """musicgen's train step on the frames stand-in, on one device or on
    ``mesh`` (each data rank its rows): (losses, words a step, model)."""
    from repro_torch.data import DataConfig, make_train_iterator
    from repro_torch.launch.steps import (init_opt_state, make_optimizer,
                                          make_train_step)
    from repro_torch.models.sharding import batch_specs, shard_leaf
    model = from_jax_params(np_tree, cfg, device="cpu",
                            **({} if mesh is None else {"mesh": mesh}))
    opt = make_optimizer(cfg, args.optimizer, lr=args.lr, mesh=mesh,
                         specs=model.specs)
    step = make_train_step(model, opt, loss_chunk=args.loss_chunk)
    state = init_opt_state(model, opt)
    it = make_train_iterator(DataConfig(
        seq_len=args.seq_len, global_batch=args.global_batch,
        vocab_size=cfg.vocab, seed=args.data_seed), frontend="embeddings",
        d_model=cfg.d_model, device="cpu")
    bs = batch_specs(cfg, mesh, args.global_batch, False) if mesh else None
    losses, words = [], []
    try:
        for _ in range(args.steps):
            batch = next(it)
            if bs is not None:
                batch = {k: shard_leaf(v, bs[k], mesh)
                         for k, v in batch.items()}
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            words.append(metrics["words"])
    finally:
        it.close()
    return losses, words, model


def _trainer_run(np_tree, cfg, args, mesh=None):
    """The trainer's loop (``launch.train._run``) from the reference's
    weights: (losses, words a step, model)."""
    made, init = [], ttrain.init_model

    def keep(cfg, seed, device, **kw):
        made.append(from_jax_params(np_tree, cfg, device=device, **kw))
        return made[-1]

    ttrain.init_model = keep
    try:
        out = ttrain._run(args, cfg, torch.device("cpu"), mesh=mesh,
                          say=lambda line: None)
    finally:
        ttrain.init_model = init
    return out["losses"], out["words"], made[-1]


def _run(np_tree, arch, tied, optimizer, mesh=None, **kw):
    cfg = _cfg(arch, tied)
    args = _args(arch=arch, optimizer=optimizer, **kw)
    fn = _frames_run if cfg.frontend == "embeddings" else _trainer_run
    return fn(np_tree, cfg, args, mesh)


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------
def _one_case(np_trees, ckpt_dir, i):
    from repro_torch.distributed.mesh import make_mesh
    from repro_torch.models.sharding import gather_leaf
    arch, data, model_ax, optimizer, tied = CASES[i]
    mesh = make_mesh({"data": data, "model": model_ax}, device="cpu")
    losses, words, model = _run(
        np_trees[arch, tied], arch, tied, optimizer, mesh,
        devices=data * model_ax, ckpt_dir=ckpt_dir if i == 0 else None)
    return {"rank": mesh.rank, "losses": losses, "words": words,
            "params": {k: gather_leaf(v, model.specs[k], mesh).float()
                       .numpy() for k, v in model.stacked().items()}}


def rank_main(mesh_x, np_trees, ckpt_dir):
    return [_one_case(np_trees, ckpt_dir, i) for i in range(len(CASES))]


# ---------------------------------------------------------------------------
# the oracles (this process)
# ---------------------------------------------------------------------------
_REF = {}


def _reference_init(arch, tied=False):
    """The reference's smoke init (with a tied head where ``tied``;
    jitted, bit-equal to the eager init): (its config, params, them as
    numpy)."""
    if (arch, tied) not in _REF:
        import jax

        from repro.configs import get_smoke_config as jcfg
        from repro.models.model import init_params
        cj = dataclasses.replace(jcfg(arch), tie_embeddings=tied)
        params = jax.jit(functools.partial(init_params, cj))(
            jax.random.key(_args().seed))
        _REF[arch, tied] = (cj, params, jax.tree.map(np.asarray, params))
    return _REF[arch, tied]


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    """Every case on 4 gloo ranks in one launch: (each rank's results,
    the first case's checkpoint dir)."""
    ckpt = str(tmp_path_factory.mktemp("dense_mesh_ckpt"))
    trees = {a: _reference_init(*a)[2] for a in ARCHS}
    ranks = run_ranks("test_torch_dense_train_mesh:rank_main", 4,
                      device="cpu", paths=[TESTS], timeout=600,
                      kwargs={"np_trees": trees, "ckpt_dir": ckpt})
    return ranks, ckpt


_SINGLE = {}


def _single(arch, tied, optimizer):
    """The port's single-device run of the same case: (losses, whole
    params as numpy)."""
    if (arch, tied, optimizer) not in _SINGLE:
        losses, _, model = _run(_reference_init(arch, tied)[2], arch, tied,
                                optimizer)
        _SINGLE[arch, tied, optimizer] = (losses, {
            k: v.float().numpy() for k, v in model.stacked().items()})
    return _SINGLE[arch, tied, optimizer]


def _reference_losses(arch, tied, optimizer):
    """The reference's jitted train step from its init on the same
    batches (frames for musicgen): its losses."""
    import jax

    from repro.data import DataConfig, make_train_iterator
    from repro.launch.steps import make_optimizer, make_train_step
    cj, params, _ = _reference_init(arch, tied)
    args = _args()
    opt = make_optimizer(cj, optimizer, lr=args.lr)
    step = jax.jit(make_train_step(cj, opt, loss_chunk=args.loss_chunk))
    state = opt.init(params)
    frames = {"frontend": "embeddings", "d_model": cj.d_model} \
        if cj.frontend == "embeddings" else {}
    it = make_train_iterator(DataConfig(
        seq_len=args.seq_len, global_batch=args.global_batch,
        vocab_size=cj.vocab, seed=args.data_seed), **frames)
    losses = []
    try:
        for _ in range(STEPS):
            params, state, metrics = step(params, state, next(it))
            losses.append(float(metrics["loss"]))
    finally:
        it.close()
    return losses


def _fsdp_words(cfg, data, model):
    """A rank's loss + backward words a step over 'data', from the shapes
    and specs alone: {"all_gather": ..., "reduce_scatter": ...}.  A tied
    embed is gathered (and its gradient scattered) for the rows and
    again for the head."""
    from repro_torch.models.model import Model
    from repro_torch.models.sharding import axis_size, param_specs
    shapes = Model(cfg, torch.Generator(),
                   torch.device("meta")).stacked_shapes()
    specs = param_specs(cfg, shapes, {"data": data, "model": model})
    sizes = {"data": data, "model": model}
    gathers = scatters = 0
    for k, shape in shapes.items():
        if data == 1 or "data" not in specs[k]:
            continue
        block = math.prod(shape) // math.prod(
            axis_size(sizes, a) for a in specs[k] if a is not None)
        tied = cfg.tie_embeddings and k == ("embed",)
        # a layer's weights: the forward's gather and the recompute's
        uses = 2 if k[0] == "periods" or tied else 1
        gathers += (data - 1) * block * uses
        scatters += (data - 1) * block * (2 if tied else 1)
    return {"all_gather": gathers, "reduce_scatter": scatters}


def _case(launch, i):
    return [r[i] for r in launch[0]]


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("i", range(len(CASES)))
def test_ranks_agree_and_follow_the_single_device_run(launch, i):
    arch, _, _, optimizer, tied = CASES[i]
    ranks = _case(launch, i)
    losses = ranks[0]["losses"]
    assert len(losses) == STEPS and all(np.isfinite(losses))
    for r in ranks[1:]:
        assert r["losses"] == losses, "ranks disagree"
    want, params = _single(arch, tied, optimizer)
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL)
    got = ranks[0]["params"]
    assert got.keys() == params.keys()
    diff = sum(float(np.sum((got[k] - p) ** 2)) for k, p in params.items())
    norm = sum(float(np.sum(p ** 2)) for p in params.values())
    assert diff <= PARAM_TOL ** 2 * norm, (diff / norm) ** 0.5


@pytest.mark.parametrize("i", range(len(CASES)))
def test_follows_the_reference_train_step(launch, i):
    arch, _, _, optimizer, tied = CASES[i]
    np.testing.assert_allclose(_case(launch, i)[0]["losses"],
                               _reference_losses(arch, tied, optimizer),
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("i", range(len(CASES)))
def test_fsdp_words_are_the_closed_form(launch, i):
    arch, data, model_ax, _, tied = CASES[i]
    want = _fsdp_words(_cfg(arch, tied), data, model_ax)
    assert want["all_gather"] > 0
    for r in _case(launch, i):
        for step in r["words"]:
            got = step["loss_backward"]
            assert {k: got.get(k, 0) for k in want} == want, (r["rank"],
                                                               got, want)


def test_checkpoint_restores_on_one_device_and_the_reference_reads_it(
        launch):
    """The (2, 2) run's checkpoint after 3 steps: restored on one device
    it is the gathered parameters bit for bit; the reference restores
    the same file, every leaf the port's restore."""
    import jax
    import jax.numpy as jnp

    from repro.distributed import restore_checkpoint as j_restore
    from repro.distributed.checkpoint import _flatten as j_flatten
    from repro.optim import AdamW as JAdamW
    from repro_torch.distributed import restore_checkpoint
    from repro_torch.distributed.checkpoint import _flatten
    from repro_torch.optim.adamw import AdamW
    ranks, ckpt = launch
    arch = CASES[0][0]
    _, _, np_tree = _reference_init(arch)
    model = from_jax_params(np_tree, _cfg(arch), device="cpu")
    like = {"params": model.stacked(), "opt": AdamW().init(model.stacked())}
    step, mine = restore_checkpoint(ckpt, like)
    assert step == STEPS and mine["opt"].step == STEPS
    gathered = ranks[0][0]["params"]
    assert mine["params"].keys() == gathered.keys()
    for k, v in mine["params"].items():
        assert np.array_equal(v.float().numpy(), gathered[k]), k
    shapes = jax.eval_shape(lambda: jax.tree.map(jnp.asarray, np_tree))
    jstep, back = j_restore(ckpt, {"params": shapes, "opt": jax.eval_shape(
        JAdamW().init, shapes)})
    assert jstep == STEPS
    ref = dict(j_flatten(back))
    got = _flatten(mine)
    assert [k for k, _ in got] == list(ref)
    for k, v in got:
        a = np.asarray(ref[k], np.float32) if not isinstance(v, int) \
            else np.int32(ref[k])
        b = v.float().numpy() if isinstance(v, torch.Tensor) else np.int32(v)
        assert np.array_equal(a, b), k
