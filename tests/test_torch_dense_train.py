"""Training the dense families on one device, against the JAX package at
their smoke configs (the reference's, field by field):

* ``train --device cpu`` (the port's trainer, from the reference's init
  through ``from_jax_params``) follows the reference's jitted
  ``make_train_step`` on the reference's data for 3 steps, losses within
  ``rtol=2e-3`` a step (``tests/test_torch_train.py``'s bound), for
  gemma2-9b (``muon-syrk``: post-block norms, scaled embeddings,
  softcaps), gemma3-12b (AdamW: the 5:1 sliding windows), granite-20b
  (Muon: the ungated ``gelu_mlp``, MQA, LayerNorm) and pixtral-12b
  (AdamW, on text tokens as the reference's trainer feeds it);
* musicgen-large's train step on frames (``make_train_iterator(
  frontend="embeddings")``, the reference's own stand-in) and
  pixtral-12b's train step with patch embeddings in front of the tokens
  (labels over the whole sequence), each through ``make_train_step``
  against the reference's on the same batches, 3 steps, the same bound;
* what the trainer refuses: musicgen-large before any weight is drawn
  (the reference's trainer feeds it tokens and fails), and
  ``--compress-grads`` over a data axis of a config that splits its
  weights over 'data' (``fsdp_params``), naming ROADMAP A11g.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jcfg
from repro.data import DataConfig as JData
from repro.data import make_train_iterator as j_iter
from repro.launch.steps import make_optimizer as j_make_opt
from repro.launch.steps import make_train_step as j_make_step
from repro.models.model import init_params
from repro_torch.configs import get_smoke_config as tcfg
from repro_torch.data import DataConfig as TData
from repro_torch.data import make_train_iterator as t_iter
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models.model import from_jax_params
from test_torch_hygiene import limit_torch_threads  # noqa: F401

STEPS = 3
LOSS_RTOL = 2e-3
#: each token family's optimizer in its follow-the-reference run
FOLLOW = {"gemma2-9b": "muon-syrk", "gemma3-12b": "adamw",
          "granite-20b": "muon", "pixtral-12b": "adamw"}


def _args(**kw):
    args = ttrain.build_argparser().parse_args([])
    for k, v in dict(device="cpu", steps=STEPS, global_batch=4, seq_len=32,
                     loss_chunk=16, log_every=1).items():
        setattr(args, k, v)
    for k, v in kw.items():
        setattr(args, k, v)
    return args


@functools.lru_cache(maxsize=None)
def _reference(arch, seed=0):
    """The reference's smoke config and init (jitted: bit-equal to the
    eager init, in a third of its time): (config, params, numpy)."""
    cj = jcfg(arch)
    params = jax.jit(functools.partial(init_params, cj))(jax.random.key(seed))
    return cj, params, jax.tree.map(np.asarray, params)


def _reference_losses(cj, params, optimizer, batches, loss_chunk):
    """The reference's jitted train step over ``batches``: its losses."""
    opt = j_make_opt(cj, optimizer, lr=3e-4)
    step = jax.jit(j_make_step(cj, opt, loss_chunk=loss_chunk))
    state = opt.init(params)
    losses = []
    for batch in batches:
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
    return losses


def _port_losses(ct, np_tree, optimizer, batches, loss_chunk):
    """The port's ``make_train_step`` from the same init over the same
    batches (numpy in, torch on the CPU): its losses."""
    model = from_jax_params(np_tree, ct, device="cpu")
    opt = tsteps.make_optimizer(ct, optimizer, lr=3e-4)
    step = tsteps.make_train_step(model, opt, loss_chunk=loss_chunk)
    state = tsteps.init_opt_state(model, opt)
    losses = []
    for batch in batches:
        state, metrics = step(state, {
            k: torch.from_numpy(np.asarray(v)).long()
            if np.asarray(v).dtype.kind == "i"
            else torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
        losses.append(float(metrics["loss"]))
    return losses


@pytest.mark.parametrize("arch", list(FOLLOW))
def test_train_cli_follows_reference_losses(monkeypatch, arch):
    """``train --arch <arch> --device cpu`` from the reference's init
    follows the reference's train step on the same data."""
    optimizer = FOLLOW[arch]
    args = _args(arch=arch, optimizer=optimizer)
    cj, params, np_tree = _reference(arch, args.seed)
    assert dataclasses.asdict(ttrain.build_config(args)) == \
        dataclasses.asdict(tcfg(arch))
    monkeypatch.setattr(ttrain, "init_model", lambda cfg, seed, device:
                        from_jax_params(np_tree, cfg, device=device))
    out = ttrain.train(args)
    it = j_iter(JData(seq_len=args.seq_len, global_batch=args.global_batch,
                      vocab_size=cj.vocab, seed=args.data_seed))
    try:
        batches = [next(it) for _ in range(STEPS)]
    finally:
        it.close()
    want = _reference_losses(cj, params, optimizer, batches,
                             args.loss_chunk)
    assert out["arch"] == tcfg(arch).name and out["steps"] == STEPS
    assert all(np.isfinite(out["losses"]))
    np.testing.assert_allclose(out["losses"], want, rtol=LOSS_RTOL)
    assert out["losses"][-1] < out["losses"][0]
    assert out["params"] == sum(int(np.prod(x.shape))
                                for x in jax.tree.leaves(params))
    assert set(out["kernel_launches"].values()) == {0}   # the CPU


def test_musicgen_train_step_on_frames_follows_reference():
    """musicgen-large's step on the frames stand-in: the port's iterator
    gives the reference's frames bit for bit, and 3 AdamW steps follow
    the reference's."""
    arch = "musicgen-large"
    cj, params, np_tree = _reference(arch)
    ct = tcfg(arch)
    kw = dict(seq_len=32, global_batch=4, vocab_size=ct.vocab, seed=3)
    ji = j_iter(JData(**kw), frontend="embeddings", d_model=cj.d_model)
    ti = t_iter(TData(**kw), frontend="embeddings", d_model=ct.d_model,
                device="cpu")
    try:
        batches = [next(ji) for _ in range(STEPS)]
        mine = [next(ti) for _ in range(STEPS)]
    finally:
        ji.close()
        ti.close()
    for a, b in zip(batches, mine):
        assert sorted(a) == sorted(b) == ["embeds", "labels"]
        assert np.array_equal(a["embeds"], b["embeds"].numpy())
        assert np.array_equal(a["labels"], b["labels"].numpy())
    want = _reference_losses(cj, params, "adamw", batches, 16)
    got = _port_losses(ct, np_tree, "adamw", batches, 16)
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_pixtral_train_step_with_patch_embeds_follows_reference():
    """pixtral-12b's step with (B, 16, d) patch embeddings before 32 text
    tokens, labels over all 48 positions (the first 16 ignored), 3 Muon
    steps against the reference's on the same batches."""
    arch = "pixtral-12b"
    cj, params, np_tree = _reference(arch)
    ct = tcfg(arch)
    rng = np.random.default_rng(5)
    b, s, p = 4, 32, ct.n_frontend_tokens
    batches = []
    for _ in range(STEPS):
        labels = rng.integers(0, ct.vocab, (b, p + s)).astype(np.int32)
        labels[:, :p] = -1
        batches.append({
            "tokens": rng.integers(0, ct.vocab, (b, s)).astype(np.int32),
            "patch_embeds": (rng.standard_normal((b, p, ct.d_model))
                             * 0.02).astype(np.float32),
            "labels": labels})
    want = _reference_losses(cj, params, "muon", batches, 16)
    got = _port_losses(ct, np_tree, "muon", batches, 16)
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("devices", [1, 4])
def test_train_musicgen_refuses_before_drawing_weights(monkeypatch,
                                                       devices):
    """The trainer feeds tokens, as the reference's (whose trainer fails
    on musicgen with KeyError: 'embeds'): it refuses before any weight
    is drawn, on one device and on a mesh."""
    def no_init(*a, **kw):
        raise AssertionError("weights drawn before the refusal")
    monkeypatch.setattr(ttrain, "init_model", no_init)
    with pytest.raises(NotImplementedError, match="KeyError: 'embeds'"):
        ttrain.train(ttrain.build_argparser().parse_args(
            ["--arch", "musicgen-large", "--device", "cpu", "--steps", "1",
             "--devices", str(devices)]))


@pytest.mark.parametrize("arch,max_model", [
    ("gemma2-9b", 2), ("gemma3-12b", 2), ("granite-20b", 1),
    ("pixtral-12b", 2)])
def test_compress_grads_over_fsdp_data_refuses(monkeypatch, arch,
                                               max_model):
    """``--compress-grads`` over a data axis of 2 or 4 on a published
    config that splits its weights over 'data' (``fsdp_params``) raises
    naming ROADMAP A11g before any rank starts; with the data axis at 1
    it does not refuse."""
    def no_ranks(*a, **kw):
        raise AssertionError("ranks started before the refusal")
    monkeypatch.setattr(ttrain, "run_ranks", no_ranks)
    argv = ["--arch", arch, "--full", "--device", "cpu", "--steps", "1",
            "--devices", "4", "--max-model", str(max_model),
            "--compress-grads"]
    with pytest.raises(NotImplementedError, match="ROADMAP A11g"):
        ttrain.train(ttrain.build_argparser().parse_args(argv))
    args = ttrain.build_argparser().parse_args(argv)
    args.devices = args.max_model = max_model
    if max_model > 1:
        ttrain._refuse_waiting(args, ttrain.build_config(args))
