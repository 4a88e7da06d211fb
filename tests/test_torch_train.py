"""The port's training path against the JAX package at small sizes:
``lm_loss`` and its gradient against ``jax.value_and_grad(lm_loss)`` at
the stablelm smoke config (same weights through ``from_jax_params``),
the data iterator batch by batch, and 3 steps of
``repro_torch.launch.train`` on the CPU, whose losses follow the
reference's single-device train step (``repro.launch.steps``) from the
same init, with AdamW and with Muon, with and without
``--compress-grads``.

Tolerances (bf16 weights and activations): the loss ``rtol=2e-4``; each
gradient leaf ``max |Δ| <= 3e-2 · max |g|`` (a few bf16 ulps of its
largest entry); the training losses ``rtol=2e-3`` a step."""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import tree_flatten_with_path

from repro.configs import get_smoke_config as jcfg
from repro.data import DataConfig as JData
from repro.data import make_train_iterator as j_iter
from repro.models.model import init_params
from repro.models.model import lm_loss as j_loss
from repro_torch.configs import get_smoke_config as tcfg
from repro_torch.data import DataConfig as TData
from repro_torch.data import make_train_iterator as t_iter
from repro_torch.launch import train as ttrain
from repro_torch.models.model import from_jax_params
from repro_torch.models.model import lm_loss as t_loss


def _setup(layers=2, d_model=64, d_ff=None, seed=0):
    over = dict(n_layers=layers, d_model=d_model,
                d_ff=d_ff or jcfg("stablelm-1.6b").d_ff)
    cj = dataclasses.replace(jcfg("stablelm-1.6b"), **over)
    ct = dataclasses.replace(tcfg("stablelm-1.6b"), **over)
    params = init_params(cj, jax.random.key(seed))
    return cj, ct, params, jax.tree.map(np.asarray, params)


def _batch(vocab, b=2, s=32, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labs = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labs[0, :3] = -1                          # ignored positions
    return toks, labs


@pytest.mark.parametrize("chunk", [16, 32, 512])
def test_lm_loss_and_grad_match_reference(chunk):
    cj, ct, params, np_tree = _setup()
    toks, labs = _batch(ct.vocab)
    lj, gj = jax.value_and_grad(lambda p: j_loss(
        cj, p, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)},
        chunk=chunk))(params)
    model = from_jax_params(np_tree, ct, device="cpu")
    lt = t_loss(model, {"tokens": torch.from_numpy(toks).long(),
                        "labels": torch.from_numpy(labs).long()},
                chunk=chunk)
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), rtol=2e-4)
    flat, _ = tree_flatten_with_path(gj)
    tree = model.stacked(lambda p: p.grad)
    assert [tuple(k.key for k in path) for path, _ in flat] == list(tree)
    for (path, g), (key, got) in zip(flat, tree.items()):
        assert str(got.dtype) == f"torch.{g.dtype}", key   # bf16 / f32
        assert got.shape == g.shape, key
        want = np.asarray(g, np.float32)
        err = np.abs(got.float().numpy() - want).max()
        assert err <= 3e-2 * np.abs(want).max(), (key, err)


def test_lm_loss_remat_and_no_remat_agree():
    _, ct, _, np_tree = _setup()
    toks, labs = _batch(ct.vocab, seed=1)
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labs).long()}
    grads = []
    for remat, policy in ((True, "full"), (True, "dots"), (False, "full")):
        cfg = dataclasses.replace(ct, remat_policy=policy)
        model = from_jax_params(np_tree, cfg, device="cpu")
        t_loss(model, batch, chunk=16, remat=remat).backward()
        grads.append([p.grad.clone() for p in model.parameters()])
    for other in grads[1:]:
        for a, b in zip(grads[0], other):
            assert torch.equal(a, b)


@pytest.mark.parametrize("start", [0, 3])
def test_data_iterator_matches_reference(start):
    kw = dict(seq_len=64, global_batch=4, vocab_size=512, seed=5,
              mean_doc_len=48)
    ji = j_iter(JData(**kw), start_step=start)
    ti = t_iter(TData(**kw), start_step=start)
    try:
        for _ in range(3):
            a, b = next(ji), next(ti)
            assert sorted(a) == sorted(b) == ["labels", "tokens"]
            for k in a:
                assert a[k].dtype == b[k].dtype
                assert np.array_equal(a[k], b[k])
    finally:
        ji.close()
        ti.close()
    dev = t_iter(TData(**kw), device="cpu")
    try:
        batch = next(dev)
        assert batch["tokens"].dtype == torch.int64
        assert tuple(batch["labels"].shape) == (4, 64)
    finally:
        dev.close()


def _args(**kw):
    args = ttrain.build_argparser().parse_args([])
    for k, v in dict(device="cpu", steps=3, layers=1, d_model=64, d_ff=128,
                     global_batch=4, seq_len=32, loss_chunk=16,
                     log_every=1).items():
        setattr(args, k, v)
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def _follow_reference(monkeypatch, optimizer, compress_grads=False):
    """``train`` on the CPU from the reference's init, and the
    reference's jitted train step on the same data with the same
    optimizer (and ``ErrorFeedbackInt8`` under ``--compress-grads``):
    (the port's summary, the reference's losses, its params)."""
    from repro.distributed import ErrorFeedbackInt8
    from repro.launch.steps import make_optimizer as j_make_opt
    from repro.launch.steps import make_train_step as j_make_step
    args = _args(optimizer=optimizer, compress_grads=compress_grads)
    cfg_t = ttrain.build_config(args)
    cj, ct, params, np_tree = _setup(layers=1, d_model=64, d_ff=128,
                                     seed=args.seed)
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(ct)
    monkeypatch.setattr(ttrain, "init_model", lambda cfg, seed, device:
                        from_jax_params(np_tree, cfg, device=device))
    out = ttrain.train(args)

    opt = j_make_opt(cj, optimizer, lr=args.lr)
    comp = ErrorFeedbackInt8() if compress_grads else None
    step = jax.jit(j_make_step(cj, opt, loss_chunk=args.loss_chunk,
                               compressor=comp))
    state = opt.init(params)
    if comp is not None:
        state = (state, comp.init(params))
    it = j_iter(JData(seq_len=args.seq_len, global_batch=args.global_batch,
                      vocab_size=cj.vocab, seed=args.data_seed))
    want = []
    try:
        for _ in range(args.steps):
            params, state, metrics = step(params, state, next(it))
            want.append(float(metrics["loss"]))
    finally:
        it.close()
    return out, want, params


@pytest.mark.parametrize("optimizer", ["adamw", "muon"])
def test_train_cli_follows_reference_losses(monkeypatch, optimizer):
    """``train`` on the CPU from the reference's init follows the
    reference's train step (same data, same optimizer) step by step."""
    out, want, params = _follow_reference(monkeypatch, optimizer)
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    np.testing.assert_allclose(out["losses"], want, rtol=2e-3)
    assert out["losses"][-1] < out["losses"][0]
    for key in ("arch", "params", "steps", "final_loss", "first_loss",
                "mean_step_s", "straggler_events", "resumed", "mesh"):
        assert key in out
    assert out["params"] == sum(int(np.prod(x.shape))
                                for x in jax.tree.leaves(params))


@pytest.mark.parametrize("optimizer", ["adamw", "muon"])
def test_train_compress_grads_follows_reference_losses(monkeypatch,
                                                       optimizer):
    """``train --compress-grads`` on the CPU follows the reference's
    train step with ``compressor=ErrorFeedbackInt8()`` step by step;
    each step's compression is timed."""
    out, want, _ = _follow_reference(monkeypatch, optimizer,
                                     compress_grads=True)
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    np.testing.assert_allclose(out["losses"], want, rtol=2e-3)
    assert out["compress_grads"] and len(out["compress_s"]) == 3
    assert all(sp["compress_s"] > 0 for sp in out["split_s"])


@pytest.mark.parametrize("optimizer", ["adamw8bit", "muon-syrk"])
def test_train_cli_other_optimizers_and_gram(optimizer):
    out = ttrain.train(_args(optimizer=optimizer, steps=2, microbatches=2,
                             track_gram=True))
    assert all(np.isfinite(out["losses"])) and out["steps"] == 2
    assert out["device"] == "cpu"


def _run_capturing(monkeypatch, **kw):
    """``train`` with the smoke model kept for inspection: (summary,
    model)."""
    made = []
    init = ttrain.init_model

    def keep(cfg, seed, device):
        made.append(init(cfg, seed=seed, device=device))
        return made[-1]

    monkeypatch.setattr(ttrain, "init_model", keep)
    out = ttrain.train(_args(**kw))
    return out, made[-1]


@pytest.mark.parametrize("optimizer,track_gram", [("muon-syrk", True),
                                                  ("adamw8bit", False)])
def test_train_resume_is_bit_exact(monkeypatch, tmp_path, optimizer,
                                   track_gram):
    """Two steps, a checkpoint, then a run to step 4 on the same dir
    equal an uninterrupted 4-step run bit for bit: losses, parameters
    and optimizer state (Muon's packed Grams resume from bf16-narrowed
    words: 1e-2 relative, the reference test's bound)."""
    from repro_torch.distributed import (read_manifest,
                                         restore_checkpoint)
    from repro_torch.distributed.checkpoint import _flatten
    from repro_torch.core.packing import PackedTriangle
    kw = dict(optimizer=optimizer, track_gram=track_gram, steps=4,
              ckpt_every=2)
    full, m_full = _run_capturing(monkeypatch, ckpt_dir=str(tmp_path / "u"),
                                  **kw)
    assert not full["resumed"] and full["steps"] == 4
    first, _ = _run_capturing(monkeypatch, ckpt_dir=str(tmp_path / "r"),
                              **dict(kw, steps=2))
    assert first["losses"] == full["losses"][:2]
    out, m_res = _run_capturing(monkeypatch, ckpt_dir=str(tmp_path / "r"),
                                **kw)
    assert out["resumed"] and out["start_step"] == 2 and out["steps"] == 2
    assert out["restore_verified"]["mismatches"] == []
    assert out["losses"] == full["losses"][2:]
    assert out["ckpt_bytes"] == full["ckpt_bytes"] > 0
    for a, b in zip(m_full.parameters(), m_res.parameters()):
        assert torch.equal(a, b)
    like = {"params": m_full.stacked(),
            "opt": ttrain.make_optimizer(ttrain.build_config(_args()),
                                         optimizer, track_gram=track_gram)
            .init(m_full.stacked())}
    _, want = restore_checkpoint(str(tmp_path / "u"), like)
    _, got = restore_checkpoint(str(tmp_path / "r"), like)
    assert got["opt"].step == want["opt"].step == 4
    grams = 0
    for (k, a), (_, b) in zip(_flatten(want), _flatten(got)):
        if isinstance(a, PackedTriangle):
            grams += 1
            err = (a.vec - b.vec).abs().max() / a.vec.abs().max()
            assert err <= 1e-2, (k, err)
        elif isinstance(a, int):
            assert a == b, k
        else:
            assert torch.equal(a, b), k
    assert grams == (2 if track_gram else 0)
    crc_u = read_manifest(str(tmp_path / "u"))["leaves"]
    crc_r = read_manifest(str(tmp_path / "r"))["leaves"]
    assert sorted(crc_u) == sorted(crc_r)
    assert [k for k in crc_u if crc_u[k]["crc"] != crc_r[k]["crc"]
            and ".gram__" not in k] == []


def test_train_fresh_ignores_the_checkpoints(monkeypatch, tmp_path):
    d = str(tmp_path)
    ttrain.train(_args(steps=2, ckpt_dir=d))
    out = ttrain.train(_args(steps=2, ckpt_dir=d, fresh=True))
    assert not out["resumed"] and out["start_step"] == 0
    assert out["steps"] == 2 and out["restore_verified"] is None
    again = ttrain.train(_args(steps=3, ckpt_dir=d))
    assert again["resumed"] and again["start_step"] == 2
    assert again["steps"] == 1


def test_train_xlstm_raises_and_no_card_raises(monkeypatch):
    with pytest.raises(NotImplementedError, match="ROADMAP A9, xlstm"):
        ttrain.train(_args(arch="xlstm-350m", d_model=0, d_ff=0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.train(_args(device=None))


def test_microbatches_match_one_batch():
    """Two microbatches accumulate f32 gradients to the one-batch step's
    (the mean of the halves' losses is the whole batch's loss)."""
    from repro_torch.launch.steps import init_opt_state, make_train_step
    from repro_torch.optim.adamw import AdamW
    _, ct, _, np_tree = _setup(layers=1, d_ff=128)
    toks, _ = _batch(ct.vocab, b=4, s=16, seed=2)
    labs = np.roll(toks, -1, axis=1)
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labs).long()}
    losses = []
    for mb in (1, 2):
        model = from_jax_params(np_tree, ct, device="cpu")
        opt = AdamW()
        step = make_train_step(model, opt, microbatches=mb, loss_chunk=16)
        _, metrics = step(init_opt_state(model, opt), batch)
        losses.append(float(metrics["loss"]))
        for k in ("loss_backward_s", "clip_s", "opt_s", "grad_norm"):
            assert k in metrics
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-3)


def test_describe_blas_routing_lines():
    from repro_torch.launch.steps import describe_blas_routing
    lines = describe_blas_routing([(24, 2048, 5632), (2048,), (100352, 2048),
                                   (24, 2048)], device="cuda")
    text = "\n".join(lines)
    assert "syrk[2048x5632] -> kernel" in text
    assert "syrk[2048x100352] -> kernel" in text
    assert "syrk[24x2048] -> dense" in text and text.count("dA:") == 3
    assert "symm[2048x5632] -> kernel" in text


def test_argparser_matches_reference():
    from repro.launch.train import build_argparser as j_parser
    ours = {a.dest for a in ttrain.build_argparser()._actions}
    theirs = {a.dest for a in j_parser()._actions}
    assert theirs <= ours and ours - theirs == {"device", "devices"}
    assert isinstance(_args(), argparse.Namespace)
