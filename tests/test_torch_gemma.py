"""gemma2-9b and gemma3-12b on the CPU: repro_torch's smoke models
(alternating local / global attention with softcaps, gemma2; five local
layers to a global one with rope θ 1e6, gemma3; both with post-block
norms, GeGLU and the scaled embedding) against repro on the same weights
(the reference's ``init_params`` through ``from_jax_params``) and the
same inputs, with the bounds and helpers of
tests/test_torch_dense_families.py.

The published windows (4096 and 1024) never bind at the smoke sizes, so
each model also runs with ``local_window=8`` set on both packages'
configs, through a prefill of 20 tokens and decode steps past it.  The
embed scale sqrt(d_model) is rounded to bf16 before the product in the
reference; at d_model 64 it is 8, exact, so that rounding is held at
d_model 3584 (sqrt ≈ 59.87, 59.75 in bf16), where it shows.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as jm
from repro_torch.configs import get_smoke_config
from test_torch_dense_families import (HIDDEN_TOL, LOGIT_TOL, _close, _np,
                                       _tokens, check_config, check_lm_loss,
                                       check_parameters,
                                       check_prefill_and_decode,
                                       check_server, smoke_pair)
from test_torch_hygiene import limit_torch_threads  # noqa: F401

GEMMA = ("gemma2-9b", "gemma3-12b")


def _window8(cfg):
    return tuple(dataclasses.replace(b, local_window=8 if b.local_window
                                     else 0) for b in cfg.pattern)


@pytest.fixture(scope="module")
def pairs():
    return {arch: smoke_pair(arch) for arch in GEMMA}


@pytest.fixture(scope="module")
def window8():
    return {arch: smoke_pair(arch, pattern=_window8(get_smoke_config(arch)))
            for arch in GEMMA}


@pytest.mark.parametrize("which", ["smoke", "full"])
@pytest.mark.parametrize("arch", GEMMA)
def test_config_matches_reference(arch, which):
    cfg = check_config(arch, which)
    assert cfg.post_block_norm and cfg.embed_scale and cfg.act == "gelu"
    if which == "full":
        assert (cfg.n_layers, cfg.d_model, cfg.vocab,
                cfg.pattern[0].local_window) == {
            "gemma2-9b": (42, 3584, 256000, 4096),
            "gemma3-12b": (48, 3840, 262144, 1024)}[arch]


def test_parameters_follow_the_reference_tree(pairs):
    for pair in pairs.values():
        check_parameters(pair)
        blk = pair[3].blocks[0]
        assert blk.postnorm1.scale.dtype == blk.postnorm2.scale.dtype == \
            torch.float32


@pytest.mark.parametrize("window", ["published", "8"])
@pytest.mark.parametrize("arch", GEMMA)
def test_prefill_and_decode(pairs, window8, arch, window):
    check_prefill_and_decode((pairs if window == "published"
                              else window8)[arch])


def test_the_window_binds(window8):
    """With a window of 8, the local layers' output differs from the
    global attention's on the same weights: the mask is live."""
    _, _, cfg, model = window8["gemma2-9b"]
    toks = torch.from_numpy(_tokens(1, 20, cfg.vocab, seed=9)).long()
    h8 = model.prefill(toks, 24, True)[2]
    blk = model.blocks[0]
    spec = blk.spec
    try:
        blk.spec = dataclasses.replace(spec, local_window=0)
        h0 = model.prefill(toks, 24, True)[2]
    finally:
        blk.spec = spec
    assert torch.equal(h8[:, :8], h0[:, :8])
    assert not torch.equal(h8[:, 8:], h0[:, 8:])


@pytest.mark.parametrize("arch", GEMMA)
def test_lm_loss_and_grads(window8, arch):
    check_lm_loss(window8[arch])


@pytest.mark.parametrize("arch", GEMMA)
def test_server(pairs, arch):
    check_server(pairs[arch])


def test_embed_scale_is_rounded_to_bf16_first():
    """At d_model 3584 the port's scaled embedding is the reference's
    ``_embed_input`` bit for bit, and an f32 product with the unrounded
    sqrt(3584) is not; the whole prefill follows."""
    pair = smoke_pair("gemma2-9b", d_model=3584, n_layers=2, d_ff=32,
                      vocab=64)
    jcfg, params, cfg, model = pair
    toks = _tokens(2, 12, cfg.vocab, seed=11)
    want = _np(jm._embed_input(jcfg, params, {"tokens": jnp.asarray(toks)}))
    tt = torch.from_numpy(toks).long()
    with torch.no_grad():
        got = model._embed(tt)
        unrounded = (model.embed[tt].float() * 3584 ** 0.5).to(
            torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert not np.array_equal(unrounded.float().numpy(), want)
    jl, _, jh = jax.jit(jm.prefill, static_argnums=(0, 3, 4))(
        jcfg, params, {"tokens": jnp.asarray(toks)}, 16, True)
    tl, _, th = model.prefill(tt, 16, True)
    _close(th.float(), jh, HIDDEN_TOL, "prefill hidden at d_model 3584")
    _close(tl, jl, LOGIT_TOL, "prefill logits at d_model 3584")
