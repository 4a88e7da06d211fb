"""The xlstm slice end to end on the CPU: repro_torch's xlstm-350m smoke
model (three mLSTM blocks and one sLSTM block, no MLP), loaded with the
reference's weights through ``from_jax_params``, against
repro.models.model, and the port's server against a per-request replay
through the reference model.

Tolerances are tests/test_torch_model.py's: bf16 activations round at
different places in the two frameworks, so logits are held to LOGIT_TOL
and final-norm hidden states to HIDDEN_TOL (absolute), and greedy
tokens are compared only while the reference's top-2 logit margin
exceeds 2·LOGIT_TOL (test_torch_serve.py's margin rule).

Server oracle: the reference server's slot copy indexes the stacked
period axis, not the batch axis (ROADMAP queue C), so each request is
replayed through the reference model alone, with the server's
semantics: the prompt right-padded to its bucket (the pad tokens enter
the recurrent state, as in the reference), the first token read at the
bucket's last position, then one decode step per token.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_full
from repro.configs import get_smoke_config as j_smoke
from repro.models import model as jm
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import counts
from repro_torch.launch import serve as tserve
from repro_torch.launch.serving_cache import ServingGramCache
from repro_torch.models.model import from_jax_params, init_model
from test_torch_hygiene import limit_torch_threads  # noqa: F401

LOGIT_TOL = 4e-2      # tests/test_torch_model.py; measured ≤ 1.5e-2 here
HIDDEN_TOL = 6.25e-2  # tests/test_torch_model.py; measured ≤ 3.2e-2 here
ARCH = "xlstm-350m"
SLOTS, S_MAX, MAX_NEW, N_REQ = 2, 64, 5, 5


@pytest.fixture(scope="module")
def pair():
    jcfg = j_smoke(ARCH)
    params = jm.init_params(jcfg, jax.random.key(0))
    cfg = get_smoke_config(ARCH)
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    return jcfg, params, cfg, model


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(1, vocab, (b, s)).astype(
        np.int32)


def _margin(logits):
    top2 = np.sort(np.asarray(logits, np.float32), axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


@pytest.mark.parametrize("which", ["smoke", "full"])
def test_config_matches_reference(which):
    get_t, get_j = (get_smoke_config, j_smoke) if which == "smoke" else \
        (get_config, j_full)
    cfg, jcfg = get_t(ARCH), get_j(ARCH)
    for f in ("name", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab", "norm"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert [(b.mixer, b.mlp) for b in cfg.pattern] == \
        [(b.mixer, b.mlp) for b in jcfg.pattern] == \
        [("mlstm", "none")] * 3 + [("slstm", "none")]
    if which == "full":
        assert (cfg.n_layers, cfg.d_model, cfg.vocab) == (24, 1024, 50304)


def test_blocks_and_parameters(pair):
    _, params, cfg, model = pair
    kinds = [type(b.mixer).__name__ for b in model.blocks]
    assert kinds == ["MLSTM", "MLSTM", "MLSTM", "SLSTM"]
    assert not any(hasattr(b, "mlp") or hasattr(b, "norm2")
                   for b in model.blocks)
    assert sum(p.numel() for p in model.parameters()) == \
        sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params))
    cache = model.init_cache(3, 32)
    assert cache[0]["C"].shape == (3, 2, 32, 32)
    assert torch.equal(cache[0]["m"], torch.full((3, 2), -1e30))
    assert cache[3]["c"].shape == (3, 64)
    assert float(cache[3]["n"].min()) == float(cache[3]["n"].max()) == 1.0


@pytest.mark.parametrize("s", [20, 256])
def test_prefill_logits_and_hidden(pair, s):
    """s = 20 runs the per-step mLSTM and s = 256 the chunkwise one; the
    reference's sLSTM switches to its associative-scan form at s > 8."""
    jcfg, params, _, model = pair
    toks = _tokens(2, s, jcfg.vocab, seed=s)
    jl, _, jh = jm.prefill(jcfg, params, {"tokens": jnp.asarray(toks)},
                           s_max=s, return_hidden=True)
    tl, _, th = model.prefill(torch.as_tensor(toks, dtype=torch.long), s,
                              return_hidden=True)
    assert tl.shape == jl.shape and th.shape == jh.shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)
    np.testing.assert_allclose(th.float().numpy(),
                               np.asarray(jh, np.float32), atol=HIDDEN_TOL,
                               rtol=0)


def test_four_decode_steps(pair):
    jcfg, params, _, model = pair
    toks = _tokens(2, 12, jcfg.vocab, seed=1)
    jl, jcache = jm.prefill(jcfg, params, {"tokens": jnp.asarray(toks)},
                            s_max=32)
    tl, tcache = model.prefill(torch.as_tensor(toks, dtype=torch.long), 32)
    decode = jax.jit(functools.partial(jm.decode_step, jcfg))
    nxt = np.argmax(np.asarray(jl[:, -1]), -1)[:, None].astype(np.int32)
    for k in range(4):
        pos = np.full((2, 1), 12 + k, np.int32)
        jl, jcache = decode(params, jnp.asarray(nxt), jnp.asarray(pos),
                            jcache)
        tl, tcache = model.decode_step(torch.as_tensor(nxt).long(),
                                       torch.as_tensor(pos).long(), tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=0)
        ok = _margin(jl[:, -1]) > 2 * LOGIT_TOL
        np.testing.assert_array_equal(np.argmax(tl[:, -1].numpy(), -1)[ok],
                                      np.argmax(np.asarray(jl[:, -1]),
                                                -1)[ok])
        nxt = np.argmax(np.asarray(jl[:, -1]), -1)[:, None].astype(np.int32)


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------
def _oracle(cfg, params, req):
    """Greedy tokens and their top-2 margins for one request from the
    reference model alone, at the server's padded bucket."""
    L = len(req.prompt)
    bucket = min(max(16, 1 << (L - 1).bit_length()), S_MAX)
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :L] = req.prompt
    logits, cache = jm.prefill(cfg, params, {"tokens": jnp.asarray(toks)},
                               s_max=S_MAX)
    decode = jax.jit(functools.partial(jm.decode_step, cfg))
    out, margins = [], []
    for k in range(MAX_NEW):
        if k:
            logits, cache = decode(params, jnp.asarray([[out[-1]]]),
                                   jnp.asarray([[L + k - 1]]), cache)
        out.append(int(np.argmax(np.asarray(logits[0, -1]))))
        margins.append(float(_margin(logits[0, -1])))
    return out, margins


@pytest.fixture(scope="module")
def oracle(pair):
    jcfg, params, cfg, _ = pair
    reqs = tserve.synthetic_requests(N_REQ, cfg.vocab, seed=0, lo=4, hi=40)
    return {r.rid: _oracle(jcfg, params, r) for r in reqs}


@pytest.fixture(scope="module", params=["off", "cache"])
def served(request, pair):
    _, _, cfg, model = pair
    reqs = tserve.synthetic_requests(N_REQ, cfg.vocab, seed=0, lo=4, hi=40)
    cache = ServingGramCache(refresh_stride=1, synchronous=True) \
        if request.param == "cache" else None
    srv = tserve.Server(cfg, model, slots=SLOTS, s_max=S_MAX,
                        max_new=MAX_NEW, eos_id=-1, whiten=request.param,
                        gram_cache=cache, device="cpu")
    srv.warm_up()
    warm = srv.forwards
    steps = tserve.run(srv, reqs, max_steps=N_REQ * MAX_NEW)
    return request.param, srv, reqs, warm, steps


def test_server_tokens_match_replay(served, oracle):
    whiten, srv, reqs, _, _ = served
    assert len({srv._bucket(len(r.prompt)) for r in reqs}) >= 2
    compared = 0
    for r in reqs:
        assert r.done_t is not None and len(r.generated) == MAX_NEW
        want, margins = oracle[r.rid]
        for k, (wt, tt) in enumerate(zip(want, r.generated)):
            if margins[k] <= 2 * LOGIT_TOL:
                break
            assert tt == wt, (whiten, r.rid, k)
            compared += 1
    assert compared >= N_REQ


def test_server_counts_forwards(served):
    whiten, srv, reqs, warm, steps = served
    assert warm == len(srv.bucket_ladder()) + 1
    assert srv.forwards == warm + len(reqs) + steps
    if whiten == "cache":
        assert all(np.isfinite(r.embedding).all() for r in reqs)


def test_admit_writes_only_the_slot_row(pair):
    """The slot's recurrent state is the prefill's; the other slot's
    state is untouched."""
    _, _, cfg, model = pair
    srv = tserve.Server(cfg, model, slots=2, s_max=32, max_new=2,
                        device="cpu")
    before = [{k: v.clone() for k, v in layer.items()}
              for layer in srv.cache]
    req = tserve.synthetic_requests(1, cfg.vocab, seed=3, lo=5, hi=9)[0]
    srv.admit(req, 1)
    toks = np.zeros((1, 16), np.int64)
    toks[0, :len(req.prompt)] = req.prompt
    _, fresh = model.prefill(torch.as_tensor(toks), 32)
    for layer, old, new in zip(srv.cache, before, fresh):
        for k in layer:
            assert torch.equal(layer[k][0], old[k][0])
            assert torch.equal(layer[k][1], new[k][0])


def test_cpu_serve_launches_no_kernel():
    """On the CPU every sLSTM call runs the plain version: nothing is
    counted, and the smoke serve completes."""
    args = tserve.build_argparser().parse_args(
        ["--arch", ARCH, "--device", "cpu", "--requests", "3",
         "--max-new", "3", "--whiten", "off"])
    counts.reset_launch_counts()
    out = tserve.serve(args)
    assert out["completed"] == 3
    assert out["model_forwards"] == out["warmup_forwards"] + 3 + \
        out["decode_steps"]
    assert counts.launch_counts() == {"rank_update": 0, "sym_stream": 0,
                                       "slstm_scan": 0, "slstm_scan_bwd": 0}


def test_init_model_xlstm_is_seeded():
    cfg = get_smoke_config(ARCH)
    a = init_model(cfg, seed=3, device="cpu")
    b = init_model(cfg, seed=3, device="cpu")
    assert a.blocks[3].mixer.wx.shape == (64, 256)
    assert a.blocks[3].mixer.wx.dtype == torch.bfloat16
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                  b.parameters()))
