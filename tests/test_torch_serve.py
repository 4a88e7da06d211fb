"""The serving slice end to end: repro_torch.launch.serve.Server against
repro.launch.serve.Server on the stablelm smoke config, the same weights
(``from_jax_params``) and the same requests, with the whitening cache on
(``ServingGramCache(refresh_stride=1, synchronous=True)``).

Tokens: the reference server's slot copy of the KV cache indexes the
stacked period axis, not the batch axis (ROADMAP queue C), so its decode
tokens are not a usable oracle; each request's tokens are instead
replayed through the reference model alone (``_oracle``: the server's
padded prefill, then one decode step per token), and the prefill token
is compared with the reference server too.  bf16 activations round
differently in the two frameworks (tests/test_torch_model.py), so a
request's tokens are compared up to its first step whose reference
top-2 logit margin is below 2·LOGIT_TOL; past that step the sequences
may legitimately part.  Embeddings are the
whitened pooled features W·p; W inverts the square root of a rank-
deficient bf16 Gram, which magnifies the features' bf16 differences, so
they are held to EMB_RTOL relative (Frobenius) per request.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.launch import serve as jserve
from repro.launch.serving_cache import ServingGramCache as JCache
from repro.models import model as jm
from repro.models.model import init_params
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as tserve
from repro_torch.launch.serving_cache import ServingGramCache
from repro_torch.models.model import from_jax_params

LOGIT_TOL = 4e-2
EMB_RTOL = 5e-2
SLOTS, S_MAX, MAX_NEW, N_REQ = 2, 32, 5, 5


def _margin(logits):
    top2 = np.sort(np.asarray(logits, np.float32), axis=-1)[..., -2:]
    return float(top2[..., 1] - top2[..., 0])


def _oracle(cfg, params, req):
    """Greedy tokens and their top-2 margins for one request from the
    reference model alone, with the server's semantics: prefill padded
    to the bucket (first token from the bucket's last position), then
    one decode step per token at positions L, L+1, ..."""
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
        margins.append(_margin(logits[0, -1]))
    return out, margins


@pytest.fixture(scope="module")
def served():
    jcfg = j_smoke("stablelm-1.6b")
    params = init_params(jcfg, jax.random.key(0))
    j_reqs = jserve.synthetic_requests(N_REQ, jcfg.vocab, seed=0, lo=4,
                                       hi=28)
    jsrv = jserve.Server(jcfg, params, slots=SLOTS, s_max=S_MAX,
                         max_new=MAX_NEW, eos_id=-1, whiten="cache",
                         gram_cache=JCache(refresh_stride=1,
                                           synchronous=True))
    queue = list(j_reqs)
    while queue or any(r is not None for r in jsrv.live):
        while queue and jsrv.free_slot() is not None:
            jsrv.admit(queue.pop(0), jsrv.free_slot())
        jsrv.step()
    oracle = {r.rid: _oracle(jcfg, params, r) for r in j_reqs}

    cfg = get_smoke_config("stablelm-1.6b")
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    t_reqs = tserve.synthetic_requests(N_REQ, cfg.vocab, seed=0, lo=4,
                                       hi=28)
    cache = ServingGramCache(refresh_stride=1, synchronous=True)
    srv = tserve.Server(cfg, model, slots=SLOTS, s_max=S_MAX,
                        max_new=MAX_NEW, eos_id=-1, whiten="cache",
                        gram_cache=cache, device="cpu")
    tserve.run(srv, t_reqs, max_steps=N_REQ * MAX_NEW)
    return j_reqs, t_reqs, oracle, cache


def test_same_requests_complete(served):
    j_reqs, t_reqs, _, _ = served
    assert [r.rid for r in t_reqs if r.done_t is not None] == \
        [r.rid for r in j_reqs if r.done_t is not None] == list(range(N_REQ))
    for jr, tr in zip(j_reqs, t_reqs):
        np.testing.assert_array_equal(jr.prompt, tr.prompt)
        assert len(tr.generated) == len(jr.generated) == MAX_NEW


def test_tokens_match_under_margin_rule(served):
    j_reqs, t_reqs, oracle, _ = served
    compared = 0
    for jr, tr in zip(j_reqs, t_reqs):
        want, margins = oracle[jr.rid]
        if margins[0] > 2 * LOGIT_TOL:       # the prefill token
            assert tr.generated[0] == jr.generated[0] == want[0], jr.rid
        for k, (wt, tt) in enumerate(zip(want, tr.generated)):
            if margins[k] <= 2 * LOGIT_TOL:
                break
            assert tt == wt, (jr.rid, k)
            compared += 1
    assert compared >= N_REQ


def test_embeddings_match(served):
    j_reqs, t_reqs, _, cache = served
    for jr, tr in zip(j_reqs, t_reqs):
        assert tr.embedding.shape == jr.embedding.shape == (64,)
        assert np.isfinite(tr.embedding).all()
        rel = np.linalg.norm(tr.embedding - jr.embedding) / \
            np.linalg.norm(jr.embedding)
        assert rel < EMB_RTOL, (jr.rid, rel)
    st = cache.snapshot_stats()
    assert st["updates"] == st["refreshes"] == N_REQ
    assert st["factors_ready"] == 1 and st["failed_refreshes"] == 0


def test_async_cache_tokens_independent_of_refresh(served):
    """Tokens never read the factor: the async cache serves the same
    tokens as the synchronous one, and drains to a factor."""
    _, t_reqs, _, _ = served
    cfg = get_smoke_config("stablelm-1.6b")
    jcfg = j_smoke("stablelm-1.6b")
    params = init_params(jcfg, jax.random.key(0))
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    reqs = tserve.synthetic_requests(N_REQ, cfg.vocab, seed=0, lo=4, hi=28)
    cache = ServingGramCache(refresh_stride=2)
    try:
        srv = tserve.Server(cfg, model, slots=SLOTS, s_max=S_MAX,
                            max_new=MAX_NEW, eos_id=-1, whiten="cache",
                            gram_cache=cache, device="cpu")
        tserve.run(srv, reqs, max_steps=N_REQ * MAX_NEW)
        cache.drain()
        assert [r.generated for r in reqs] == \
            [r.generated for r in t_reqs]
        assert cache.snapshot_stats()["factors_ready"] == 1
    finally:
        cache.close()


def test_warm_up_touches_no_state():
    cfg = get_smoke_config("stablelm-1.6b")
    jcfg = j_smoke("stablelm-1.6b")
    params = init_params(jcfg, jax.random.key(0))
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    cache = ServingGramCache(refresh_stride=1, synchronous=True)
    srv = tserve.Server(cfg, model, slots=SLOTS, s_max=S_MAX,
                        max_new=MAX_NEW, whiten="cache", gram_cache=cache,
                        device="cpu")
    assert srv.bucket_ladder() == [16, 32]
    srv.warm_up()
    assert cache.snapshot_stats()["updates"] == 0
    assert srv.live == [None] * SLOTS
    assert all(float(layer["k"].abs().sum()) == 0 for layer in srv.cache)


def test_cache_tenant_isolation_and_eviction():
    cache = ServingGramCache(refresh_stride=1, synchronous=True,
                             out_dtype=torch.float32)
    rng = np.random.default_rng(0)
    xa = torch.tensor(rng.standard_normal((8, 16)).astype(np.float32))
    xb = torch.tensor(rng.standard_normal((8, 16)).astype(np.float32))
    cache.update("a", "m", "final", xa)
    cache.update("b", "m", "final", xb)
    wa, wb = cache.factor("a", "m", "final"), cache.factor("b", "m", "final")
    assert not torch.allclose(wa, wb)
    assert cache.monitor("a", "m")._state.keys() == {"final"}
    assert cache.evict("a", "m") == 1
    assert cache.factor("a", "m", "final") is None
    assert cache.factor("b", "m", "final") is not None


def test_cache_breaker_opens_and_nonfinite_falls_back(monkeypatch):
    import repro_torch.launch.serving_cache as sc
    cache = ServingGramCache(refresh_stride=1, synchronous=True,
                             refresh_retries=0, breaker_threshold=2)
    x = torch.ones(4, 8)
    monkeypatch.setattr(sc, "whitening_from_packed",
                        lambda *a, **k: (_ for _ in ()).throw(
                            RuntimeError("boom")))
    for _ in range(3):
        cache.update("t", "m", "l", x)
    st = cache.snapshot_stats()
    assert st["failed_refreshes"] == 2 and st["stale"] == ["t/m/l"]

    calls = []

    def nan_then_eigh(p, d, method="ns", **k):
        calls.append(method)
        return torch.full((d, d), float("nan")) if method == "ns" \
            else torch.eye(d)
    monkeypatch.setattr(sc, "whitening_from_packed", nan_then_eigh)
    cache2 = ServingGramCache(refresh_stride=1, synchronous=True)
    cache2.update("t", "m", "l", x)
    assert calls == ["ns", "eigh"]
    assert cache2.stats["ns_fallbacks"] == 1
    assert torch.equal(cache2.factor("t", "m", "l"), torch.eye(4))
