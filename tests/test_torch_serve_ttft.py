"""The port's TTFT stamp and serve summary against the reference's rules.

``repro.launch.serve.Server.admit`` runs the admit's statistics
(``_embed``) before it stamps ``first_token_t``, so a request's TTFT
covers its embedding: under ``--whiten sync`` the from-scratch Gram and
eigh, under ``cache`` the Gram update and the factor SYMM.  The port
stamps in the same place (``embed_s`` stays its own phase), and its
serve summary carries the reference's ``mean_ttft_s``,
``mean_latency_s`` and ``bucket_ladder`` with the reference's
definitions.  CPU, stablelm smoke model.
"""
import types

import numpy as np
import pytest

from repro.launch import serve as jserve
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as tserve
from repro_torch.launch.serving_cache import ServingGramCache
from repro_torch.models.model import init_model
from test_torch_hygiene import limit_torch_threads  # noqa: F401

ARCH = "stablelm-1.6b"


@pytest.mark.parametrize("whiten", ["sync", "cache"])
def test_ttft_covers_the_embedding(whiten, monkeypatch):
    cfg = get_smoke_config(ARCH)
    model = init_model(cfg, seed=0, device="cpu")
    cache = ServingGramCache(refresh_stride=1, synchronous=True) \
        if whiten == "cache" else None
    srv = tserve.Server(cfg, model, slots=2, s_max=32, max_new=3,
                        eos_id=-1, whiten=whiten, gram_cache=cache,
                        device="cpu")
    spans = {}
    embed = srv._embed

    def timed(req, hidden, L):
        t0 = tserve.time.perf_counter()
        embed(req, hidden, L)
        spans[req.rid] = (t0, tserve.time.perf_counter())
    monkeypatch.setattr(srv, "_embed", timed)
    reqs = tserve.synthetic_requests(4, cfg.vocab, seed=0, lo=4, hi=28)
    t_start = tserve.time.perf_counter()
    for r in reqs:
        r.arrived = t_start
    tserve.run(srv, reqs, max_steps=20)
    assert sorted(spans) == [r.rid for r in reqs]
    for r in reqs:
        start, end = spans[r.rid]
        assert r.first_token_t >= end, r.rid     # stamped after _embed
        assert r.first_token_t - r.arrived >= end - start
        assert r.embedding is not None and np.isfinite(r.embedding).all()
    assert srv.timing["embed_s"] >= sum(e - s for s, e in spans.values())
    if cache is not None:
        cache.close()


def test_serve_summary_has_the_reference_keys():
    args = tserve.build_argparser().parse_args(
        ["--arch", ARCH, "--device", "cpu", "--requests", "3",
         "--max-new", "2", "--s-max", "64", "--whiten", "sync"])
    out = tserve.serve(args)
    assert out["completed"] == 3 and out["embeddings_finite"]
    assert out["bucket_ladder"] == jserve.Server.bucket_ladder(
        types.SimpleNamespace(s_max=64)) == [16, 32, 64]
    assert out["p50_ttft_s"] <= out["p99_ttft_s"]
    for key in ("mean_ttft_s", "mean_latency_s"):
        assert isinstance(out[key], float) and out[key] > 0
    # every request arrives at the serve's start and finishes after its
    # first token
    assert out["mean_ttft_s"] <= out["mean_latency_s"] <= out["serve_s"]
    assert out["p50_latency_s"] <= out["p99_latency_s"] <= out["serve_s"]
