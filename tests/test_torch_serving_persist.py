"""The serving cache's save and warm start, and its degradation under
injected refresh faults, on the CPU.

``ServingGramCache.save`` / ``warm_start`` round-trip the bf16 packed
EMA bit for bit within the port, and across packages in both directions
(a cache that ``repro`` saved warm-starts ``repro_torch`` and the
reverse); the files are the reference's byte for byte.  Factors the
port computes from the reference's words are held to the reference's
within ``FACTOR_RTOL``, the bound at which ``tests/test_torch_gram.py``
(``test_whitening_ns_bf16_state_guard``) holds the port's
``whitening_from_packed`` of a bf16 state to the reference's.  The
serve CLI saves and warm-starts end to end.  The chaos tests are the
reference's (``tests/test_serve.py``), driven through
``repro_torch.distributed.faults.inject``."""
import argparse
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro.launch.serving_cache import ServingGramCache as JCache
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import faults
from repro_torch.distributed.checkpoint import read_manifest
from repro_torch.launch import serve as tserve
from repro_torch.launch.serving_cache import ServingGramCache
from repro_torch.models.model import init_model
from test_torch_hygiene import limit_torch_threads  # noqa: F401

FACTOR_RTOL = 1e-4
KEYS = [("tA", "final"), ("tB", "final"), ("tA", "mid")]
D, N = 16, 24


def _feats(i, d=D, n=N):
    return np.random.default_rng(100 + i).standard_normal((d, n)) \
        .astype(np.float32)


def _fill(cache, to_input, updates=2):
    """``updates`` rounds of features into every key of ``KEYS``."""
    for r in range(updates):
        for i, (tenant, layer) in enumerate(KEYS):
            cache.update(tenant, "arch", layer, to_input(_feats(10 * r + i)))


def _bits(state) -> np.ndarray:
    """The bf16 words of a packed state (either package) as uint16."""
    if isinstance(state, torch.Tensor):
        return state.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(state).view(np.uint16)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _port_cache():
    cache = ServingGramCache(refresh_stride=1, synchronous=True)
    _fill(cache, torch.from_numpy)
    return cache


def _ref_cache():
    cache = JCache(refresh_stride=1, synchronous=True)
    _fill(cache, jnp.asarray)
    return cache


# ---------------------------------------------------------------------------
# save -> warm_start
# ---------------------------------------------------------------------------
def test_warm_start_parity(tmp_path):
    """save -> warm_start round-trips the bf16 packed EMA bit-exactly, so
    each warm factor equals the live one; the keying comes from the
    manifest alone."""
    cache = _port_cache()
    cache.save(str(tmp_path), step=7)
    warm = ServingGramCache(refresh_stride=1, synchronous=True)
    assert warm.warm_start(str(tmp_path), device="cpu") == 3
    assert warm.stats["warm_loaded"] == 3
    assert warm.snapshot_stats()["warm_loaded"] == 3
    assert warm.stats["refreshes"] == 3 and warm.snapshot_stats()["keys"] == 3
    for tenant, layer in KEYS:
        live = cache.monitor(tenant, "arch")._state[layer]
        back = warm.monitor(tenant, "arch")._state[layer]
        assert back.dtype == torch.bfloat16
        assert np.array_equal(_bits(back), _bits(live))
        w_live = cache.factor(tenant, "arch", layer)
        w_warm = warm.factor(tenant, "arch", layer)
        assert w_warm is not None and torch.equal(w_warm, w_live)
    entries = read_manifest(str(tmp_path))["extra"]["serving_cache"]
    assert entries["decay"] == cache.decay
    assert [(e["leaf"], e["tenant"], e["layer"], e["d"])
            for e in entries["entries"]] == [
        ("g0000", "tA", "final", D), ("g0001", "tA", "mid", D),
        ("g0002", "tB", "final", D)]


def test_warm_start_without_refresh_schedules_nothing(tmp_path):
    _port_cache().save(str(tmp_path))
    warm = ServingGramCache(refresh_stride=1, synchronous=True)
    assert warm.warm_start(str(tmp_path), refresh=False, device="cpu") == 3
    st = warm.snapshot_stats()
    assert st["refreshes"] == 0 and st["factors_ready"] == 0
    assert warm.factor("tA", "arch", "final") is None


def test_reference_cache_warm_starts_the_port(tmp_path):
    """``repro`` saves, ``repro_torch`` warm-starts: the EMA words are
    bit-equal, the keying and d come from the manifest, the factors
    agree within FACTOR_RTOL, and the port's save of the restored state
    writes the reference's files byte for byte."""
    ref = _ref_cache()
    ref.save(str(tmp_path / "ref"), step=3)
    warm = ServingGramCache(refresh_stride=1, synchronous=True)
    assert warm.warm_start(str(tmp_path / "ref"), device="cpu") == 3
    assert sorted(warm._monitors) == [("tA", "arch"), ("tB", "arch")]
    for tenant, layer in KEYS:
        mon = warm.monitor(tenant, "arch")
        assert mon._dims[layer] == D
        assert np.array_equal(_bits(mon._state[layer]),
                              _bits(ref.monitor(tenant, "arch")
                                    ._state[layer]))
        w = warm.factor(tenant, "arch", layer).numpy()
        assert _rel(w, ref.factor(tenant, "arch", layer)) < FACTOR_RTOL
    warm.save(str(tmp_path / "port"), step=3)
    d_ref, d_port = (tmp_path / "ref" / "step_00000003",
                     tmp_path / "port" / "step_00000003")
    assert sorted(os.listdir(d_ref)) == sorted(os.listdir(d_port))
    for name in os.listdir(d_ref):
        assert (d_ref / name).read_bytes() == (d_port / name).read_bytes()


def test_port_cache_warm_starts_the_reference(tmp_path):
    """``repro_torch`` saves, ``repro`` warm-starts: it returns the entry
    count and its restored words are bit-equal."""
    cache = _port_cache()
    cache.save(str(tmp_path), step=0)
    ref = JCache(refresh_stride=1, synchronous=True)
    assert ref.warm_start(str(tmp_path)) == 3
    assert ref.stats["warm_loaded"] == 3
    for tenant, layer in KEYS:
        assert np.array_equal(
            _bits(ref.monitor(tenant, "arch")._state[layer]),
            _bits(cache.monitor(tenant, "arch")._state[layer]))
        assert _rel(cache.factor(tenant, "arch", layer).numpy(),
                    ref.factor(tenant, "arch", layer)) < FACTOR_RTOL


def test_warm_start_without_a_device_raises_without_a_card(monkeypatch,
                                                           tmp_path):
    _port_cache().save(str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    warm = ServingGramCache()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        warm.warm_start(str(tmp_path))
    assert warm.stats["warm_loaded"] == 0 and not warm._monitors
    warm.close()


# ---------------------------------------------------------------------------
# the serve CLI: --save-cache, then --warm-start
# ---------------------------------------------------------------------------
SERVE_ARGS = ["--arch", "stablelm-1.6b", "--device", "cpu", "--whiten",
              "cache", "--tenants", "2", "--requests", "6", "--slots", "2",
              "--s-max", "32", "--max-new", "3", "--prompt-lo", "4",
              "--prompt-hi", "20", "--refresh-stride", "2"]


def _serve(monkeypatch, argv):
    """The port's serve on ``argv``: (summary, tokens by request)."""
    made = []
    real = tserve.synthetic_requests

    def spy(*a, **k):
        made.append(real(*a, **k))
        return made[-1]
    monkeypatch.setattr(tserve, "synthetic_requests", spy)
    out = tserve.serve(tserve.build_argparser().parse_args(argv))
    return out, [tuple(r.generated) for r in made[0]]


def test_serve_save_then_warm_start(monkeypatch, tmp_path):
    ck = str(tmp_path / "ck")
    cold, cold_toks = _serve(monkeypatch, SERVE_ARGS + ["--save-cache", ck])
    warm, warm_toks = _serve(monkeypatch, SERVE_ARGS + ["--warm-start", ck])
    assert cold["completed"] == warm["completed"] == 6
    assert cold["cache"]["warm_loaded"] == 0 and cold["cache"]["keys"] == 2
    assert warm["cache"]["warm_loaded"] == 2
    assert warm_toks == cold_toks
    assert cold["save_cache_s"] > 0 and cold["warm_start_s"] is None
    assert warm["warm_start_s"] > 0 and warm["save_cache_s"] is None
    assert warm["embeddings_finite"] and warm["cache"]["failed_refreshes"] == 0
    assert [e["tenant"] for e in read_manifest(ck)["extra"][
        "serving_cache"]["entries"]] == ["tenant0", "tenant1"]
    # the reference's serve on the same flags: every key of its summary,
    # and the same keys in the cache's stats (its jit compile count has
    # no counterpart in an eager server)
    ref = jserve.serve(argparse.Namespace(
        arch="stablelm-1.6b", smoke=True, requests=2, slots=2, s_max=32,
        max_new=2, prompt_lo=4, prompt_hi=20, tenants=2, whiten="cache",
        refresh_stride=2, warm_start=ck, save_cache=None, no_eos=True,
        seed=0))
    assert ref["cache"]["warm_loaded"] == 2
    assert set(ref) - {"prefill_compiles"} <= set(warm)
    assert set(ref["cache"]) == set(warm["cache"])


# ---------------------------------------------------------------------------
# graceful degradation under refresh chaos
# ---------------------------------------------------------------------------
@pytest.fixture()
def feats():
    return torch.from_numpy(_feats(7, n=32))


def test_refresh_failure_observed_and_retried(feats):
    """A transient refresh fault heals inside with_retries (zero counted
    failures); a persistent one is counted and the last-good factor
    keeps serving; nothing raises into the admit path."""
    cache = ServingGramCache(refresh_stride=1, refresh_retries=2,
                             refresh_backoff=0.01, breaker_threshold=3)
    try:
        with faults.inject(faults.FaultSpec(site="serve:refresh",
                                            kind="error", times=1)) as inj:
            cache.update("t", "a", "l", feats)
            cache.drain()
        assert len(inj.events) == 1
        assert cache.factor("t", "a", "l") is not None
        assert cache.snapshot_stats()["failed_refreshes"] == 0   # healed
        w_good = cache.factor("t", "a", "l")
        with faults.inject(faults.FaultSpec(site="serve:refresh",
                                            kind="error", times=0)) as inj:
            cache.update("t", "a", "l", feats)
            cache.drain()
        assert len(inj.events) == 3                # 1 try + 2 retries
        st = cache.snapshot_stats()
        assert st["failed_refreshes"] == 1 and st["pending"] == 0
        assert torch.equal(cache.factor("t", "a", "l"), w_good)
    finally:
        cache.close()


def test_breaker_holds_last_good_then_half_open_recovers(feats):
    """K consecutive refresh failures open the breaker: the key is stale,
    further refreshes are skipped and the last-good factor is served
    bitwise; after the cooldown one half-open probe closes it again."""
    cache = ServingGramCache(refresh_stride=1, synchronous=True,
                             refresh_retries=0, breaker_threshold=2,
                             breaker_cooldown_s=0.2)
    cache.update("t", "a", "l", feats)
    w_good = cache.factor("t", "a", "l")
    with faults.inject(faults.FaultSpec(site="serve:refresh",
                                        kind="error", times=0)) as inj:
        for _ in range(3):                 # 2 failures open it; the 3rd
            cache.update("t", "a", "l", feats)   # is skipped
        st = cache.snapshot_stats()
        assert st["failed_refreshes"] == 2 and len(inj.events) == 2
        assert st["stale"] == ["t/a/l"]
        assert torch.equal(cache.factor("t", "a", "l"), w_good)
    time.sleep(0.25)
    cache.update("t", "a", "l", feats)     # half-open probe succeeds
    st = cache.snapshot_stats()
    assert st["stale"] == [] and st["refreshes"] == 4   # 3rd chaos skipped
    assert st["failed_refreshes"] == 2


def _generate(model, cfg, gram_cache):
    """The reference test's traffic: 4 requests of 5, 8, 11, 14 tokens
    over two tenants, 2 slots, 4 new tokens; returns the tokens."""
    srv = tserve.Server(cfg, model, slots=2, s_max=32, max_new=4,
                        eos_id=-1, whiten="cache", gram_cache=gram_cache,
                        device="cpu")
    rng = np.random.default_rng(0)
    reqs = [tserve.Request(rid=i, prompt=rng.integers(
        1, cfg.vocab, size=5 + 3 * i).astype(np.int32), tenant=f"t{i % 2}")
        for i in range(4)]
    try:
        tserve.run(srv, reqs, max_steps=40)
    finally:
        gram_cache.close()
    return [tuple(r.generated) for r in reqs], gram_cache.snapshot_stats()


def test_decode_unchanged_under_refresh_chaos():
    """Factors are per-request side outputs, never decode inputs: even
    persistent refresh failures leave the tokens bit-identical to the
    fault-free run."""
    cfg = get_smoke_config("stablelm-1.6b")
    model = init_model(cfg, seed=0, device="cpu")

    def cache():
        return ServingGramCache(refresh_stride=1, refresh_retries=0,
                                breaker_threshold=2)
    base, st0 = _generate(model, cfg, cache())
    with faults.inject(faults.FaultSpec(site="serve:refresh",
                                        kind="error", times=0)):
        chaotic, st = _generate(model, cfg, cache())
    assert chaotic == base
    assert st0["failed_refreshes"] == 0
    # every refresh that was scheduled (at least one a key) failed and
    # was counted; none installed a factor
    assert st["failed_refreshes"] == st["refreshes"] >= 2
    assert st["factors_ready"] == 0


# ---------------------------------------------------------------------------
# TTL eviction of dormant tenants
# ---------------------------------------------------------------------------
def test_ttl_eviction_and_bitexact_warm_readmit(tmp_path, feats):
    """A dormant tenant is swept after max_idle_s; it re-admits cleanly
    (cold again, fresh EMA) and a warm start from its checkpoint
    restores the packed EMA bit-exactly."""
    cache = ServingGramCache(refresh_stride=1, synchronous=True,
                             max_idle_s=0.05)
    cache.update("tA", "a", "l", feats)
    ref = cache.monitor("tA", "a")._state["l"].clone()
    cache.save(str(tmp_path), step=0)
    time.sleep(0.1)
    cache.update("tB", "a", "l", feats)    # the sweep runs here
    assert cache.stats["evicted"] == 1
    assert ("tA", "a") not in cache._monitors
    assert cache.factor("tA", "a", "l") is None        # cold again
    cache.update("tA", "a", "l", feats)                # clean re-admit
    assert cache.factor("tA", "a", "l") is not None

    warm = ServingGramCache(refresh_stride=1, synchronous=True)
    assert warm.warm_start(str(tmp_path), refresh=False, device="cpu") == 1
    got = warm.monitor("tA", "a")._state["l"]
    assert np.array_equal(_bits(got), _bits(ref))
