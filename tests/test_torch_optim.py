"""The port's optimizers (``repro_torch.optim``: AdamW, 8-bit AdamW,
Muon in reference mode, the Gram monitor's remaining half) against the
JAX package on the same params, grads and state, in f32 params.

Tolerances: AdamW (f32) ``rtol=1e-5, atol=1e-6`` on params and moments;
8-bit AdamW the same on params, the int8 moments equal in all but a
rounding tie (at most 0.1 % of entries one step apart); Muon's NS chain
(5 quintic steps, f32) ``rtol=1e-4, atol=1e-5`` on the update and
exact on the momentum; Gram summaries ``rtol=1e-4``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamW as JAdamW
from repro.optim import Muon as JMuon
from repro.optim import orthogonalize_reference as j_orth
from repro_torch import blas
from repro_torch.optim import muon as tmuon
from repro_torch.optim.adamw import AdamW as TAdamW
from repro_torch.optim.muon import Muon as TMuon

TOL = dict(rtol=1e-5, atol=1e-6)
#: pins every blas call in its context onto the kernel route (heuristic
#: tiles), the plain kernels on a CPU tensor
ON_KERNELS = blas.Route("any", "kernel", "test pin", 0, 0)
NS_TOL = dict(rtol=1e-4, atol=1e-5)


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


PARAMS = {"w": (32, 48), "b": (48,), "stack": (3, 16, 24),
          "tall": (3, 40, 16), "norms": (2, 64), "norms8": (9, 64)}


def _trees(seed):
    p = {k: _np(s, seed + i) for i, (k, s) in enumerate(PARAMS.items())}
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v.copy()) for k, v in p.items()})


def _grads(step):
    g = {k: _np(s, 100 * step + i) for i, (k, s) in enumerate(
        PARAMS.items())}
    return ({k: jnp.asarray(v) for k, v in g.items()},
            {k: torch.from_numpy(v) for k, v in g.items()})


def _close(t_tree, j_tree, tol):
    for k in j_tree:
        np.testing.assert_allclose(t_tree[k].float().numpy(),
                                   np.asarray(j_tree[k], np.float32),
                                   err_msg=k, **tol)


def test_adamw_matches_reference():
    jp, tp = _trees(0)
    jo, to = JAdamW(lr=0.01), TAdamW(lr=0.01)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(5):
        jg, tg = _grads(step)
        jp, js = jo.update(jg, js, jp)
        tp, ts = to.update(tg, ts, tp)
        _close(tp, jp, TOL)
        _close(ts.m, js.m, TOL)
        _close(ts.v, js.v, TOL)
    assert ts.step == int(js.step) == 5


def test_adamw8bit_matches_reference():
    jp, tp = _trees(1)
    jo = JAdamW(lr=0.01, quantize_moments=True)
    to = TAdamW(lr=0.01, quantize_moments=True)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(4):
        jg, tg = _grads(step)
        jp, js = jo.update(jg, js, jp)
        tp, ts = to.update(tg, ts, tp)
        _close(tp, jp, TOL)
        for name in ("m", "v"):
            for k in PARAMS:
                q_t = getattr(ts, name)[k].numpy().astype(np.int32)
                q_j = np.asarray(getattr(js, name)[k]).astype(np.int32)
                assert q_t.shape == q_j.shape and q_t.dtype != np.float32
                off = np.abs(q_t - q_j)
                assert off.max() <= 1 and (off > 0).mean() <= 1e-3, k
        _close(ts.m_scale, js.m_scale, TOL)
        _close(ts.v_scale, js.v_scale, TOL)


def test_adamw_reduces_quadratic():
    opt = TAdamW(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([2.0, -3.0])}
    state = opt.init(params)
    for _ in range(200):
        params, state = opt.update({"w": 2 * params["w"]}, state, params)
    assert float(params["w"].abs().max()) < 0.2


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("gram", [False, True])
def test_muon_matches_reference(kernel, gram):
    """Matrices, stacks (one NS call for the stack, per-matrix norms),
    tall stacks (transposed to their short side), non-matrices (signSGD)
    and a (9, 64) stack that counts as a matrix, as the reference's
    ``_is_matrix`` says."""
    jp, tp = _trees(2)
    gd = 0.9 if gram else None
    jo = JMuon(lr=0.02, mode="reference", gram_decay=gd, weight_decay=0.01)
    to = TMuon(lr=0.02, mode="reference", gram_decay=gd, weight_decay=0.01)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(3):
        jg, tg = _grads(step)
        jp, js = jo.update(jg, js, jp)
        with blas.pinned(ON_KERNELS if kernel else None):
            tp, ts = to.update(tg, ts, tp)
        _close(tp, jp, NS_TOL)
        _close(ts.momentum, js.momentum, TOL)
        if gram:
            vec = ts.gram["w"].vec
            np.testing.assert_allclose(vec.numpy(),
                                       np.asarray(js.gram["w"].vec),
                                       rtol=1e-4, atol=1e-5)
            assert ts.gram["w"].n == js.gram["w"].n == 32
            assert ts.gram["stack"].numel() == 0
    assert tmuon._is_matrix(tp["norms8"]) and \
        not tmuon._is_matrix(tp["norms"])
    d = tmuon.load_state_dict(tmuon.state_dict(ts))
    assert d.step == 3 and d.momentum is ts.momentum


def test_orthogonalize_stack_is_per_matrix():
    """A stack goes through as one stack, each matrix with its own norm,
    equal to the reference's vmap over the same stack."""
    g = _np((4, 24, 40), 3) * np.array([1, 10, 100, 0.1],
                                       np.float32)[:, None, None]
    want = jax.vmap(lambda t: j_orth(t, steps=5))(jnp.asarray(g))
    got = tmuon.orthogonalize_reference(torch.from_numpy(g), steps=5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **NS_TOL)
    with blas.pinned(ON_KERNELS):
        got_t = tmuon.orthogonalize_reference(torch.from_numpy(
            g.transpose(0, 2, 1).copy()), steps=5)
    np.testing.assert_allclose(got_t.numpy(),
                               np.asarray(want).transpose(0, 2, 1),
                               **NS_TOL)
    sv = np.linalg.svd(got.numpy(), compute_uv=False)
    assert sv.min() > 0.5 and sv.max() < 1.3


def test_ns_gram_chunk_matches_one_shot():
    x = torch.from_numpy(_np((16, 40), 4))
    x = x / torch.linalg.norm(x)        # as orthogonalize_reference feeds it
    one = tmuon.ns_iteration_reference(x)
    with blas.pinned(ON_KERNELS):
        chunked = tmuon.ns_iteration_reference(x, gram_chunk=16)
    np.testing.assert_allclose(chunked.numpy(), one.numpy(), **NS_TOL)


def test_stacked_norms_are_matrices_at_eight_layers():
    """At n_layers >= 8 the reference's ``_is_matrix`` makes the stacked
    norm scales and biases, (n_layers, d), matrices, orthogonalized as
    one n_layers × d matrix (ROADMAP queue C, a reference behaviour):
    the port's Muon does the same on the model's tree."""
    import dataclasses
    from repro.configs import get_smoke_config as jcfg
    from repro.models.model import init_params
    from repro_torch.configs import get_smoke_config as tcfg
    from repro_torch.models.model import from_jax_params
    cj = dataclasses.replace(jcfg("stablelm-1.6b"), n_layers=8)
    ct = dataclasses.replace(tcfg("stablelm-1.6b"), n_layers=8)
    params = init_params(cj, jax.random.key(0))
    model = from_jax_params(jax.tree.map(np.asarray, params), ct,
                            device="cpu")
    tree = model.stacked(lambda p: p.detach().float())
    key = ("periods", "b0", "norm1", "scale")
    assert tuple(tree[key].shape) == (8, 64) and tmuon._is_matrix(tree[key])
    from repro.optim.muon import _is_matrix as j_is_matrix
    assert j_is_matrix(params["periods"]["b0"]["norm1"]["scale"])
    g = _np((8, 64), 5)
    jo, to = JMuon(lr=0.02), TMuon(lr=0.02)
    jleaf = jnp.asarray(np.asarray(tree[key]))
    jnew, _ = jo.update({"s": jnp.asarray(g)}, jo.init({"s": jleaf}),
                        {"s": jleaf})
    tnew, _ = to.update({"s": torch.from_numpy(g)},
                        to.init({"s": tree[key]}), {"s": tree[key]})
    np.testing.assert_allclose(tnew["s"].numpy(), np.asarray(jnew["s"]),
                               **NS_TOL)
    # a sign step would move every entry by exactly fallback_lr
    assert not np.allclose(np.abs(tnew["s"].numpy() - tree[key].numpy()),
                           3e-4)


def test_gram_monitor_rest_matches_reference():
    from repro.optim.gram import GramMonitor as JMon
    from repro.optim.gram import whitening_factor as j_wf
    from repro_torch.optim.gram import GramMonitor as TMon
    from repro_torch.optim.gram import whitening_factor as t_wf
    jm, tm = JMon(decay=0.5, chunk=24), TMon(decay=0.5, chunk=24)
    for i in range(3):
        x = _np((8, 64), 20 + i)
        jm.update("l", jnp.asarray(x))
        tm.update("l", torch.from_numpy(x))
    np.testing.assert_allclose(tm._state["l"].numpy(),
                               np.asarray(jm._state["l"]), rtol=1e-5,
                               atol=1e-6)
    js, ts = jm.summaries("l"), tm.summaries("l")
    for k in ("trace", "fro", "effective_rank"):
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-4)
    assert ts["packed_words"] == js["packed_words"] == 36
    assert tm.regime("l", 64, 2) == jm.regime("l", 64, 2) == "case 1"
    sd = tm.state_dict()
    assert sd["l"].n == 8
    other = TMon()
    other.load_state_dict(sd)
    assert torch.equal(other._state["l"], tm._state["l"])
    other.load_state_dict({"raw": tm._state["l"].clone()})
    assert other._dims["raw"] == 8
    with pytest.raises(ValueError):
        other.load_state_dict({"bad": torch.zeros(7)})
    tt = tm.tritiles("l", bm=8)
    np.testing.assert_allclose(tt.to_full().numpy(), np.asarray(
        jm.tritiles("l", bm=8).to_full()), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_wf(tm, "l", eps=1e-3).numpy(),
                               np.asarray(j_wf(jm, "l", eps=1e-3)),
                               rtol=1e-3, atol=1e-4)
