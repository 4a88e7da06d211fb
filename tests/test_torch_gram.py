"""repro_torch.optim.gram against repro.optim.gram.

Tolerances are those of tests/test_gram.py: the packed Gram to 1e-5;
Newton–Schulz against eigh to 1e-3 (relative Frobenius) for
cond(G + εI) < 1e4 and 1e-2 out to 1e6, on the dense route and on the
kernel route (the reference's ``interpret=True``, the port's
``kernel=True``).  The port's NS and eigh against the reference's are
held to the same bounds: near cond 1e5 two f32 eigendecompositions of
one matrix already differ by ~1e-2.  One bf16 EMA step is equal to the
reference's to within one bf16 ulp.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import gram as jg
from repro_torch.optim import gram as tg


def _feats(d, n, seed):
    return np.random.default_rng(seed).standard_normal((d, n)).astype(
        np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("chunk", [None, 16])
def test_packed_gram(chunk):
    x = _feats(12, 64, 0)
    got = tg.packed_gram(torch.tensor(x), chunk=chunk)
    want = jg.packed_gram(jnp.asarray(x), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_packed_gram_kernel_route_bf16():
    x = _feats(24, 40, 1)
    got = tg.packed_gram(torch.tensor(x), out_dtype=torch.bfloat16,
                         kernel=True)
    want = jg.packed_gram(jnp.asarray(x), out_dtype=jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-2,
                               atol=1e-2)


# (d, n, eps, seed, bound): cond < 1e4 -> 1e-3; 1e4 < cond < 1e6 -> 1e-2
REGIMES = [(32, 40, 1e-3, 7, 1e-3, (0, 1e4)),
           (16, 8, 1e-5, 3, 1e-2, (1e4, 1e6))]


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("d,n,eps,seed,bound,cond_range", REGIMES)
def test_whitening_ns(d, n, eps, seed, bound, cond_range, kernel):
    x = _feats(d, n, seed)
    g_np = np.asarray(jg.packed_gram(jnp.asarray(x)))
    g = torch.tensor(g_np)
    dense = tg.unpack_tril(tg.packed_add_diag(g, d, eps), d).numpy()
    evs = np.linalg.eigvalsh(dense.astype(np.float64))
    assert cond_range[0] < evs.max() / evs.min() < cond_range[1]

    w_ns = tg.whitening_from_packed(g, d, eps=eps, method="ns",
                                    kernel=kernel)
    w_eigh = tg.whitening_from_packed(g, d, eps=eps, method="eigh")
    ref_ns = jg.whitening_from_packed(jnp.asarray(g_np), d, eps=eps,
                                      method="ns",
                                      interpret=True if kernel else None)
    ref_eigh = jg.whitening_from_packed(jnp.asarray(g_np), d, eps=eps,
                                        method="eigh")
    assert _rel(w_ns, w_eigh) < bound
    assert _rel(w_eigh, ref_eigh) < bound
    assert _rel(w_ns, ref_ns) < bound


def test_whitening_ns_bf16_state_guard():
    """bf16 storage widens the diagonal shift exactly as the reference
    does, and the factor still whitens."""
    x = _feats(8, 2048, 9)
    g = jg.packed_gram(jnp.asarray(x), out_dtype=jnp.bfloat16)
    g_t = torch.tensor(np.asarray(g, np.float32)).to(torch.bfloat16)
    w = tg.whitening_from_packed(g_t, 8)
    want = jg.whitening_from_packed(g, 8)
    assert w.dtype == torch.float32
    assert _rel(w, want) < 1e-4
    xw = w.numpy() @ x
    np.testing.assert_allclose(xw @ xw.T / 2048, np.eye(8), atol=0.2)


def test_gram_monitor_bf16_ema_step_within_one_ulp():
    x0, x1 = _feats(16, 32, 10), _feats(16, 32, 11)
    tm = tg.GramMonitor(decay=0.9, out_dtype=torch.bfloat16)
    jm = jg.GramMonitor(decay=0.9, out_dtype=jnp.bfloat16)
    for x in (x0, x1):
        tm.update("l", torch.tensor(x))
        jm.update("l", jnp.asarray(x))
    got = tm._state["l"].float().numpy()
    want = np.asarray(jm._state["l"], np.float32)
    assert tm._state["l"].dtype == torch.bfloat16
    ulp = np.spacing(np.abs(want).astype(np.float32)) * 2.0 ** 16
    assert np.all(np.abs(got - want) <= ulp), np.max(np.abs(got - want))
    assert tm._dims["l"] == 16 and tm._state["l"].shape == (136,)


def test_packed_helpers():
    p = torch.tensor(_feats(1, 21, 12)[0])
    np.testing.assert_array_equal(tg.packed_diag_slots(6),
                                  jg.packed_diag_slots(6))
    np.testing.assert_allclose(
        tg.packed_add_diag(p, 6, 0.25).numpy(),
        np.asarray(jg.packed_add_diag(jnp.asarray(p.numpy()), 6, 0.25)),
        rtol=0, atol=0)
    np.testing.assert_allclose(
        float(tg.packed_fro_norm(p, 6)),
        float(jg.packed_fro_norm(jnp.asarray(p.numpy()), 6)), rtol=1e-6)
