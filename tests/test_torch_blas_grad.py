"""Autodiff of the port's symmetric BLAS (``repro_torch.blas.grad``)
against ``jax.grad`` of the JAX package: the single-device cases of
tests/test_blas_grad.py (every op and fill, dense and kernel routes,
batched), the pinned backward routes, ``explain(grad=True)``, the NS
iteration and ``decorrelation_penalty``, plus the packed layouts
(TriTiles / PackedTriangle operands), the accumulator's dC and
``_diag_scale``.  On the CPU the kernel route runs the kernels' plain
versions; the reference's runs Pallas in interpret mode.

Tolerance: the reference's ``rtol=1e-4, atol=3e-5``; the NS chain its
own ``rtol=2e-3, atol=2e-4``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import blas as jb
from repro_torch import blas as tb
from repro_torch.core.packing import PackedTriangle, TriTiles

TOL = dict(rtol=1e-4, atol=3e-5)


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


A, B, S = _np((48, 32), 0), _np((48, 32), 1), _np((48, 48), 2)
ROUTES = {"dense": ({}, {}),
          "kernel": (dict(tile=(16, 16)), dict(tile=(16, 16),
                                               interpret=True))}


def _tgrad(fn, *arrays):
    xs = [torch.tensor(x, requires_grad=True) for x in arrays]
    fn(*xs).backward()
    return [x.grad.numpy() for x in xs]


def _close(got, want, tol=TOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **tol)


@pytest.mark.parametrize("route", ["dense", "kernel"])
@pytest.mark.parametrize("fill", ["tril", "full", "packed"])
def test_syrk_grad(route, fill):
    kt, kj = ROUTES[route]
    want = jax.grad(lambda x: jnp.sum(jnp.sin(jb.syrk(x, fill=fill,
                                                      **kj))))(A)
    _close(_tgrad(lambda x: torch.sin(tb.syrk(x, fill=fill, **kt)).sum(),
                  A), [want])


@pytest.mark.parametrize("route", ["dense", "kernel"])
@pytest.mark.parametrize("fill", ["tril", "full", "packed"])
def test_syr2k_grad(route, fill):
    kt, kj = ROUTES[route]
    want = jax.grad(lambda x, y: jnp.sum(jnp.sin(
        jb.syr2k(x, y, fill=fill, **kj))), argnums=(0, 1))(A, B)
    _close(_tgrad(lambda x, y: torch.sin(
        tb.syr2k(x, y, fill=fill, **kt)).sum(), A, B), want)


@pytest.mark.parametrize("route", ["dense", "kernel"])
def test_symm_grad(route):
    kt, kj = ROUTES[route]
    want = jax.grad(lambda s, y: jnp.sum(jnp.cos(jb.symm(s, y, **kj))),
                    argnums=(0, 1))(S, B)
    _close(_tgrad(lambda s, y: torch.cos(tb.symm(s, y, **kt)).sum(), S, B),
           want)


@pytest.mark.parametrize("route", ["dense", "kernel"])
@pytest.mark.parametrize("fill", ["tril", "full", "packed"])
def test_accumulator_and_alpha_grads(route, fill):
    """dA with alpha, and dC₀ = beta times the fill projection of Ḡ."""
    kt, kj = ROUTES[route]
    c = np.asarray(jb.syrk(jnp.asarray(_np((48, 8), 3)), fill=fill))
    want = jax.grad(lambda x, c0: jnp.sum(jnp.sin(jb.syrk(
        x, fill=fill, c=c0, alpha=0.5, beta=2.0, **kj))),
        argnums=(0, 1))(A, c)
    _close(_tgrad(lambda x, c0: torch.sin(tb.syrk(
        x, fill=fill, c=c0, alpha=0.5, beta=2.0, **kt)).sum(), A, c), want)


@pytest.mark.parametrize("route", ["dense", "kernel"])
def test_diag_scale_grads(route):
    kt, kj = ROUTES[route]
    want = jax.grad(lambda x, y: jnp.sum(jnp.sin(jb.syr2k(
        x, y, fill="packed", _diag_scale=0.5, **kj))), argnums=(0, 1))(A, B)
    _close(_tgrad(lambda x, y: torch.sin(tb.syr2k(
        x, y, fill="packed", _diag_scale=0.5, **kt)).sum(), A, B), want)
    want = jax.grad(lambda s, y: jnp.sum(jnp.cos(jb.symm(
        s, y, _diag_scale=2.0, **kj))), argnums=(0, 1))(S, B)
    _close(_tgrad(lambda s, y: torch.cos(tb.symm(
        s, y, _diag_scale=2.0, **kt)).sum(), S, B), want)


@pytest.mark.parametrize("route", ["dense", "kernel"])
@pytest.mark.parametrize("layout", ["tritiles", "packed"])
def test_symm_packed_operand_grads(route, layout):
    """A TriTiles A gets its dA back in the tile layout, a
    PackedTriangle A in the packed vector."""
    kt, kj = ROUTES[route]
    p = S[np.tril_indices(48)]          # the packed lower triangle of S
    from repro.core.packing import PackedTriangle as JPacked

    def jloss(vec, y):
        return jnp.sum(jnp.cos(jb.symm(JPacked(vec, 48), y, **kj)))
    want = jax.grad(jloss, argnums=(0, 1))(p, B)

    def tloss(vec, y):
        a = PackedTriangle(vec, 48) if layout == "packed" else \
            TriTiles.from_packed(vec, 48, 16)
        return torch.cos(tb.symm(a, y, **kt)).sum()
    _close(_tgrad(tloss, p, B), want)


def test_symm_da_lives_in_tril_and_ignores_poisoned_upper():
    poisoned = S + np.triu(np.full((48, 48), 1e6, np.float32), 1)
    for kw in ({}, dict(kernel=True)):
        clean, = _tgrad(lambda s: torch.cos(tb.symm(s, torch.from_numpy(
            B), **kw)).sum(), S)
        dirty, = _tgrad(lambda s: torch.cos(tb.symm(s, torch.from_numpy(
            B), **kw)).sum(), poisoned)
        assert np.array_equal(np.triu(clean, 1), np.zeros((48, 48)))
        np.testing.assert_allclose(clean, dirty, **TOL)


@pytest.mark.parametrize("route", ["dense", "kernel"])
@pytest.mark.parametrize("op", ["syrk", "syr2k", "symm"])
def test_batched_grads(route, op):
    kt, kj = ROUTES[route]
    x, y = _np((3, 32, 16), 5), _np((3, 32, 16), 6)
    s = _np((3, 32, 32), 7)
    if op == "syrk":
        want = jax.grad(lambda t: jnp.sum(jnp.sin(jb.syrk(
            t, fill="full", **kj))))(x)
        got = _tgrad(lambda t: torch.sin(tb.syrk(t, fill="full",
                                                 **kt)).sum(), x)
        _close(got, [want])
    elif op == "syr2k":
        want = jax.grad(lambda t, u: jnp.sum(jnp.sin(jb.syr2k(
            t, u, fill="packed", **kj))), argnums=(0, 1))(x, y)
        _close(_tgrad(lambda t, u: torch.sin(tb.syr2k(
            t, u, fill="packed", **kt)).sum(), x, y), want)
    else:
        want = jax.grad(lambda a, u: jnp.sum(jnp.cos(jb.symm(a, u, **kj))),
                        argnums=(0, 1))(s, y)
        _close(_tgrad(lambda a, u: torch.cos(tb.symm(a, u, **kt)).sum(),
                      s, y), want)


def test_batched_grad_matches_einsum_oracle():
    x = _np((3, 32, 16), 4)
    want = jax.grad(lambda t: jnp.sum(jnp.sin(
        jnp.einsum("bij,bkj->bik", t, t))))(x)
    _close(_tgrad(lambda t: torch.sin(tb.syrk(t, fill="full",
                                              kernel=True)).sum(), x),
           [want])


# ---------------------------------------------------------------------------
# routing: the backward is a routed symmetric op, pinned to the forward
# ---------------------------------------------------------------------------
def test_backward_of_kernel_syrk_is_pinned_kernel_symm():
    with tb.capture_routes() as log:
        _tgrad(lambda x: tb.syrk(x, tile=(16, 16)).sum(), A)
    planned = [(r.op, r.path) for r in log]
    assert ("syrk", "kernel") in planned
    assert ("symm", "kernel") in planned, planned
    bwd = [r for r in log if r.op == "symm"][0]
    assert "pinned" in bwd.reason
    assert tb.current_pin() is None


def test_backward_of_dense_syrk_stays_dense():
    with tb.capture_routes() as log:
        _tgrad(lambda x: tb.syrk(x).sum(), A)
    assert [(r.op, r.path) for r in log] == [("syrk", "dense"),
                                             ("symm", "dense")]


def test_symm_backward_plans_symm_and_syr2k():
    with tb.capture_routes() as log:
        _tgrad(lambda s: tb.symm(s, torch.from_numpy(B)).sum(), S)
    ops = sorted((r.op, r.path) for r in log)
    assert ("syr2k", "dense") in ops and ("symm", "dense") in ops


def test_explain_grad_lines():
    text = tb.explain("syrk", 512, 256, grad=True, device="cpu")
    assert "dA:" in text and "symm[512x256]" in text
    text = tb.explain("symm", 64, 64, grad=True, device="cpu")
    assert "dA:" in text and "dB:" in text and "syr2k" in text
    # on a card the same shape is kernel-routed, and so is its backward
    text = tb.explain("syrk", 512, 256, grad=True, device="cuda")
    assert text.count("-> kernel") == 2 and "pinned" in text
    assert jb.explain("syrk", 512, 256, grad=True).count("symm") == 1


# ---------------------------------------------------------------------------
# integration: the optimizer chains differentiate end to end
# ---------------------------------------------------------------------------
def test_ns_iteration_differentiable_on_kernel_route():
    from repro.optim.muon import ns_iteration_reference as jns
    from repro_torch.optim.muon import ns_iteration_reference as tns
    x = _np((16, 24), 5)
    want = jax.grad(lambda t: jnp.sum(jns(t) ** 2))(x)
    with tb.pinned(tb.Route("any", "kernel", "test pin", 0, 0)):
        got = _tgrad(lambda t: torch.sum(tns(t) ** 2), x)
    _close(got, [want], dict(rtol=2e-3, atol=2e-4))


def test_decorrelation_penalty_and_grad_match_reference():
    from repro.optim.gram import decorrelation_penalty as jpen
    from repro_torch.optim.gram import decorrelation_penalty as tpen
    x = _np((12, 40), 6)
    np.testing.assert_allclose(float(tpen(torch.from_numpy(x))),
                               float(jpen(jnp.asarray(x))), **TOL)
    want = jax.grad(jpen)(x)
    _close(_tgrad(tpen, x), [want])
    _close(_tgrad(lambda t: tpen(t, kernel=True), x), [want])
