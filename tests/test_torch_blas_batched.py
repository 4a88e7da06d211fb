"""Leading batch dims on the port's symmetric BLAS against the JAX
package: every op and fill, on the kernel route (``kernel=True``: the
kernels' plain versions here, the reference's ``interpret=True`` Pallas
path or its dense route as the oracle) and on the dense route, with
accumulators, ``_diag_scale`` and every symmetric-operand layout.  A
batched call on the kernel route reaches each kernel wrapper once.

Tolerance: the reference's f32 ``rtol=1e-4, atol=3e-5``
(tests/test_blas_grad.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import blas as jb
from repro_torch import blas as tb
from repro_torch.core.packing import PackedTriangle, TriTiles
from repro_torch.kernels import trigrid
from test_torch_hygiene import limit_torch_threads  # noqa: F401

TOL = dict(rtol=1e-4, atol=3e-5)
LEADS = [(3,), (2, 2)]


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **TOL)


def _kw(kernel):
    return dict(kernel=True) if kernel else {}


@pytest.mark.parametrize("lead", LEADS)
@pytest.mark.parametrize("fill", ["tril", "full", "packed"])
@pytest.mark.parametrize("kernel", [False, True])
def test_syrk_batched(lead, fill, kernel):
    a = _np(lead + (40, 24), 0)
    want = jb.syrk(jnp.asarray(a), fill=fill)
    _close(tb.syrk(_t(a), fill=fill, **_kw(kernel)), want)
    # accumulate: alpha·A·Aᵀ + beta·C₀ with C₀ in the fill
    c = np.asarray(jb.syrk(jnp.asarray(_np(lead + (40, 8), 1)), fill=fill))
    want = jb.syrk(jnp.asarray(a), fill=fill, c=jnp.asarray(c), alpha=0.5,
                   beta=2.0)
    _close(tb.syrk(_t(a), fill=fill, c=_t(c), alpha=0.5, beta=2.0,
                   **_kw(kernel)), want)


@pytest.mark.parametrize("lead", LEADS)
@pytest.mark.parametrize("fill", ["tril", "full", "packed"])
@pytest.mark.parametrize("kernel", [False, True])
def test_syr2k_batched(lead, fill, kernel):
    a, b = _np(lead + (40, 24), 2), _np(lead + (40, 24), 3)
    want = jb.syr2k(jnp.asarray(a), jnp.asarray(b), fill=fill,
                    _diag_scale=0.5)
    _close(tb.syr2k(_t(a), _t(b), fill=fill, _diag_scale=0.5,
                    **_kw(kernel)), want)
    c = np.asarray(jb.syrk(jnp.asarray(_np(lead + (40, 8), 4)), fill=fill))
    want = jb.syr2k(jnp.asarray(a), jnp.asarray(b), fill=fill,
                    c=jnp.asarray(c), beta=0.25)
    _close(tb.syr2k(_t(a), _t(b), fill=fill, c=_t(c), beta=0.25,
                    **_kw(kernel)), want)


@pytest.mark.parametrize("lead", LEADS)
@pytest.mark.parametrize("layout", ["dense", "tritiles", "packed"])
@pytest.mark.parametrize("kernel", [False, True])
def test_symm_batched(lead, layout, kernel):
    s, b = _np(lead + (40, 40), 5), _np(lead + (40, 24), 6)
    s_upper_garbage = s + np.triu(np.full((40, 40), 1e6, np.float32), 1)
    want = jb.symm(jnp.asarray(s), jnp.asarray(b), _diag_scale=2.0)
    if layout == "dense":
        a = _t(s_upper_garbage)
    elif layout == "tritiles":
        a = TriTiles.from_tril(_t(s), 16)
    else:
        a = PackedTriangle.from_dense(_t(np.tril(s)))
    _close(tb.symm(a, _t(b), _diag_scale=2.0, **_kw(kernel)), want)


def test_batched_reference_interpret_route():
    """The reference's own batched kernel route (Pallas interpret, vmap
    over the stack) against the port's kernel route."""
    a, b = _np((2, 32, 16), 7), _np((2, 32, 16), 8)
    s = _np((2, 32, 32), 9)
    kw = dict(tile=(16, 16), interpret=True)
    _close(tb.syrk(_t(a), fill="packed", tile=(16, 16)),
           jb.syrk(jnp.asarray(a), fill="packed", **kw))
    _close(tb.syr2k(_t(a), _t(b), fill="full", tile=(16, 16)),
           jb.syr2k(jnp.asarray(a), jnp.asarray(b), fill="full", **kw))
    _close(tb.symm(_t(s), _t(b), tile=(16, 16)),
           jb.symm(jnp.asarray(s), jnp.asarray(b), **kw))


def test_batched_bf16_out_and_input():
    a = _np((3, 40, 24), 10)
    want = jb.syrk(jnp.asarray(a).astype(jnp.bfloat16), fill="full",
                   out_dtype=jnp.bfloat16)
    got = tb.syrk(_t(a).bfloat16(), fill="full", out_dtype=torch.bfloat16,
                  kernel=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-2,
                               atol=1e-2)


def test_batched_call_is_one_wrapper_call(monkeypatch):
    """The kernel route hands the whole stack to each wrapper once (one
    launch on the card), and each matrix of the stack is what an
    unbatched call gives."""
    calls = []
    for name in ("rank_update", "sym_stream"):
        fn = getattr(trigrid, name)

        def spy(*args, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*args, **kw)
        monkeypatch.setattr(trigrid, name, spy)
    a = _t(_np((4, 64, 48), 11))
    s = tb.syrk(a, fill="full", kernel=True)
    y = tb.symm(s, a, kernel=True)
    assert calls == ["rank_update", "sym_stream"]
    for i in range(4):
        np.testing.assert_allclose(
            s[i].numpy(), tb.syrk(a[i], fill="full", kernel=True).numpy(),
            **TOL)
        np.testing.assert_allclose(
            y[i].numpy(), tb.symm(s[i], a[i], kernel=True).numpy(), **TOL)


def test_batched_plain_wrappers_match_unbatched():
    """The plain versions take the same stacks: (k, n1, n2) operands and
    (k, T, bm, bm) tiles."""
    a = _t(_np((3, 64, 40), 12))
    c0 = _t(_np((3, 10, 16, 16), 13))
    ep = trigrid.Epilogue(alpha=0.5, beta=1.0, accumulate=True,
                          diag_scale=2.0)
    got = trigrid.rank_update("syr2k", a, a.flip(0).contiguous(), bm=16,
                              epilogue=ep, c0=c0)
    assert got.shape == (3, 10, 16, 16)
    tiles = TriTiles.from_tril(_t(_np((3, 64, 64), 14)), 16).tiles
    out = trigrid.sym_stream(tiles.contiguous(), a, bm=16, diag_scale=0.5)
    for i in range(3):
        np.testing.assert_allclose(got[i].numpy(), trigrid.rank_update(
            "syr2k", a[i], a.flip(0)[i].contiguous(), bm=16, epilogue=ep,
            c0=c0[i]).numpy(), **TOL)
        np.testing.assert_allclose(out[i].numpy(), trigrid.sym_stream(
            tiles[i].contiguous(), a[i], bm=16, diag_scale=0.5).numpy(),
            **TOL)


def test_batch_shape_mismatch_raises():
    with pytest.raises(ValueError):
        tb.symm(_t(_np((2, 16, 16), 0)), _t(_np((3, 16, 8), 1)))
    with pytest.raises(ValueError):
        tb.syrk(_t(_np((2, 16, 8), 0)), c=_t(_np((3, 16, 16), 1)))
    with pytest.raises(ValueError):
        tb.syr2k(_t(_np((2, 16, 8), 0)), _t(_np((2, 16, 8), 1)),
                 c=_t(_np((2, 16, 16), 2)), _diag_scale=0.5)


def test_jax_is_cpu():
    assert jax.default_backend() == "cpu"


def test_kernels_ops_match_reference():
    """``kernels/ops.py``: the direct kernel wrappers (padding, tile
    packing, dense lower-triangular results) against the reference's in
    Pallas interpret mode, with ragged shapes."""
    from repro.kernels import ops as jops
    from repro_torch.kernels import ops as tops
    a, b = _np((40, 24), 15), _np((40, 24), 16)
    s = _np((40, 40), 17)
    kw = dict(bm=16, bk=16)
    _close(tops.syrk(_t(a), **kw),
           jops.syrk(jnp.asarray(a), interpret=True, **kw))
    _close(tops.syr2k(_t(a), _t(b), **kw),
           jops.syr2k(jnp.asarray(a), jnp.asarray(b), interpret=True, **kw))
    _close(tops.symm(_t(s), _t(b), bm=16, bn=8),
           jops.symm(jnp.asarray(s), jnp.asarray(b), bm=16, bn=8,
                     interpret=True))
    assert tops.syrk(_t(a), out_dtype=torch.bfloat16, **kw).dtype == \
        torch.bfloat16
