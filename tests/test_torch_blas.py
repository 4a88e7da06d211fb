"""repro_torch.blas against repro.blas on both routes.

The dense route is the default on the CPU; ``tile=`` forces the kernel
route in both packages (Pallas in interpret mode in the reference, the
kernels' plain versions in the port).  f32 tolerance 3e-5 as in the
reference's kernel tests; a bf16 output 1e-2 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import blas as jb
from repro.core.packing import PackedTriangle as JPacked
from repro.core.packing import TriTiles as JTiles
from repro_torch import blas as tb
from repro_torch.core.packing import PackedTriangle, TriTiles
from test_torch_hygiene import limit_torch_threads  # noqa: F401

F32 = dict(rtol=3e-5, atol=3e-5)
FILLS = ("tril", "full", "packed")
#: dense route, and the kernel route forced with tile=(bm, bk)
ROUTES = [None, (16, 16)]
N1, N2 = 40, 24          # ragged against the 16-tile grid


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32), **(tol or F32))


@pytest.mark.parametrize("tile", ROUTES)
@pytest.mark.parametrize("fill", FILLS)
def test_syrk(fill, tile):
    a = _rand((N1, N2), 0)
    got = tb.syrk(torch.tensor(a), fill=fill, tile=tile)
    _close(got, jb.syrk(jnp.asarray(a), fill=fill, tile=tile))


@pytest.mark.parametrize("tile", ROUTES)
@pytest.mark.parametrize("fill", FILLS)
def test_syr2k(fill, tile):
    a, b = _rand((N1, N2), 1), _rand((N1, N2), 2)
    got = tb.syr2k(torch.tensor(a), torch.tensor(b), fill=fill, tile=tile)
    _close(got, jb.syr2k(jnp.asarray(a), jnp.asarray(b), fill=fill,
                         tile=tile))


def _c(fill, seed):
    c = _rand((N1, N1), seed)
    if fill == "packed":
        return c[np.tril_indices(N1)]
    return c


@pytest.mark.parametrize("tile", ROUTES)
@pytest.mark.parametrize("fill", FILLS)
def test_syrk_accumulate(fill, tile):
    a, c = _rand((N1, N2), 3), _c(fill, 4)
    got = tb.syrk(torch.tensor(a), fill=fill, tile=tile,
                  c=torch.tensor(c), alpha=0.5, beta=2.0)
    want = jb.syrk(jnp.asarray(a), fill=fill, tile=tile, c=jnp.asarray(c),
                   alpha=0.5, beta=2.0)
    _close(got, want)


@pytest.mark.parametrize("tile", ROUTES)
@pytest.mark.parametrize("fill", FILLS)
def test_syr2k_accumulate(fill, tile):
    a, b, c = _rand((N1, N2), 5), _rand((N1, N2), 6), _c(fill, 7)
    got = tb.syr2k(torch.tensor(a), torch.tensor(b), fill=fill, tile=tile,
                   c=torch.tensor(c), beta=0.5)
    _close(got, jb.syr2k(jnp.asarray(a), jnp.asarray(b), fill=fill,
                         tile=tile, c=jnp.asarray(c), beta=0.5))


@pytest.mark.parametrize("tile", ROUTES)
def test_out_dtype_bf16(tile):
    a = _rand((N1, N2), 8)
    got = tb.syrk(torch.tensor(a), fill="packed", tile=tile,
                  out_dtype=torch.bfloat16)
    want = jb.syrk(jnp.asarray(a), fill="packed", tile=tile,
                   out_dtype=jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    _close(got, want, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("tile", ROUTES)
@pytest.mark.parametrize("n2", [1, 7, 40])
def test_symm_dense_operand(tile, n2):
    a, b = _rand((N1, N1), 9), _rand((N1, n2), 10)
    a_poison = a + np.triu(np.full((N1, N1), 1e6, np.float32), 1)
    got = tb.symm(torch.tensor(a_poison), torch.tensor(b), tile=tile)
    _close(got, jb.symm(jnp.asarray(a), jnp.asarray(b), tile=tile))


@pytest.mark.parametrize("tile", ROUTES)
@pytest.mark.parametrize("bm", [8, 16])
def test_symm_tritiles_operand(tile, bm):
    a, b = _rand((N1, N1), 11), _rand((N1, 9), 12)
    got = tb.symm(TriTiles.from_tril(torch.tensor(a), bm), torch.tensor(b),
                  tile=tile)
    want = jb.symm(JTiles.from_tril(jnp.asarray(a), bm), jnp.asarray(b),
                   tile=tile)
    _close(got, want)


@pytest.mark.parametrize("tile", ROUTES)
def test_symm_packed_triangle_operand(tile):
    a, b = _rand((N1, N1), 13), _rand((N1, 5), 14)
    p = a[np.tril_indices(N1)]
    got = tb.symm(PackedTriangle(torch.tensor(p), N1), torch.tensor(b),
                  tile=tile)
    want = jb.symm(JPacked(jnp.asarray(p), N1), jnp.asarray(b), tile=tile)
    _close(got, want)


def test_routing():
    from repro_torch.blas.routing import KERNEL_MIN_N1
    cpu = torch.device("cpu")
    assert tb.plan_route("syrk", 4096, 64, device=cpu).path == "dense"
    r = tb.plan_route("syrk", 16, 8, device=cpu, tile=(8, 8))
    assert (r.path, r.tiles) == ("kernel", (8, 8))
    assert tb.plan_route("symm", 64, 64, device=cpu, kernel=True).tiles \
        == (64, 8)                        # B padded to a multiple of 8
    cuda = torch.device("cuda")           # planning never touches a device
    assert tb.plan_route("syrk", KERNEL_MIN_N1, 64,
                         device=cuda).path == "kernel"
    assert tb.plan_route("syrk", KERNEL_MIN_N1 - 1, 64,
                         device=cuda).path == "dense"
    r = tb.plan_route("symm", 2048, 1, device=cuda)
    assert r.tiles == (128, 1)            # n2 = 1 not padded
    with tb.capture_routes() as log:
        tb.syrk(torch.ones(8, 4), fill="packed")
    assert [x.op for x in log] == ["syrk"]


def test_batched_operands_wait():
    """Leading batch dims no longer wait (tests/test_torch_blas_batched.py
    holds them to the reference); what still raises is operands whose
    leading dims differ, or that are not matrices."""
    a = torch.arange(64, dtype=torch.float32).reshape(2, 8, 4)
    got = tb.syrk(a)
    assert torch.equal(got, torch.stack([tb.syrk(a[0]), tb.syrk(a[1])]))
    with pytest.raises(ValueError):
        tb.symm(torch.ones(2, 8, 8), torch.ones(3, 8, 4))
    with pytest.raises(ValueError):
        tb.syrk(torch.ones(8))
