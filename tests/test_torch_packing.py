"""repro_torch.core.packing against repro.core.packing: every converter
only moves data, so the port must agree bit for bit, ragged n included.
Inputs come from a numpy seed and are handed to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jp
from repro_torch.core import packing as tp

NS = (1, 5, 16, 37, 64)
BMS = (8, 16, 32)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("diag", [True, False])
def test_pack_unpack_tril(n, diag):
    x = _rand((n, n), n)
    x_poison = x + np.triu(np.full((n, n), np.nan, np.float32), 1)
    p = tp.pack_tril(torch.tensor(x_poison), diag)
    _eq(p, jp.pack_tril(jnp.asarray(x_poison), diag))
    for sym in (True, False):
        _eq(tp.unpack_tril(p, n, diag, sym),
            jp.unpack_tril(jnp.asarray(p.numpy()), n, diag, sym))


@pytest.mark.parametrize("n", [16, 64])
def test_pack_tril_batched(n):
    x = _rand((3, n, n), 1)
    _eq(tp.pack_tril(torch.tensor(x)), jp.pack_tril(jnp.asarray(x)))


@pytest.mark.parametrize("nt", [1, 3, 8])
def test_index_tables(nt):
    _eq(tp.tile_tril_coords(nt), jp.tile_tril_coords(nt))
    _eq(tp.tril_row_starts(5 * nt), jp.tril_row_starts(5 * nt))
    for a, b in zip(tp.packed_tile_indices(5 * nt, 4),
                    jp.packed_tile_indices(5 * nt, 4)):
        _eq(a, b)


@pytest.mark.parametrize("bm", BMS)
@pytest.mark.parametrize("nt", [1, 3])
def test_pack_tril_tiles_and_back(bm, nt):
    n = nt * bm
    x = _rand((n, n), bm + nt)
    t = tp.pack_tril_tiles(torch.tensor(x), bm)
    _eq(t, jp.pack_tril_tiles(jnp.asarray(x), bm))
    for sym in (True, False):
        _eq(tp.unpack_tril_tiles(t, n, bm, sym),
            jp.unpack_tril_tiles(jnp.asarray(t.numpy()), n, bm, sym))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("bm", BMS)
def test_packed_tiles_roundtrip_ragged(n, bm):
    p = _rand((n * (n + 1) // 2,), n * bm)
    t = tp.packed_to_tiles(torch.tensor(p), n, bm)
    _eq(t, jp.packed_to_tiles(jnp.asarray(p), n, bm))
    _eq(tp.tiles_to_packed(t, n),
        jp.tiles_to_packed(jnp.asarray(t.numpy()), n))
    _eq(tp.tiles_to_packed(t, n), p)


def test_packed_to_tiles_grid_override():
    n, bm = 20, 8
    p = _rand((n * (n + 1) // 2,), 3)
    _eq(tp.packed_to_tiles(torch.tensor(p), n, bm, nt=4),
        jp.packed_to_tiles(jnp.asarray(p), n, bm, nt=4))


@pytest.mark.parametrize("n", [5, 37])
@pytest.mark.parametrize("bm", BMS)
def test_tritiles_converters(n, bm):
    x = _rand((n, n), n + bm)
    x_poison = x + np.triu(np.full((n, n), np.nan, np.float32), 1)
    t = tp.TriTiles.from_tril(torch.tensor(x_poison), bm)
    r = jp.TriTiles.from_tril(jnp.asarray(x_poison), bm)
    assert (t.n, t.bm, t.nt, t.num_tiles) == (r.n, r.bm, r.nt, r.num_tiles)
    _eq(t.tiles, r.tiles)
    _eq(t.to_packed(), r.to_packed())
    _eq(t.to_tril(), r.to_tril())
    _eq(t.to_full(), r.to_full())
    p = t.to_packed()
    _eq(tp.TriTiles.from_packed(p, n, bm).tiles,
        jp.TriTiles.from_packed(jnp.asarray(p.numpy()), n, bm).tiles)


def test_packed_triangle():
    n = 9
    x = _rand((n, n), 4)
    pt = tp.PackedTriangle.from_dense(torch.tensor(x))
    pr = jp.PackedTriangle.from_dense(jnp.asarray(x))
    _eq(pt.vec, pr.vec)
    _eq(pt.to_dense(), pr.to_dense())
    _eq(pt.to_tritiles(8).tiles, pr.to_tritiles(8).tiles)
    assert pt.to(torch.bfloat16).dtype == torch.bfloat16
    with pytest.raises(ValueError):
        tp.PackedTriangle(torch.zeros(7), 3)
    with pytest.raises(ValueError):
        tp.TriTiles(torch.zeros(2, 8, 8), 16, 8)


def test_pad2d():
    x = _rand((5, 7), 0)
    _eq(tp.pad2d(torch.tensor(x), 4, 8), jp.pad2d(jnp.asarray(x), 4, 8))
