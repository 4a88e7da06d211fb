"""The tables that map the kernels' output blocks onto packed tiles.

The CUDA kernels' blocks are sized for the card, not by the packed
format bm, so each reads a table built in ``kernels/trigrid.py``.  These
tests replay, in numpy, the addressing the kernels apply to those
tables (the epilogue of ``csrc/rank_update.cu``, the staging and
fragment selects of ``csrc/sym_stream.cu``) and hold it to the packed
layout and to ``symm_lookup``, for every bm the kernels take.  The last
test holds ``blas.symm`` with narrow B (no column padding) to the JAX
reference.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import blas as jb
from repro_torch import blas as tb
from repro_torch.core.packing import pack_tril_tiles
from repro_torch.kernels import trigrid

BMS = trigrid.KERNEL_BMS
NTS = (1, 2, 3, 5)


def _rank_dest(nt: int, bm: int):
    """Every store of ``rank_update``'s epilogue, per (block, element):
    the flat index into the packed (T, bm, bm) output of the computed
    value (``dest``) and of the mirror's zero (``mirror``), -1 where
    none."""
    bo = trigrid.RANK_BLOCK
    blocks = trigrid.rank_blocks(nt, bm)
    n1 = nt * bm
    lr = np.arange(bo)[None, :, None]
    lc = np.arange(bo)[None, None, :]
    r = blocks[:, 0, None, None] + lr
    c = blocks[:, 1, None, None] + lc
    ti, tj = r // bm, c // bm
    keep = (r < n1) & (c < n1) & (ti >= tj)
    t = ti * (ti + 1) // 2 + tj
    dest = (t * bm + r % bm) * bm + c % bm
    off_diag = (blocks[:, 0] != blocks[:, 1])[:, None, None]
    mirrored = keep & (ti == tj) & off_diag
    mirror = (t * bm + c % bm) * bm + r % bm
    return (blocks, np.where(keep, dest, -1), np.where(mirrored, mirror, -1),
            r, c)


@pytest.mark.parametrize("nt", NTS)
@pytest.mark.parametrize("bm", BMS)
def test_rank_blocks_write_each_packed_element_once(bm, nt):
    blocks, dest, mirror, r, c = _rank_dest(nt, bm)
    T = nt * (nt + 1) // 2
    stores = np.concatenate([dest[dest >= 0], mirror[mirror >= 0]])
    counts = np.bincount(stores, minlength=T * bm * bm)
    assert counts.shape == (T * bm * bm,)
    assert (counts == 1).all()
    bo = trigrid.RANK_BLOCK
    I, J = blocks[:, 0] // bo, blocks[:, 1] // bo
    # every block lies on or below the block diagonal ...
    assert (I >= J).all()
    # ... and the mirrors' zeros land in a diagonal tile's strict upper
    # half, which only a 64-block inside a 128-tile leaves to them
    mr, mc = mirror // bm % bm, mirror % bm
    assert (mr < mc)[mirror >= 0].all()
    assert (mirror >= 0).any() == (bo < bm)


def test_rank_block_counts_at_the_serving_shapes():
    """64 × 64 blocks: 528 at d = 2048 (one block per packed tile gave
    136), 136 at d = 1024 (was 36)."""
    for nt, blocks in ((16, 528), (8, 136)):
        assert trigrid.rank_blocks(nt, 128).shape == (blocks, 2)
    assert trigrid.rank_blocks(16, 128) is trigrid.rank_blocks(16, 128)
    assert not trigrid.rank_blocks(16, 128).flags.writeable


def _symm_effective(tiles: np.ndarray, nt: int, bm: int, rows: int,
                    diag_scale: float) -> np.ndarray:
    """The (n1, n1) operand ``sym_stream``'s tensor-core kernel
    multiplies: every panel element (R, k) of every ``rows``-row block
    and 32-deep panel, staged from the sub-tile table and selected by
    mode as the kernel does (AN as stored, AT transposed)."""
    pk = trigrid.PANEL_K
    codes = trigrid.symm_subtiles(nt, bm, rows)
    nb, npan = codes.shape[:2]
    h, w = min(bm, rows), min(bm, pk)
    R = np.arange(rows)[:, None]
    k = np.arange(pk)[None, :]
    n1 = nt * bm
    eff = np.zeros((nb * rows, npan * pk), np.float32)
    for i in range(nb):
        for p in range(npan):
            code = codes[i, p][R // h, k // w]
            mode, flat = code & 3, code >> 2
            rg, kg = i * rows + R, p * pk + k
            an = np.where(mode == 3, 0.0,
                          tiles[flat, rg % bm, kg % bm])
            at = tiles[flat, kg % bm, rg % bm]
            lower = (mode == 0) | (mode == 3) | ((mode == 2) & (rg >= kg))
            v = np.where(lower, an, at)
            v = np.where((mode == 2) & (rg == kg), diag_scale * v, v)
            assert ((mode == 3) == ((rg >= n1) | (kg >= n1))).all()
            eff[i * rows:(i + 1) * rows, p * pk:(p + 1) * pk] = v
    return eff[:n1, :n1]


ROWS = sorted({r for r, _ in trigrid.SYMM_BLOCKS})


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("nt", (1, 3, 5))
@pytest.mark.parametrize("bm", BMS)
def test_symm_subtiles_reproduce_the_lookup(bm, nt, rows):
    """In range, each sub-tile's (flat, mode) is symm_lookup's entry for
    its tile pair; past the matrix edge it is mode 3."""
    pk = trigrid.PANEL_K
    codes = trigrid.symm_subtiles(nt, bm, rows)
    flat, mode = trigrid.symm_lookup(nt)
    h, w = min(bm, rows), min(bm, pk)
    nb, npan, sr, sc = codes.shape
    assert (sr, sc) == (rows // h, pk // w)
    assert nb == -(-nt * bm // rows) and npan == -(-nt * bm // pk)
    for i in range(nb):
        for p in range(npan):
            for s in range(sr):
                for cs in range(sc):
                    ti = (i * rows + s * h) // bm
                    tk = (p * pk + cs * w) // bm
                    code = int(codes[i, p, s, cs])
                    if ti < nt and tk < nt:
                        assert code >> 2 == flat[ti * nt + tk]
                        assert code & 3 == mode[ti * nt + tk]
                    else:
                        assert code == 3


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("diag_scale", (1.0, 2.0))
@pytest.mark.parametrize("bm", BMS)
def test_symm_subtile_addressing_assembles_sym_a(bm, diag_scale, rows):
    """Staging through the table and selecting by mode gives exactly the
    plain version's sym_s(A), NaN upper halves of diagonal tiles
    included (they are selected away, never multiplied)."""
    nt = 3 if bm >= 64 else 5
    n1 = nt * bm
    rng = np.random.default_rng(bm)
    a = torch.tensor(rng.standard_normal((n1, n1)).astype(np.float32))
    tiles = pack_tril_tiles(a, bm).contiguous()
    want = trigrid._effective_tiles(tiles, nt, diag_scale)
    want = want.permute(0, 2, 1, 3).reshape(n1, n1).numpy()
    poisoned = tiles.clone().numpy()
    upper = np.triu(np.ones((bm, bm), bool), 1)
    for i in range(nt):
        d = i * (i + 3) // 2
        poisoned[d][upper] = np.nan
    got = _symm_effective(poisoned, nt, bm, rows, diag_scale)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


def test_symm_blocks_fill_the_card():
    """The first of SYMM_BLOCKS whose blocks fill a wave of 132 SMs."""
    first, last = trigrid.SYMM_BLOCKS[0], trigrid.SYMM_BLOCKS[-1]
    assert trigrid.symm_block(8192, 8192, 132) == first
    assert trigrid.symm_block(128, 8, 132) == last
    for n in (1024, 2048):
        rows, cols = trigrid.symm_block(n, n, 132)
        assert (rows, cols) in trigrid.SYMM_BLOCKS
        assert -(-n // rows) * -(-n // cols) >= 132


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("n1", (40, 256))
@pytest.mark.parametrize("n2", (1, 3, 8))
def test_symm_narrow_b_is_not_padded(n1, n2):
    """n2 <= 8: the route's column granule is 1 (B goes to the kernel as
    it is, for the matrix-vector kernel), and the kernel route agrees
    with the JAX reference."""
    a, b = _rand((n1, n1), n1 + n2), _rand((n1, n2), n2)
    route = tb.plan_route("symm", n1, n2, device=torch.device("cpu"),
                          kernel=True)
    assert route.tiles[1] == 1
    got = tb.symm(torch.tensor(a), torch.tensor(b), kernel=True)
    want = jb.symm(jnp.asarray(a), jnp.asarray(b))
    assert tuple(got.shape) == (n1, n2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5,
                               atol=3e-5)


def test_symm_wide_b_pads_to_a_multiple_of_8():
    assert tb.plan_route("symm", 2048, 2048, device=torch.device("cuda")
                         ).tiles == (128, 8)
    assert tb.plan_route("symm", 2048, 9, device=torch.device("cuda")
                         ).tiles == (128, 8)
