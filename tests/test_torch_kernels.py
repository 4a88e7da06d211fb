"""repro_torch kernel modules against the Pallas kernels.

On the CPU ``syrk_tiles`` / ``syr2k_tiles`` / ``symm_tiles`` run their
kernels' plain versions (same function, same packed tile layout); the
reference runs the Pallas kernels in interpret mode.  f32 is held to
the reference kernels' own 3e-5; a bf16 output to 1e-2 relative (the two
f32 accumulations may round to neighbouring bf16 values, 2^-8 apart).
The CUDA kernels themselves are held to these plain versions on the card
by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.symm import symm_tiles as j_symm
from repro.kernels.syr2k import syr2k_tiles as j_syr2k
from repro.kernels.syrk import syrk_tiles as j_syrk
from repro_torch.core.packing import TriTiles
from repro_torch.kernels import counts, trigrid
from repro_torch.kernels.symm import symm_tiles
from repro_torch.kernels.syr2k import syr2k_tiles
from repro_torch.kernels.syrk import syrk_tiles

F32 = dict(rtol=3e-5, atol=3e-5)
BF16 = dict(rtol=1e-2, atol=1e-2)
#: (bm, n1): n1 ≤ 128, a few tiles per grid side
GRIDS = [(8, 32), (16, 64), (32, 96)]
N2, BK = 48, 16


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("bm,n1", GRIDS)
def test_syrk_tiles(bm, n1):
    a = _rand((n1, N2), bm)
    got = syrk_tiles(torch.tensor(a), bm=bm)
    _close(got, j_syrk(jnp.asarray(a), bm=bm, bk=BK, interpret=True), F32)


@pytest.mark.parametrize("bm,n1", GRIDS)
def test_syr2k_tiles(bm, n1):
    a, b = _rand((n1, N2), bm), _rand((n1, N2), bm + 1)
    got = syr2k_tiles(torch.tensor(a), torch.tensor(b), bm=bm)
    want = j_syr2k(jnp.asarray(a), jnp.asarray(b), bm=bm, bk=BK,
                   interpret=True)
    _close(got, want, F32)


EPILOGUES = [
    dict(alpha=0.5),
    dict(alpha=2.0, beta=0.5, c0=True),
    dict(beta=1.0, c0=True, out_dtype="bf16"),
    dict(out_dtype="bf16"),
]


def _split(kw, bm, n1, seed):
    """The same epilogue arguments for both packages."""
    T = (n1 // bm) * (n1 // bm + 1) // 2
    c0 = _rand((T, bm, bm), seed) if kw.get("c0") else None
    bf = kw.get("out_dtype") == "bf16"
    common = {k: kw[k] for k in ("alpha", "beta") if k in kw}
    t_kw = dict(common, out_dtype=torch.bfloat16 if bf else torch.float32,
                c0=None if c0 is None else torch.tensor(c0))
    j_kw = dict(common, out_dtype=jnp.bfloat16 if bf else jnp.float32,
                c0=None if c0 is None else jnp.asarray(c0))
    return t_kw, j_kw, BF16 if bf else F32


@pytest.mark.parametrize("kw", EPILOGUES)
@pytest.mark.parametrize("bm,n1", GRIDS[:2])
def test_syrk_epilogue(kw, bm, n1):
    a = _rand((n1, N2), 3)
    t_kw, j_kw, tol = _split(kw, bm, n1, 4)
    got = syrk_tiles(torch.tensor(a), bm=bm, **t_kw)
    want = j_syrk(jnp.asarray(a), bm=bm, bk=BK, interpret=True, **j_kw)
    assert got.dtype == t_kw["out_dtype"]
    _close(got, want, tol)


@pytest.mark.parametrize("diag_scale", [0.5, 2.0])
@pytest.mark.parametrize("kw", EPILOGUES[1:3])
def test_syr2k_epilogue_diag_scale(diag_scale, kw):
    bm, n1 = GRIDS[1]
    a, b = _rand((n1, N2), 5), _rand((n1, N2), 6)
    t_kw, j_kw, tol = _split(kw, bm, n1, 7)
    got = syr2k_tiles(torch.tensor(a), torch.tensor(b), bm=bm,
                      diag_scale=diag_scale, **t_kw)
    want = j_syr2k(jnp.asarray(a), jnp.asarray(b), bm=bm, bk=BK,
                   interpret=True, diag_scale=diag_scale, **j_kw)
    _close(got, want, tol)


@pytest.mark.parametrize("bm,n1", GRIDS)
@pytest.mark.parametrize("diag_scale", [1.0, 2.0])
def test_symm_tiles(bm, n1, diag_scale):
    a = _rand((n1, n1), bm)
    b = _rand((n1, 32), bm + 2)
    tiles = TriTiles.from_tril(torch.tensor(a), bm).tiles
    got = symm_tiles(tiles, torch.tensor(b), bm=bm, diag_scale=diag_scale)
    want = j_symm(jnp.asarray(tiles.numpy()), jnp.asarray(b), bm=bm, bn=16,
                  interpret=True, diag_scale=diag_scale)
    _close(got, want, F32)


def test_symm_tiles_bf16_out():
    bm, n1 = GRIDS[1]
    a, b = _rand((n1, n1), 1), _rand((n1, 32), 2)
    tiles = TriTiles.from_tril(torch.tensor(a), bm).tiles
    got = symm_tiles(tiles, torch.tensor(b), bm=bm, out_dtype=torch.bfloat16)
    want = j_symm(jnp.asarray(tiles.numpy()), jnp.asarray(b), bm=bm, bn=16,
                  interpret=True, out_dtype=jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16)


@pytest.mark.parametrize("bm", [8, 16])
def test_symm_reads_only_tril(bm):
    """Poison the upper halves of the diagonal tiles (and the whole
    strict upper triangle of the dense source): the result is unchanged
    and finite."""
    n1 = 4 * bm
    a = _rand((n1, n1), 9)
    b = _rand((n1, 16), 10)
    clean = TriTiles.from_tril(torch.tensor(a), bm).tiles
    poisoned = clean.clone()
    slots = torch.arange(4) * (torch.arange(4) + 3) // 2
    upper = torch.triu(torch.ones(bm, bm, dtype=torch.bool), 1)
    poisoned[slots] = torch.where(upper, float("nan"), poisoned[slots])
    got = symm_tiles(poisoned, torch.tensor(b), bm=bm)
    assert torch.isfinite(got).all()
    want = j_symm(jnp.asarray(clean.numpy()), jnp.asarray(b), bm=bm, bn=16,
                  interpret=True)
    _close(got, want, F32)


def test_lookup_tables_match_reference():
    from repro.kernels import trigrid as jt
    for nt in (1, 4, 7):
        for a, b in zip(trigrid.tri_coords(nt), jt.tri_coords(nt)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(trigrid.symm_lookup(nt), jt.symm_lookup(nt)):
            np.testing.assert_array_equal(a, b)


def test_wrappers_check_inputs():
    a = torch.zeros(32, 8)
    with pytest.raises(ValueError):
        syrk_tiles(a, bm=12)                       # 32 % 12 != 0
    with pytest.raises(TypeError):
        syrk_tiles(a.double(), bm=8)
    with pytest.raises(ValueError):
        trigrid.rank_update("syr2k", a, None, bm=8)
    with pytest.raises(ValueError):
        symm_tiles(torch.zeros(3, 8, 8), torch.zeros(32, 4), bm=8)
    with pytest.raises(RuntimeError):
        syrk_tiles(a.to("meta"), bm=8)             # no kernel, no fallback


def test_launch_counters_only_count_kernel_launches():
    """On the CPU the plain versions run and nothing is counted."""
    counts.reset_launch_counts()
    syrk_tiles(torch.ones(16, 4), bm=8)
    symm_tiles(TriTiles.from_tril(torch.ones(16, 16), 8).tiles,
               torch.ones(16, 2), bm=8)
    assert counts.launch_counts() == {"rank_update": 0, "sym_stream": 0,
                                       "slstm_scan": 0}


@pytest.mark.parametrize("op", ["syrk", "syr2k", "symm"])
def test_dense_oracles_match_reference(op):
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref as tref
    a, b = _rand((24, 24), 20), _rand((24, 24), 21)
    if op == "syrk":
        got, want = tref.syrk_ref(torch.tensor(a)), jref.syrk_ref(jnp.asarray(a))
    elif op == "syr2k":
        got = tref.syr2k_ref(torch.tensor(a), torch.tensor(b))
        want = jref.syr2k_ref(jnp.asarray(a), jnp.asarray(b))
    else:
        got = tref.symm_ref(torch.tensor(a), torch.tensor(b))
        want = jref.symm_ref(jnp.asarray(a), jnp.asarray(b))
    _close(got, want, F32)


def _kernel_ab():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "kernel_ab.py")
    spec = importlib.util.spec_from_file_location("kernel_ab", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


KERNEL_AB = _kernel_ab()


@pytest.mark.parametrize("name", sorted(KERNEL_AB.VARIANTS))
def test_kernel_ab_variants_edit_the_sources(name):
    """Every source variant ``tools/kernel_ab.py`` times finds each of its
    texts exactly once in the kernels' sources, and changes them."""
    from repro_torch.kernels import native
    edits = KERNEL_AB.VARIANTS[name]
    texts = KERNEL_AB.variant_sources(native.CSRC, edits)
    assert set(texts) == set(edits)
    for f, text in texts.items():
        assert text != (native.CSRC / f).read_text()
