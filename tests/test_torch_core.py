"""The port's numpy cores (``repro_torch.core``: gf, triangle,
lower_bounds, dispatch, seq) against the JAX package's originals on the
same inputs.  Tolerance: none for every partition, counter, bound and
prediction, which are held exactly equal.  The one exception is the
``C`` of ``seq_*``: a diagonal entry is summed in whichever block its
(maximum, not unique) matching assigns it to, so it may differ in the
last bits; ``C`` is held to 1e-12 relative to its largest entry (f64)."""
import numpy as np
import pytest

from repro.core import dispatch as rdispatch
from repro.core import gf as rgf
from repro.core import lower_bounds as rlb
from repro.core import seq as rseq
from repro.core import triangle as rtri
from repro_torch.core import dispatch as tdispatch
from repro_torch.core import gf as tgf
from repro_torch.core import lower_bounds as tlb
from repro_torch.core import seq as tseq
from repro_torch.core import triangle as ttri


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


# ---------------------------------------------------------------------------
# finite fields and partitions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("q", [2, 3, 4, 5, 7, 8, 9, 16, 25, 27])
def test_gf_tables_equal(q):
    a, b = rgf.get_field(q), tgf.get_field(q)
    assert np.array_equal(a.add_table, b.add_table)
    assert np.array_equal(a.mul_table, b.mul_table)
    assert rgf.prime_power(q) == tgf.prime_power(q)


def _partition_report(p):
    """What seq.py and the partition report read: blocks, the diagonal
    counts per block (the matching itself may differ: the reference's
    visits networkx's set order), r, K, padding, Q-set sizes."""
    return (p.n, p.blocks, p.construction, p.n_real, p.r, p.num_blocks,
            sorted(len(d) for d in p.diag), max(len(d) for d in p.diag),
            sorted(x for d in p.diag for x in d),
            [len(q) for q in p.q_sets()])


@pytest.mark.parametrize("make,args", [
    ("affine_partition", (c,)) for c in (2, 3, 4, 5, 7)] + [
    ("projective_partition", (c,)) for c in (2, 3, 4, 5)] + [
    ("affine_partition", (2, 3)), ("projective_partition", (2, 3)),
    ("cyclic_partition", (5, 3)), ("cyclic_partition", (7, 4)),
    ("trivial_partition", (9,)),
    ("refined_cyclic_partition", (5, 3, 40, 1)),
    ("refined_cyclic_partition", (7, 3, 60, 2))])
def test_partitions_equal(make, args):
    a, b = getattr(rtri, make)(*args), getattr(ttri, make)(*args)
    assert _partition_report(a) == _partition_report(b)
    ttri.validate_partition(b.n, b.blocks)


def test_diagonal_assignment_is_spread_and_covers_once():
    p = ttri.projective_partition(4)
    diag = ttri.assign_diagonals(p.n, p.blocks)
    flat = sorted(x for d in diag for x in d)
    assert flat == list(range(p.n))
    assert max(len(d) for d in diag) == 1      # Hall: a perfect spread
    for k, d in enumerate(diag):
        assert all(x in p.blocks[k] for x in d)


def test_hopcroft_karp_maximum():
    # left 0..3, right 0..2: the maximum matching has 3 edges
    adj = [[0], [0, 1], [1, 2], [2]]
    match = ttri.hopcroft_karp(4, 3, adj)
    used = [m for m in match if m >= 0]
    assert len(used) == 3 and len(set(used)) == 3
    assert all(m in adj[x] for x, m in enumerate(match) if m >= 0)


@pytest.mark.parametrize("n1,M,m", [
    (n1, M, m) for n1 in (8, 15, 31, 49, 64, 100) for M in (32, 128, 1000)
    for m in (1, 2)] + [(257, 32, 1), (257, 128, 2)])
def test_optimal_partition_equal(n1, M, m):
    assert _partition_report(rtri.optimal_partition(n1, M, m)) == \
        _partition_report(ttri.optimal_partition(n1, M, m))
    assert rtri.best_r_for_memory(M, m) == ttri.best_r_for_memory(M, m)


# ---------------------------------------------------------------------------
# sequential algorithms: results and every counter
# ---------------------------------------------------------------------------
def _seq_equal(a, b):
    np.testing.assert_allclose(a.C, b.C, rtol=0,
                               atol=1e-12 * np.abs(a.C).max())
    assert (a.reads, a.writes, a.r, a.K, a.peak_resident, a.construction) \
        == (b.reads, b.writes, b.r, b.K, b.peak_resident, b.construction)


@pytest.mark.parametrize("n1,n2,M", [(16, 8, 40), (49, 30, 200),
                                     (64, 64, 300), (96, 16, 128),
                                     (15, 1, 128), (80, 40, 32),
                                     (8, 1, 512), (33, 7, 64)])
def test_seq_equal(n1, n2, M):
    A, B = _rand((n1, n2), n1), _rand((n1, n2), n2 + 7)
    S = _rand((n1, n1), 3)
    _seq_equal(rseq.seq_syrk(A, M=M), tseq.seq_syrk(A, M=M))
    _seq_equal(rseq.seq_syr2k(A, B, M=M), tseq.seq_syr2k(A, B, M=M))
    _seq_equal(rseq.seq_symm(S, B, M=M), tseq.seq_symm(S, B, M=M))


def test_seq_peak_resident_matches_reference_above_m():
    """The reference reports peak_resident 135 > M at n1=15, n2=1,
    M=128 (a red reference test); the port reproduces that counter."""
    A = _rand((15, 1), 15 * 1000 + 1)
    want = rseq.seq_syrk(A, M=128)
    got = tseq.seq_syrk(A, M=128)
    assert got.peak_resident == want.peak_resident == 135
    _seq_equal(want, got)


def test_seq_accumulate_and_partition_equal():
    A, C0 = _rand((32, 16), 0), _rand((32, 32), 1)
    _seq_equal(rseq.seq_syrk(A, C=C0, M=100), tseq.seq_syrk(A, C=C0, M=100))
    A16 = _rand((16, 8), 0)
    _seq_equal(rseq.seq_syrk(A16, M=10 ** 6,
                             partition=rtri.affine_partition(4)),
               tseq.seq_syrk(A16, M=10 ** 6,
                             partition=ttri.affine_partition(4)))


# ---------------------------------------------------------------------------
# bounds and dispatch over a grid of (n1, n2, P, M)
# ---------------------------------------------------------------------------
SHAPES = [(1024, 65536, 1), (65536, 128, 1), (4096, 4096, 1),
          (32768, 1024, 2), (16, 8, 1), (2, 2, 1), (1, 100, 2),
          (100, 1, 1), (2048, 5632, 1), (2048, 100352, 2)]
PS = [1, 2, 3, 4, 6, 7, 8, 12, 16, 20, 30, 41, 64, 97, 240, 256, 4096]


@pytest.mark.parametrize("P", PS)
def test_choose_algorithm_equal(P):
    for n1, n2, m in SHAPES:
        for M in (None, 1 << 14, 1 << 22):
            assert rdispatch.choose_algorithm(n1, n2, P, m, M).__dict__ == \
                tdispatch.choose_algorithm(n1, n2, P, m, M).__dict__
        assert rlb.memory_independent_lower_bound(n1, n2, P, m).__dict__ \
            == tlb.memory_independent_lower_bound(n1, n2, P, m).__dict__
        assert rlb.mem_independent_case(n1, n2, P, m) == \
            tlb.mem_independent_case(n1, n2, P, m)
        assert rdispatch.predicted_words_1d(n1, P) == \
            tdispatch.predicted_words_1d(n1, P)
        c = tdispatch.fit_c_grid(P)
        if c:
            assert rdispatch.predicted_words_2d(n1, n2, m, c) == \
                tdispatch.predicted_words_2d(n1, n2, m, c)
            assert rdispatch.predicted_words_3d(n1, n2, m, c, 2) == \
                tdispatch.predicted_words_3d(n1, n2, m, c, 2)
        assert rdispatch.ring_nb(max(n1, P), P) == \
            tdispatch.ring_nb(max(n1, P), P)
    assert rdispatch.largest_c_grid(P) == tdispatch.largest_c_grid(P)
    assert rdispatch.fit_c_grid(P) == tdispatch.fit_c_grid(P)


@pytest.mark.parametrize("n1,n2,M", [(1024, 64, 128), (512, 512, 4096),
                                     (96, 17, 300)])
def test_sequential_bounds_equal(n1, n2, M):
    for m in (1, 2):
        assert rlb.sequential_reads_lower_bound(n1, n2, M, m) == \
            tlb.sequential_reads_lower_bound(n1, n2, M, m)
        assert rlb.seq_algorithm_reads(n1, n2, M, m) == \
            tlb.seq_algorithm_reads(n1, n2, M, m)
        for P in (4, 16):
            assert rlb.memory_dependent_parallel_lower_bound(
                n1, n2, P, M, m) == tlb.memory_dependent_parallel_lower_bound(
                n1, n2, P, M, m)


def test_memory_budget_env_and_cpu(monkeypatch):
    monkeypatch.setenv(tdispatch.MEMORY_BUDGET_ENV, "12345")
    assert tdispatch.device_memory_budget() == 12345
    assert tdispatch.resolve_memory_budget("auto") == 12345
    monkeypatch.setenv(tdispatch.MEMORY_BUDGET_ENV, "")
    assert tdispatch.device_memory_budget() is None
    monkeypatch.delenv(tdispatch.MEMORY_BUDGET_ENV)
    assert tdispatch.device_memory_budget("cpu") is None
    assert tdispatch.resolve_memory_budget(None) is None
    assert tdispatch.resolve_memory_budget(77) == 77
    assert tdispatch._HBM_BUDGET_FRACTION == rdispatch._HBM_BUDGET_FRACTION
