"""The mesh half's numpy layouts and the planner, against the JAX
package, in one process (no ranks): the 2d plan and its ``tb_*`` tables
(c ∈ {2, 3}), the ring tables and converters (P ∈ {4, 5, 6, 8}),
``packed_to_device_shard`` for every device, the ``ShardedTriTiles``
round trips, the host-side ``distribute_*`` / ``collect_rows`` /
``assemble_sym``, ``plan_route`` with a mesh over a grid of
(op, n1, n2, P, M, batch), ``explain`` on a mesh, and the raising cases
that need no process group.  Tolerance: none; every table and layout is
held exactly equal.

The reference's affine partitions assign diagonal blocks through
networkx, whose visiting order follows Python's string hashing, so its
tables differ between processes (ROADMAP C).  The fixture
``same_partition`` hands the reference the port's assignment, which is
a valid one of the same partition; the tables are then compared array
for array.
"""
import numpy as np
import pytest
import torch

import repro.core.twodim as rtwo
from repro.core import ringpath as rring
from repro.core.packing import ShardedTriTiles as RSharded
from repro.core.packing import packed_to_device_shard as r_device_shard
from repro.core.triangle import TrianglePartition as RPartition
from repro_torch.core import ringpath as tring
from repro_torch.core import twodim as ttwo
from repro_torch.core.packing import (ShardedTriTiles, TriTiles, pack_tril,
                                      packed_to_device_shard, tril_size)
from repro_torch.distributed.mesh import grid_shapes, plan_mesh

_CACHED = ("make_2d_plan", "tb_pack_tables", "tb_block_tables",
           "tb_device_row_starts")


def _clear_reference_caches():
    for name in _CACHED:
        getattr(rtwo, name).cache_clear()


@pytest.fixture
def same_partition(monkeypatch):
    """The reference's 2d plans built on the port's diagonal
    assignment."""
    orig = rtwo.affine_partition

    def affine(c, alpha=2):
        ref = orig(c, alpha)
        mine = ttri_affine(c, alpha)
        assert ref.blocks == mine.blocks
        assert sorted(x for d in ref.diag for x in d) == \
            sorted(x for d in mine.diag for x in d)
        return RPartition(n=ref.n, blocks=ref.blocks,
                          construction=ref.construction, diag=mine.diag)

    _clear_reference_caches()
    monkeypatch.setattr(rtwo, "affine_partition", affine)
    yield
    _clear_reference_caches()


def ttri_affine(c, alpha=2):
    from repro_torch.core.triangle import affine_partition
    return affine_partition(c, alpha)


def _packed(n, seed, lead=()):
    return np.random.default_rng(seed).standard_normal(
        lead + (tril_size(n),)).astype(np.float32)


# ---------------------------------------------------------------------------
# the 2d plan and its layout tables
# ---------------------------------------------------------------------------
_PLAN_FIELDS = ("R", "Q", "send_slot", "send_valid", "gather_src",
                "self_col", "peer_col", "pairs", "diag_slot")


@pytest.mark.parametrize("c,n1,n2", [(2, 16, 9), (2, 37, 24), (3, 81, 20),
                                     (3, 100, 7)])
def test_2d_plan_equal(same_partition, c, n1, n2):
    a, b = rtwo.make_2d_plan(c, n1, n2), ttwo.make_2d_plan(c, n1, n2)
    for f in ("c", "n1", "n2", "nb", "w", "n1_pad", "n2_pad", "T",
              "num_devices"):
        assert getattr(a, f) == getattr(b, f), f
    for f in _PLAN_FIELDS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("c,n1", [(2, 16), (2, 37), (3, 81), (3, 100)])
def test_tb_pack_tables_equal(same_partition, c, n1):
    for x, y in zip(rtwo.tb_pack_tables(c, n1), ttwo.tb_pack_tables(c, n1)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert rtwo.tb_flat_words(c, n1) == ttwo.tb_flat_words(c, n1)


@pytest.mark.parametrize("c", [2, 3])
def test_tb_block_tables_equal(same_partition, c):
    for x, y in zip(rtwo.tb_block_tables(c), ttwo.tb_block_tables(c)):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("c,n1", [(2, 16), (2, 37), (3, 81), (3, 100)])
def test_tb_device_row_starts_equal(same_partition, c, n1):
    for k in range(c * (c + 1)):
        for x, y in zip(rtwo.tb_device_row_starts(c, n1, k),
                        ttwo.tb_device_row_starts(c, n1, k)):
            assert x.dtype == y.dtype and np.array_equal(x, y), k


@pytest.mark.parametrize("c,n1,lead", [(2, 16, ()), (2, 37, ()),
                                       (3, 81, ()), (3, 100, ()),
                                       (2, 37, (2,)), (3, 50, (2, 1))])
def test_packed_to_device_shard_equal(same_partition, c, n1, lead):
    """Every device's shard, bit for bit, against the reference's and
    against the port's own every-device ``from_packed``."""
    p = _packed(n1, 3, lead)
    ref = RSharded.from_packed(p, n1, c)
    mine = ShardedTriTiles.from_packed(torch.from_numpy(p), n1, c)
    assert np.array_equal(np.asarray(ref.off), mine.off.numpy())
    assert np.array_equal(np.asarray(ref.diag), mine.diag.numpy())
    for k in range(c * (c + 1)):
        ro, rd = r_device_shard(p, n1, c, k)
        to, td = packed_to_device_shard(torch.from_numpy(p), n1, c, k)
        assert np.array_equal(np.asarray(ro), to.numpy()), k
        assert np.array_equal(np.asarray(rd), td.numpy()), k
        assert torch.equal(to, mine.off[..., k, :, :, :])
        assert torch.equal(td, mine.diag[..., k, :, :])


@pytest.mark.parametrize("c,n1,lead", [(2, 16, ()), (2, 37, ()),
                                       (3, 100, ()), (2, 21, (3,))])
def test_sharded_round_trips_are_exact(same_partition, c, n1, lead):
    p = torch.from_numpy(_packed(n1, 4, lead))
    st = ShardedTriTiles.from_packed(p, n1, c)
    assert torch.equal(st.to_packed(), p)
    ref = RSharded.from_packed(p.numpy(), n1, c)
    assert np.array_equal(np.asarray(ref.to_tril()), st.to_tril().numpy())
    assert np.array_equal(np.asarray(ref.to_full()), st.to_full().numpy())
    tril = st.to_tril()
    assert torch.equal(ShardedTriTiles.from_tril(tril, c).to_packed(), p)
    for bm in (8, 16):
        t = st.to_tritiles(bm)
        assert torch.equal(t.to_packed(), p)
        assert torch.equal(ShardedTriTiles.from_tritiles(t, c).to_packed(),
                           p)
    assert torch.equal(ShardedTriTiles.from_packed(p, n1, c).to(
        torch.float64).to_packed(), p.double())
    assert st.batch_shape == lead


def test_sharded_shape_checks():
    off, diag = torch.zeros(6, 1, 4, 4), torch.zeros(6, 4, 4)
    ShardedTriTiles(off, diag, 16, 2)
    with pytest.raises(ValueError):
        ShardedTriTiles(off, torch.zeros(6, 3, 3), 16, 2)
    with pytest.raises(ValueError):
        ShardedTriTiles(off[0], diag[0], 16, 2)     # a local one needs mesh
    with pytest.raises(ValueError):
        ShardedTriTiles(off[0], diag[0], 16, 2, plan_mesh({"x": 6}))


@pytest.mark.parametrize("c,n1,n2", [(2, 16, 9), (2, 37, 24), (3, 81, 20)])
def test_host_helpers_equal(same_partition, c, n1, n2):
    rng = np.random.default_rng(5)
    X = rng.standard_normal((n1, n2)).astype(np.float32)
    S = rng.standard_normal((n1, n1)).astype(np.float32)
    S = np.tril(S) + np.tril(S, -1).T
    a, b = rtwo.make_2d_plan(c, n1, n2), ttwo.make_2d_plan(c, n1, n2)
    d = ttwo.distribute_rows(X, b)
    assert np.array_equal(rtwo.distribute_rows(X, a), d)
    assert np.array_equal(ttwo.collect_rows(d, b), X)
    ro, rd = rtwo.distribute_sym(S, a)
    to, td = ttwo.distribute_sym(S, b)
    assert np.array_equal(ro, to) and np.array_equal(rd, td)
    assert np.array_equal(ttwo.assemble_sym(to, td, b), np.tril(S))
    # the torch staging cuts the same shares on each device
    from repro_torch.blas.meshpath import collect_rows, own_rows
    own = [own_rows(torch.from_numpy(X), b, k) for k in range(b.num_devices)]
    assert np.array_equal(torch.stack(own).numpy(), d)
    assert np.array_equal(collect_rows(torch.stack(own), b).numpy(), X)


# ---------------------------------------------------------------------------
# the ring's tables and converters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("P", [4, 5, 6, 8])
def test_ring_tables_equal(P):
    for x, y in zip(rring.ring_block_tables(P), tring.ring_block_tables(P)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    for x, y in zip(rring.ring_unpack_tables(P),
                    tring.ring_unpack_tables(P)):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("P,n1,lead", [(4, 64, ()), (5, 37, ()),
                                       (6, 50, ()), (8, 65, ()),
                                       (4, 30, (2,))])
def test_ring_converters_equal(P, n1, lead):
    """``packed_to_ring`` and ``ring_stack_to_packed`` bit for bit
    against the reference's, each rank's slots built alone equal to its
    row of the full stack, and the two are not inverses at even P (the
    SYMM input holds the antipodal block whole on both partners)."""
    p = _packed(n1, 6, lead)
    ref = np.asarray(rring.packed_to_ring(p, n1, P))
    mine = tring.packed_to_ring(torch.from_numpy(p), n1, P)
    assert np.array_equal(ref, mine.numpy())
    for r in range(P):
        assert torch.equal(tring.packed_to_ring_local(
            torch.from_numpy(p), n1, P, r), mine[r])
    stack = np.random.default_rng(7).standard_normal(
        ref.shape).astype(np.float32)
    assert np.array_equal(np.asarray(rring.ring_stack_to_packed(stack, n1)),
                          tring.ring_stack_to_packed(
                              torch.from_numpy(stack), n1).numpy())
    back = tring.ring_stack_to_packed(mine, n1).numpy()
    if P % 2:
        assert np.array_equal(back, p)
    else:
        assert not np.array_equal(back, p)


# ---------------------------------------------------------------------------
# the planner with a mesh
# ---------------------------------------------------------------------------
class _RefMesh:
    """What the reference's planner reads of a mesh: its axis sizes."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _route_key(r):
    ch = r.choice
    return (r.op, r.path, r.axis, r.P, r.M,
            None if ch is None else (ch.kind, ch.case, ch.c, ch.p1, ch.p2,
                                     ch.b, ch.idle))


_GRID = [(n1, n2) for n1 in (24, 64, 256, 2048)
         for n2 in (8, 24, 96, 512, 5632)]


@pytest.mark.parametrize("P", [2, 4, 6, 8, 12, 16])
@pytest.mark.parametrize("op", ["syrk", "syr2k", "symm"])
def test_plan_route_matches_reference(op, P):
    from repro.blas.routing import plan_route as rplan
    from repro_torch.blas.routing import plan_route as tplan
    rmesh, tmesh = _RefMesh({"x": P}), plan_mesh({"x": P})
    seen = set()
    for n1, n2 in _GRID:
        for M in (None, 100_000, 500_000, 4_000_000):
            for batch in (False, True):
                a = rplan(op, n1, n2, batch=batch, mesh=rmesh, M=M)
                b = tplan(op, n1, n2, device="cpu", batch=batch, mesh=tmesh,
                          M=M)
                assert _route_key(a) == _route_key(b), (n1, n2, M, batch)
                seen.add(a.path)
    assert "1d" in seen


def test_plan_route_paths_cover_every_mesh_route():
    from repro_torch.blas.routing import plan_route
    paths = set()
    for P in (4, 6, 8, 12):
        for n1, n2 in _GRID:
            for M in (None, 500_000):
                paths.add(plan_route("syrk", n1, n2, device="cpu",
                                     mesh=plan_mesh({"x": P}), M=M).path)
    assert {"1d", "2d", "ring", "3d-limited", "dense"} <= paths, paths
    assert grid_shapes(12) == [(6, 2), (12, 1)]


@pytest.mark.parametrize("shape,axis", [({"data": 2, "model": 4}, None),
                                        ({"data": 4, "model": 1}, None),
                                        ({"data": 3, "model": 4}, "data")])
def test_plan_route_resolves_axes_as_the_reference(shape, axis):
    from repro.blas.routing import plan_route as rplan
    from repro_torch.blas.routing import plan_route as tplan
    for n1, n2 in _GRID:
        a = rplan("syrk", n1, n2, mesh=_RefMesh(shape), axis=axis, M=None)
        b = tplan("syrk", n1, n2, device="cpu", mesh=plan_mesh(shape),
                  axis=axis, M=None)
        assert _route_key(a) == _route_key(b), (shape, n1, n2)


def test_explain_on_a_mesh():
    from repro_torch import blas
    mesh = plan_mesh({"x": 8})
    s = blas.explain("syrk", 2048, 512, mesh=mesh, M=None)
    assert "-> ring ring P=8 nb=256 shifts=4" in s
    s = blas.explain("syrk", 2048, 5632, mesh=plan_mesh({"x": 12}),
                     M=500_000, grad=True)
    lines = s.splitlines()
    assert "-> 3d-limited grid c=2 p1=6 p2=2 b=244" in lines[0]
    # the backward SYMM runs on the forward's route and grid
    assert lines[1].startswith("  dA: symm[2048x5632] -> 3d-limited grid "
                               "c=2 p1=6 p2=2 b=244"), lines[1]


def test_pinned_mesh_route_holds_its_shape_only():
    from repro_torch.blas.routing import Route, pinned, plan_route
    from repro_torch.core.dispatch import AlgoChoice
    mesh = plan_mesh({"x": 12})
    r = Route("syrk", "3d", "test", 64, 48, P=12, axis="x",
              choice=AlgoChoice("3d", 3, 12, c=2, p1=6, p2=2))
    with pinned(r):
        got = plan_route("symm", 64, 48, device="cpu", mesh=mesh, M=None)
        other = plan_route("symm", 64, 64, device="cpu", mesh=mesh, M=None)
        single = plan_route("syrk", 64, 48, device="cpu")
    assert (got.path, got.choice.c, got.choice.p2) == ("3d", 2, 2)
    assert other.path != "3d" or other.choice is not r.choice
    assert single.path == "dense"


# ---------------------------------------------------------------------------
# the raising cases that need no ranks
# ---------------------------------------------------------------------------
def test_a_mesh_without_groups_plans_but_does_not_run():
    from repro_torch import blas
    mesh = plan_mesh({"x": 4})
    a = torch.randn(24, 48)
    assert blas.plan_route("syrk", 24, 48, device="cpu", mesh=mesh,
                           M=None).path == "1d"
    with pytest.raises(RuntimeError, match="has no process group"):
        blas.syrk(a, mesh=mesh, M=None)
    with pytest.raises(RuntimeError, match="has no process group"):
        blas.symm(torch.randn(24, 24), a, mesh=mesh, M=None)
    with pytest.raises(ValueError, match="not in mesh axes"):
        blas.syrk(a, mesh=mesh, axis="model", M=None)


def test_an_unknown_backend_raises(tmp_path):
    from repro_torch.distributed.mesh import init_distributed
    with pytest.raises((ValueError, RuntimeError)):
        init_distributed(0, 1, f"file://{tmp_path}/rdv", backend="nonesuch")
    assert not torch.distributed.is_initialized()


def test_make_mesh_needs_a_process_group():
    from repro_torch.distributed.mesh import make_mesh
    with pytest.raises(RuntimeError, match="init_distributed"):
        make_mesh({"x": 4})


def test_fill_sharded_refuses_a_stack_or_an_accumulator():
    from repro_torch import blas
    with pytest.raises(ValueError, match="batch"):
        blas.syrk(torch.randn(2, 8, 4), fill="sharded")
    with pytest.raises(ValueError, match="accumulator"):
        blas.syrk(torch.randn(8, 4), fill="sharded", c=torch.zeros(8, 8))


def test_fill_sharded_off_the_mesh_is_every_device_layout():
    from repro_torch import blas
    a = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (37, 12)).astype(np.float32))
    st = blas.syrk(a, fill="sharded")
    assert not st.local and st.c == 2
    want = pack_tril(torch.tril(a.double() @ a.double().T)).float()
    torch.testing.assert_close(st.to_packed(), want, rtol=2e-4, atol=2e-4)
    b = torch.randn(37, 5)
    torch.testing.assert_close(blas.symm(st, b), st.to_full() @ b,
                               rtol=2e-4, atol=2e-4)
    t = TriTiles.from_packed(st.to_packed(), 37, 16)
    torch.testing.assert_close(blas.symm(t, b), st.to_full() @ b,
                               rtol=2e-4, atol=2e-4)
