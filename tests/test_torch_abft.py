"""The port's ABFT-checked SYRK / SYR2K / SYMM
(``repro_torch.distributed.resilience``) against the reference's
(``repro.distributed.resilience``).

The same numpy inputs (from a seed) go to both.  The checksum algebra
(``_prefix_dots``, ``packed_row_sums``, ``packed_sym_matvec``) and the
port's torch checker are held to the reference's numpy ones: the same
flags on clean and corrupted payloads, and residuals within 1e-6 of the
row's magnitude bound (m + 1), at the reference test's 32 × 16 and at
a ragged n (100, not a multiple of ``_PREFIX_BLOCK``).  The checked
calls on the local route, under the same ``FaultSpec``s and seeds, give
the reference's ``AbftReport`` fields and ``FaultEvent``s, outputs
within 1e-5 of the reference's (``tests/test_faults.py``), and every
repaired output bit-equal to the port's clean one.
``rebuild_replacement_shard`` is the reference's bit for bit.

The mesh routes run on gloo CPU groups (``run_ranks``, one launch per
group size): 1d and ring at P = 8, 2d (c = 2) and 3d-limited (c = 2,
p2 = 1) at P = 6, 3d (c = 2, p2 = 2) at P = 12; SYRK on every route,
SYR2K and SYMM on 1d and 2d (as ``tests/dist_checks.py::check_faults``
does).  The reference's mesh ABFT is red on this jax (its 3d routes,
ROADMAP queue C) and in no tier-1 test, so the outputs are held to the
port's own clean result on every rank and the flags to the reference's
numpy checker on the same corrupted payload; a retry's words are twice
the schedule's, a rebuild's the schedule's alone.
"""
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.distributed import faults as tf
from repro_torch.distributed import resilience as tr
from repro_torch.distributed.launch import run_ranks
from repro_torch.distributed.straggler import rebuild_replacement_shard
from test_torch_hygiene import limit_torch_threads  # noqa: F401

TESTS = os.path.dirname(os.path.abspath(__file__))
SHAPES = [(32, 16), (100, 24)]          # the reference test's; ragged n
KINDS = ["bitflip", "nan"]


@pytest.fixture(scope="module")
def ref():
    """The reference's modules, imported here and not at the top: the
    rank processes of the mesh tests import this file and need no jax."""
    import jax.numpy as jnp

    from repro.distributed import faults, resilience
    from repro.distributed.straggler import rebuild_replacement_shard
    return SimpleNamespace(jnp=jnp, faults=faults, res=resilience,
                           rebuild=rebuild_replacement_shard)


@pytest.fixture
def same_partition(ref, monkeypatch):
    """The reference's 2d tables built on the port's diagonal assignment
    (the reference's follows the process's string hashing, ROADMAP C;
    ``tests/test_torch_mesh_layout.py`` does the same)."""
    import repro.core.twodim as rtwo
    from repro.core.triangle import TrianglePartition

    from repro_torch.core.triangle import affine_partition
    cached = [getattr(rtwo, name) for name in (
        "make_2d_plan", "tb_pack_tables", "tb_block_tables",
        "tb_device_row_starts")]
    orig = rtwo.affine_partition

    def affine(c, alpha=2):
        theirs, mine = orig(c, alpha), affine_partition(c, alpha)
        assert theirs.blocks == mine.blocks
        return TrianglePartition(n=theirs.n, blocks=theirs.blocks,
                                 construction=theirs.construction,
                                 diag=mine.diag)

    for fn in cached:
        fn.cache_clear()
    monkeypatch.setattr(rtwo, "affine_partition", affine)
    yield
    for fn in cached:
        fn.cache_clear()


def _pack(x):
    """Row-major packed lower triangle (the reference's ``pack_tril``)."""
    return x[np.tril_indices(x.shape[0])].astype(np.float32)


def _inputs(n1, n2, seed=7):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n1, n2)).astype(np.float32)
    b = rng.standard_normal((n1, n2)).astype(np.float32)
    return a, b, _pack(rng.standard_normal((n1, n1)).astype(np.float32))


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# the checksum algebra
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,k", [(1, 3), (63, 8), (64, 8), (32, 16),
                                 (100, 24), (200, 16)])
def test_prefix_dots_match_reference(ref, n, k):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, k)).astype(np.float32)
    y = rng.standard_normal((n, k)).astype(np.float32)
    want = ref.res._prefix_dots(x, y)
    got = tr._prefix_dots(_t(x), _t(y)).numpy()
    bound = np.abs(x) @ np.abs(y).sum(0) + 1.0
    assert got.shape == want.shape == (n,)
    assert np.all(np.abs(got - want) <= 1e-6 * bound)


@pytest.mark.parametrize("n", [33, 32, 100])
def test_packed_row_sums_and_sym_matvec_match_reference(ref, n):
    rng = np.random.default_rng(n)
    p = _pack(rng.standard_normal((n, n)).astype(np.float32))
    v = rng.standard_normal(n).astype(np.float32)
    low = np.abs(np.tril(np.asarray(ref.res._tril_view(p, n))))
    mag = low + np.tril(low, -1).T                     # |sym(S)|
    rs = tr.packed_row_sums(_t(p), n).numpy()
    assert np.all(np.abs(rs - ref.res.packed_row_sums(p, n))
                  <= 1e-6 * (mag.sum(1) + 1.0))
    mv = tr.packed_sym_matvec(_t(p), n, _t(v)).numpy()
    assert np.all(np.abs(mv - ref.res.packed_sym_matvec(p, n, v))
                  <= 1e-6 * (mag @ np.abs(v) + 1.0))


def _ref_terms(jr, op, ops, out, n):
    """The reference checker's residual and bound, from its own pieces."""
    ones = np.ones((n,), np.float32)
    if op == "symm":
        p, b = ops
        s = jr.packed_sym_matvec(p, n, b @ np.ones(b.shape[1], np.float32))
        m = jr.packed_sym_matvec(np.abs(p), n,
                                 np.abs(b) @ np.ones(b.shape[1], np.float32))
        with np.errstate(invalid="ignore"):
            return np.abs(out.sum(axis=1) - s), m
    with np.errstate(invalid="ignore"):
        rs = np.add.reduceat(out, jr._row_starts(n))
    if op == "syrk":
        (a,) = ops
        ab = np.abs(a)
        return np.abs(rs - jr._prefix_dots(a, a)), ab @ (ab.T @ ones)
    a, b = ops
    ab, bb = np.abs(a), np.abs(b)
    s = jr._prefix_dots(a, b) + jr._prefix_dots(b, a)
    return np.abs(rs - s), ab @ (bb.T @ ones) + bb @ (ab.T @ ones)


def _payload(op, a, b, p):
    """The op's operands and its clean output (numpy, f32)."""
    if op == "syrk":
        return (a,), _pack(a @ a.T)
    if op == "syr2k":
        return (a, b), _pack(a @ b.T + b @ a.T)
    n = a.shape[0]
    low = np.zeros((n, n), np.float32)
    low[np.tril_indices(n)] = p
    return (p, b), ((low + np.tril(low, -1).T) @ b).astype(np.float32)


def _corrupt_like_reference(ref, op, out, kind, device, world, seed=3):
    """The reference's corruption hook on a numpy payload."""
    jr, jnp = ref.res, ref.jnp
    with ref.faults.inject(ref.faults.FaultSpec(
            site=f"collective:{op}", kind=kind, device=device), seed=seed):
        if op == "symm":
            return np.asarray(jr._corrupt_dense_rows(jnp.asarray(out),
                                                     world, op, None))
        n = int((np.sqrt(8 * out.shape[0] + 1) - 1) // 2)
        return np.asarray(jr._corrupt_packed(jnp.asarray(out), n, world,
                                             op, None))


def _checkers(mod):
    return {"syrk": mod._check_syrk, "syr2k": mod._check_syr2k,
            "symm": mod._check_symm}


@pytest.mark.parametrize("n1,n2", SHAPES)
@pytest.mark.parametrize("op", ["syrk", "syr2k", "symm"])
@pytest.mark.parametrize("fault", [None, ("bitflip", 0, 1),
                                   ("bitflip", 3, 4), ("nan", 1, 4),
                                   ("nan", 5, 6)])
def test_checker_flags_match_reference(ref, op, n1, n2, fault):
    """The port's torch checker flags exactly the rows the reference's
    numpy checker flags, on the same clean or corrupted payload, and its
    residuals agree to 1e-6 of the row's bound."""
    jr = ref.res
    a, b, p = _inputs(n1, n2)
    ops, out = _payload(op, a, b, p)
    if fault is not None:
        out = _corrupt_like_reference(ref, op, out, *fault)
    rtol = jr._default_rtol(n1, n2, np.float32)
    assert rtol == tr._default_rtol(n1, n2, torch.float32)
    want = np.asarray(_checkers(jr)[op](n1, rtol, jr.DEFAULT_ATOL)(*ops,
                                                                   out))
    got = _checkers(tr)[op](n1, rtol, tr.DEFAULT_ATOL)(
        *map(_t, ops), _t(out)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() == (fault is not None)
    resid, thr = tr.checksum_residuals(op, *map(_t, ops), out=_t(out))
    r_ref, m_ref = _ref_terms(jr, op, ops, out, n1)
    np.testing.assert_allclose(thr.numpy(),
                               jr.DEFAULT_ATOL + rtol * (m_ref + 1.0),
                               rtol=1e-5)
    resid = resid.numpy()
    assert np.array_equal(np.isnan(resid), np.isnan(r_ref))
    ok = ~np.isnan(r_ref)
    assert np.all(np.abs(resid[ok] - r_ref[ok]) <= 1e-6 * (m_ref[ok] + 1))


def test_default_rtol_follows_eps(ref):
    for jd, td in ((np.float32, torch.float32),
                   (ref.jnp.bfloat16, torch.bfloat16),
                   (np.int32, torch.int32), (None, None)):
        assert tr._default_rtol(8, 8, td) == ref.res._default_rtol(8, 8, jd)


def test_owner_of_rows_matches_device_bands(ref):
    for n, world in ((50, 4), (64, 6), (100, 8)):
        for k in range(world):
            r0, r1 = tr.device_rows(n, world, k)
            assert (r0, r1) == ref.res.device_rows(n, world, k)
            assert tr.owner_of_rows(np.arange(r0, r1), n, world) == [k]


# ---------------------------------------------------------------------------
# checked calls on the local route
# ---------------------------------------------------------------------------
def _call(res, mod, op, ops, spec=None, seed=0, **kw):
    """One checked call under ``spec``: (output, report fields, events,
    the AbftError or None)."""
    fn = getattr(res, f"checked_{op}")
    specs = [mod.FaultSpec(**spec)] if spec else []
    with mod.inject(*specs, seed=seed) as inj:
        try:
            out, rep = fn(*ops, route="local", **kw)
            err = None
        except res.AbftError as e:
            out, rep, err = None, e.report, e
    events = [(e.site, e.kind, e.step, e.device, e.detail)
              for e in inj.events]
    fields = (rep.op, rep.route, rep.n, rep.detected, rep.attempts,
              rep.bad_rows, rep.devices, rep.primary, rep.action)
    return (None if out is None else np.asarray(out)), fields, events, err


def _both(ref, op, spec=None, seed=0, n1=32, n2=16, **kw):
    """The same checked call through the reference and the port."""
    a, b, p = _inputs(n1, n2)
    ops = {"syrk": (a,), "syr2k": (a, b), "symm": (p, b)}[op]
    jkw = {k: ref.jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor)
           else v for k, v in kw.items()}
    want = _call(ref.res, ref.faults, op, tuple(map(ref.jnp.asarray, ops)),
                 spec, seed, **jkw)
    got = _call(tr, tf, op, tuple(map(_t, ops)), spec, seed, **kw)
    return want, got


@pytest.mark.parametrize("n1,n2", SHAPES)
@pytest.mark.parametrize("op", ["syrk", "syr2k", "symm"])
def test_checked_clean_matches_reference(ref, op, n1, n2):
    (o_ref, f_ref, e_ref, _), (o, f, e, _) = _both(ref, op, n1=n1, n2=n2)
    assert f == f_ref and e == e_ref == []
    assert not f[3] and f[4] == 1 and f[-1] == "none"
    np.testing.assert_allclose(o, o_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n1,n2", SHAPES)
@pytest.mark.parametrize("op,kind,seed", [
    ("syrk", "bitflip", 4), ("syrk", "nan", 4), ("syr2k", "bitflip", 6),
    ("syr2k", "nan", 6), ("symm", "nan", 6), ("symm", "bitflip", 6)])
def test_checked_retry_matches_reference(ref, op, kind, seed, n1, n2):
    spec = dict(site=f"collective:{op}", kind=kind, device=0)
    (o_ref, f_ref, e_ref, _), (o, f, e, _) = _both(ref, op, spec, seed,
                                                   n1, n2, backoff=0.0)
    assert f == f_ref and e == e_ref and len(e) == 1
    assert f[3] and f[4] == 2 and f[7] == 0 and f[-1] == "retry"
    np.testing.assert_allclose(o, o_ref, rtol=1e-5, atol=1e-5)
    clean = _both(ref, op, n1=n1, n2=n2)[1][0]
    np.testing.assert_array_equal(o, clean)


@pytest.mark.parametrize("op", ["syrk", "syr2k", "symm"])
def test_checked_persistent_fault_raises_like_reference(ref, op):
    spec = dict(site=f"collective:{op}", kind="nan", device=0, times=0)
    (_, f_ref, e_ref, err_ref), (_, f, e, err) = _both(
        ref, op, spec, 0, retries=1, backoff=0.0)
    assert isinstance(err, tr.AbftError) and err_ref is not None
    assert f == f_ref and e == e_ref and len(e) == 2
    assert f[3] and f[4] == 2 and f[5]


@pytest.mark.parametrize("op", ["syrk", "syr2k"])
@pytest.mark.parametrize("kind", KINDS)
def test_checked_rebuild_from_reference_matches(ref, same_partition, op,
                                                kind):
    a, b, _ = _inputs(32, 16)
    ops = (_t(a),) if op == "syrk" else (_t(a), _t(b))
    clean, _ = getattr(tr, f"checked_{op}")(*ops)
    spec = dict(site=f"collective:{op}", kind=kind, device=0)
    (_, f_ref, e_ref, _), (o, f, e, _) = _both(ref, op, spec, 4,
                                               reference=clean, c=2)
    assert f == f_ref and e == e_ref
    assert f[3] and f[4] == 1 and f[-1] == "rebuild" and f[6]
    np.testing.assert_array_equal(o, clean.numpy())


@pytest.mark.parametrize("c", [2, 3])
@pytest.mark.parametrize("n", [37, 64])
def test_rebuild_replacement_shard_matches_reference(ref, same_partition,
                                                     n, c):
    rng = np.random.default_rng(n + c)
    packed = rng.standard_normal(n * (n + 1) // 2).astype(np.float32)
    for k in range(c * (c + 1)):
        off_r, diag_r = ref.rebuild(ref.jnp.asarray(packed), n, c, k)
        off, diag = rebuild_replacement_shard(_t(packed), n, c, k)
        np.testing.assert_array_equal(off.numpy(), np.asarray(off_r))
        np.testing.assert_array_equal(diag.numpy(), np.asarray(diag_r))


# ---------------------------------------------------------------------------
# mesh routes on gloo CPU groups
# ---------------------------------------------------------------------------
MESH_N1, MESH_N2 = 64, 48
#: P -> (route, checked kwargs, wire world)
MESH_ROUTES = {
    8: [("1d", {}, 8), ("ring", {}, 8)],
    6: [("2d", {"c": 2}, 6),
        ("3d-limited", {"c": 2, "p2": 1, "chunk": 16}, 6)],
    12: [("3d", {"c": 2, "p2": 2}, 6)],
}
#: op -> the routes it runs on (as check_faults does)
MESH_OPS = {"syrk": ("1d", "ring", "2d", "3d", "3d-limited"),
            "syr2k": ("1d", "2d"), "symm": ("1d", "2d")}


def _mesh_faults(op, world):
    """(kind, band, seed) of each injected fault (check_faults's bands,
    and the other kind on another band)."""
    if op == "syrk":
        return [("bitflip", world - 1, 3), ("nan", 2, 3)]
    if op == "syr2k":
        return [("bitflip", world - 2, 5), ("nan", 1, 5)]
    return [("nan", 1, 5), ("bitflip", world - 1, 5)]


def rank_main(mesh, routes):
    """One rank: every (route, op) case, clean, under each fault, and
    (SYRK / SYR2K) rebuilt from the clean result."""
    from repro_torch.distributed import collectives
    a, b, p = (_t(x) for x in _inputs(MESH_N1, MESH_N2, seed=55))
    out = []
    for route, kw, world in routes:
        for op, on in MESH_OPS.items():
            if route not in on:
                continue
            ops = {"syrk": (a,), "syr2k": (a, b), "symm": (p, b)}[op]
            fn = getattr(tr, f"checked_{op}")
            collectives.reset_word_counts()
            clean, rep0 = fn(*ops, route=route, mesh=mesh, **kw)
            case = {"route": route, "op": op,
                    "words": collectives.word_counts(),
                    "clean_detected": rep0.detected, "faults": []}
            run = tr.route_runner(op, route, mesh, "x", kw.get("c"),
                                  kw.get("p2"), kw.get("chunk"))
            for kind, band, seed in _mesh_faults(op, world):
                def spec():
                    return tf.FaultSpec(site=f"collective:{op}", kind=kind,
                                        device=band)
                collectives.reset_word_counts()
                with tf.inject(spec(), seed=seed) as inj:
                    got, rep = fn(*ops, route=route, mesh=mesh,
                                  backoff=0.0, **kw)
                words = collectives.word_counts()
                # the payload the first attempt checked: the clean result
                # corrupted by a fresh injector with the same coordinates
                with tf.inject(spec(), seed=seed):
                    payload = (tr._corrupt_dense_rows(clean, world, op, None)
                               if op == "symm" else tr._corrupt_packed(
                                   clean, MESH_N1, world, op, None))
                case["faults"].append({
                    "events": len(inj.events),
                    "report": (rep.detected, rep.attempts, rep.bad_rows,
                               rep.devices, rep.primary, rep.action),
                    "bit_equal": bool(torch.equal(got, clean)),
                    "again_equal": bool(torch.equal(run(*ops), clean)),
                    "words": words, "payload": payload.numpy()})
            if op != "symm":
                spec = tf.FaultSpec(site=f"collective:{op}", kind="bitflip",
                                    device=1)
                collectives.reset_word_counts()
                with tf.inject(spec, seed=3):
                    got, rep = fn(*ops, route=route, mesh=mesh,
                                  reference=clean,
                                  **dict(kw, c=kw.get("c", 2)))
                case["rebuild"] = {
                    "action": rep.action, "devices": rep.devices,
                    "attempts": rep.attempts,
                    "bit_equal": bool(torch.equal(got, clean)),
                    "words": collectives.word_counts()}
            out.append(case)
    return out


_RESULTS = {}


def _mesh(P):
    if P not in _RESULTS:
        _RESULTS[P] = run_ranks("test_torch_abft:rank_main", P,
                                device="cpu", paths=[TESTS], timeout=400,
                                kwargs={"routes": MESH_ROUTES[P]})
    return _RESULTS[P]


MESH_CASES = [(P, route, op) for P, routes in MESH_ROUTES.items()
              for route, _, _ in routes for op, on in MESH_OPS.items()
              if route in on]


@pytest.mark.parametrize("P,route,op", MESH_CASES)
def test_mesh_route_detects_localizes_repairs(ref, P, route, op):
    """Every rank: a clean call detects nothing; each fault is detected
    on its band, the flags are the reference checker's on the same
    payload, the repair is bit-equal to the clean result and a retry's
    words are twice the schedule's; a rebuild sends no extra word."""
    jr = ref.res
    world = {r: w for r, _, w in MESH_ROUTES[P]}[route]
    cases = [next(c for c in r if (c["route"], c["op"]) == (route, op))
             for r in _mesh(P)]
    a, b, p = _inputs(MESH_N1, MESH_N2, seed=55)
    ops = {"syrk": (a,), "syr2k": (a, b), "symm": (p, b)}[op]
    chk = _checkers(jr)[op](MESH_N1,
                            jr._default_rtol(MESH_N1, MESH_N2, np.float32),
                            jr.DEFAULT_ATOL)
    for rank, case in enumerate(cases):
        assert not case["clean_detected"]
        sched = case["words"]
        assert sched == cases[0]["words"] and sum(sched.values()) > 0
        for i, (kind, band, _) in enumerate(_mesh_faults(op, world)):
            f = case["faults"][i]
            detected, attempts, bad_rows, devices, primary, action = \
                f["report"]
            assert f["events"] == 1 and detected and attempts == 2
            assert action == "retry" and primary == band, (rank, kind, f)
            assert f["bit_equal"] and f["again_equal"], (rank, kind)
            assert f["words"] == {k: 2 * v for k, v in sched.items()}
            # every rank corrupted the same slots the same way
            np.testing.assert_array_equal(f["payload"],
                                          cases[0]["faults"][i]["payload"])
            flagged = np.nonzero(np.asarray(chk(*ops, f["payload"])))[0]
            assert bad_rows == flagged[:16].tolist(), (rank, kind)
            assert devices == jr.owner_of_rows(flagged, MESH_N1, world)
            assert primary == jr.owner_of_rows([flagged.max()], MESH_N1,
                                               world)[0]
        if op != "symm":
            rb = case["rebuild"]
            assert rb["action"] == "rebuild" and rb["devices"]
            assert rb["attempts"] == 1 and rb["bit_equal"]
            assert rb["words"] == sched
