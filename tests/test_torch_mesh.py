"""The mesh schedules of ``repro_torch.blas`` on gloo CPU groups of 4, 6,
8 and 12 ranks, against the numpy oracle and the JAX package.

One launch per group size (``repro_torch.distributed.launch.run_ranks``,
each rank a process, ``init_method=file://`` in a fresh directory) runs
every case of that size; the tests read its results.  A case is one op
(SYRK / SYR2K in every fill, SYMM of a dense, TriTiles, PackedTriangle
or ShardedTriTiles operand, and the accumulate epilogue), batched or
not, on one route pinned with ``blas.pinned(Route(...))``: 1d, ring and
the dense fallback at P = 4, 8; 1d, ring, 2d (c = 2) and 3d-limited
(p2 = 1) at P = 6; 1d, ring, 2d (c = 3), 3d (c = 2, p2 = 2) and
3d-limited (c = 2, p2 = 2; c = 3, p2 = 1) at P = 12.  Each rank's result
is held to the float64 numpy oracle at the reference's tolerance
(``tests/dist_checks.py``: rtol = atol = 2e-4), and each rank's counted
words, by collective kind, must equal the schedule's closed form,
padding included (:func:`_expected_words`); the ring makes ⌊P/2⌋
shifts (S + 1 for SYMM).

Where the reference runs on this jax, the port is also held to its
``shard_map`` outputs on the same numpy inputs (one subprocess with 12
fake XLA devices): the 1D core (``core/onedim``) at every P and the 1D
blas route at P = 4, 8; the 2D core (``syrk_2d`` / ``syr2k_2d`` /
``symm_2d``) at c = 2, 3, with the port's diagonal assignment handed to
the reference (see ``test_torch_mesh_layout.py``).  And the reference's
own flop gate (``tests/dist_checks.py:1075-1105``): per-rank dot flops,
counted by ``torch.utils.flop_counter.FlopCounterMode``, of the ring at
P = 8 against the 2d route at P = 6 at n1 = 2048, n2 = 512.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.dispatch import AlgoChoice, ring_nb
from repro_torch.core.lower_bounds import memory_independent_lower_bound
from repro_torch.core.packing import tril_size
from repro_torch.core.twodim import make_2d_plan
from repro_torch.distributed.collectives import REPLICATE as REP
from repro_torch.distributed.launch import run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")
RTOL = ATOL = 2e-4
N1, N2, K = 37, 24, 2          # ragged n1; n2 splits over every P here


def _choice(path, P, c=0, p2=1, b=0):
    if path == "ring":
        return AlgoChoice("ring", 3, P, p1=P, p2=1)
    if not c:                                   # 1d, and the dense fallback
        return AlgoChoice("1d", 1, P, p1=1, p2=P)
    return AlgoChoice(path, 3, P, c=c, p1=c * (c + 1), p2=p2, b=b)


#: route name -> (path, choice kwargs) per group size
ROUTES = {
    4: [("1d", {}), ("ring", {}), ("dense", {})],
    6: [("1d", {}), ("ring", {}), ("2d", {"c": 2}),
        ("3d-limited", {"c": 2, "p2": 1, "b": 5})],
    8: [("1d", {}), ("ring", {}), ("dense", {})],
    12: [("1d", {}), ("ring", {}), ("2d", {"c": 3}),
         ("3d", {"c": 2, "p2": 2}), ("3d-limited", {"c": 2, "p2": 2, "b": 5}),
         ("3d-limited", {"c": 3, "p2": 1, "b": 7})],
}

OPS = ([("syrk", f, bt) for f in ("tril", "full", "packed", "sharded")
        for bt in (False, True) if not (f == "sharded" and bt)]
       + [("syr2k", f, bt) for f in ("tril", "full", "packed", "sharded")
          for bt in (False, True) if not (f == "sharded" and bt)]
       + [("symm", f, bt) for f in ("dense", "tritiles", "packedtri",
                                    "sharded")
          for bt in (False, True) if not (f in ("packedtri", "sharded")
                                          and bt)]
       + [("syrk", "accumulate", False), ("syr2k", "accumulate", True)])


def _route_name(path, kw):
    return path + "".join(f"-{k}{v}" for k, v in sorted(kw.items()))


CASES = [(P, _route_name(path, kw), f"{op}-{form}-{'b' if bt else 'u'}")
         for P, routes in ROUTES.items() for path, kw in routes
         for op, form, bt in OPS]


# --------------------------------------------------------------------------
# closed forms of the words each rank sends
# --------------------------------------------------------------------------
def _expected_words(path, kw, op, form, batched, n1, n2, P):
    """Words a rank sends, by kind.  The schedule's kinds are what the
    reference's ``shard_map`` body sends; ``REP`` is the all-gather
    that replicates a sharded result, which the reference leaves to its
    caller."""
    k = K if batched else 1
    L = tril_size(n1)
    out = {}

    def add(kind, words):
        if words:
            out[kind] = out.get(kind, 0) + int(words)

    m_exch = 1 if op == "syrk" else 2          # exchanges of the 2d body
    if path == "dense":
        return out
    if path == "1d":
        Lp = -(-L // P) * P
        if op == "symm":
            add("all_gather", (P - 1) * k * Lp // P)          # Alg 9: A
            add(REP, (P - 1) * k * n1 * n2 // P)              # C columns
        else:
            add("reduce_scatter", k * Lp * (P - 1) // P)      # Alg 7 / 8
            add("all_gather", (P - 1) * k * Lp // P)          # packed exit
        return out
    if path == "ring":
        nb, S = ring_nb(n1, P), P // 2
        if op == "symm":
            add("ppermute", (2 * S + 1) * k * nb * n2)
            add(REP, (P - 1) * k * nb * n2)
        else:
            add("ppermute", S * m_exch * k * nb * n2)
            add(REP, (P - 1) * k * (S + 1) * nb * nb)
        return out
    c = kw["c"]
    p1 = c * (c + 1)
    p2 = kw.get("p2", 1)
    T = c * (c - 1) // 2
    if path == "3d-limited":
        bw = max(min(kw["b"], n2 // p2), 1)
        nsteps = -(-(n2 // p2) // bw)
        plan = make_2d_plan(c, n1, bw)
    else:
        nsteps = 1
        plan = make_2d_plan(c, n1, n2 // p2)
    nb, w = plan.nb, plan.w
    F = (T + 1) * nb * nb
    s = -(-F // p2)                                     # rep shard words
    if op == "symm":
        add("all_to_all", nsteps * 2 * (p1 - 1) * k * nb * w // 1)
        add("all_gather", (p2 - 1) * k * s)             # Alg 15: A over rep
        add(REP, (P - 1) * nsteps * k * c * nb * w)     # C exit
        return out
    add("all_to_all", nsteps * m_exch * (p1 - 1) * k * nb * w)
    add("reduce_scatter", k * s * p2 * (p2 - 1) // p2)
    add(REP, (p2 - 1) * k * s)                          # the slice's block
    if form != "sharded":
        add(REP, (p1 - 1) * k * F)                      # packed exit
    return out


def _predicted(path, kw, m, P, n1=N1, n2=N2):
    """The planner's prediction for the route (dispatch.predicted_*)."""
    from repro_torch.core.dispatch import (predicted_words_1d,
                                           predicted_words_2d,
                                           predicted_words_3d)
    if path in ("1d", "dense"):
        return predicted_words_1d(n1, P)
    if path == "ring":
        return m * (P // 2) * ring_nb(n1, P) * n2
    if path == "2d":
        return predicted_words_2d(n1, n2, m, kw["c"])
    return predicted_words_3d(n1, n2, m, kw["c"], kw.get("p2", 1))


# --------------------------------------------------------------------------
# what each rank runs
# --------------------------------------------------------------------------
def _inputs(seed, batched, n1=N1, n2=N2):
    rng = np.random.default_rng(seed)
    lead = (K,) if batched else ()
    A = rng.standard_normal(lead + (n1, n2)).astype(np.float32)
    B = rng.standard_normal(lead + (n1, n2)).astype(np.float32)
    S = rng.standard_normal(lead + (n1, n1)).astype(np.float32)
    C0 = rng.standard_normal(lead + (n1, n1)).astype(np.float32)
    return A, B, S, C0


def _tril_idx(n):
    return np.tril_indices(n)


def _oracle(op, form, A, B, S, C0):
    """float64 numpy result in the case's output layout."""
    A, B, S, C0 = (x.astype(np.float64) for x in (A, B, S, C0))
    T = np.swapaxes
    n1 = A.shape[-2]
    i, j = _tril_idx(n1)
    if op == "symm":
        sym = np.tril(S) + T(np.tril(S, -1), -1, -2)
        return sym @ B
    g = A @ T(A, -1, -2) if op == "syrk" else \
        A @ T(B, -1, -2) + B @ T(A, -1, -2)
    if form == "accumulate":
        return 2.0 * np.tril(g) + 0.5 * np.tril(C0)
    if form == "full":
        return g
    if form in ("packed",):
        return g[..., i, j]
    return np.tril(g)


def _normalized_err(got, want):
    return float((np.abs(got - want) / (ATOL + RTOL * np.abs(want))).max())


def _run_case(mesh, blas, P, path, kw, op, form, batched, seed):
    from repro_torch.blas.routing import Route
    from repro_torch.core.packing import (PackedTriangle, ShardedTriTiles,
                                          TriTiles, pack_tril)
    from repro_torch.distributed import collectives
    A, B, S, C0 = _inputs(seed, batched)
    a, b, s, c0 = (torch.from_numpy(x) for x in (A, B, S, C0))
    route = Route(op, path, "pinned by the test", N1, N2, P=P, axis="x",
                  choice=_choice(path, P, **kw))
    grid = path in ("2d", "3d", "3d-limited")
    with blas.pinned(route):
        if op == "symm":
            if form == "tritiles":
                a_in = TriTiles.from_tril(torch.tril(s), 16)
            elif form == "packedtri":
                a_in = PackedTriangle(pack_tril(s), N1)
            elif form == "sharded":
                p = pack_tril(s)
                a_in = ShardedTriTiles.from_packed(p, N1, kw["c"], mesh, "x") \
                    if grid else ShardedTriTiles.from_packed(p, N1, 2)
            else:
                a_in = s
            collectives.reset_word_counts()
            got = blas.symm(a_in, b, mesh=mesh)
        elif form == "accumulate":
            fill = "tril"
            collectives.reset_word_counts()
            if op == "syrk":
                got = blas.syrk(a, fill=fill, c=c0, alpha=2.0, beta=0.5,
                                mesh=mesh)
            else:
                got = blas.syr2k(a, b, fill=fill, c=c0, alpha=2.0,
                                 beta=0.5, mesh=mesh)
        else:
            collectives.reset_word_counts()
            got = blas.syrk(a, fill=form, mesh=mesh) if op == "syrk" else \
                blas.syr2k(a, b, fill=form, mesh=mesh)
    words = collectives.word_counts()
    calls = collectives.call_counts()
    if isinstance(got, ShardedTriTiles):
        assert got.local == grid, (path, got.local)
        got = got.to_tril()
    want = _oracle(op, form, A, B, S, C0)
    return {"err": _normalized_err(got.numpy(), want), "words": words,
            "calls": calls, "shape": tuple(got.shape)}


def _gathered(x, comm):
    from repro_torch.distributed import collectives
    return collectives.all_gather(x[None], comm).numpy()


def _counted(wire, name, fn):
    """Run ``fn``, keep the schedule's words it sent (every kind but the
    replication) under ``name``; returns its result."""
    from repro_torch.distributed import collectives
    collectives.reset_word_counts()
    y = fn()
    wire[name] = {k: v for k, v in collectives.word_counts().items()
                  if k != REP}
    return y


def _reference_cases(mesh, P):
    """The port's counterparts of the reference's shard_map outputs
    (every rank's shard gathered, the gathers not counted), and the
    schedule's words of each call (``out["wire"]``)."""
    from repro_torch import blas
    from repro_torch.core import onedim, twodim
    from repro_torch.optim import muon
    comm = mesh.comm("x")
    out, wire = {}, {}
    out["wire"] = wire
    rng = np.random.default_rng(100 + P)
    n1, n2 = 24, 8 * P
    A = rng.standard_normal((n1, n2)).astype(np.float32)
    B = rng.standard_normal((n1, n2)).astype(np.float32)
    S = rng.standard_normal((n1, n1)).astype(np.float32)
    S = np.tril(S) + np.tril(S, -1).T
    a, b = torch.from_numpy(A), torch.from_numpy(B)
    out["1d-syrk"] = _gathered(_counted(
        wire, "1d-syrk", lambda: onedim.syrk_1d(a, mesh)), comm).reshape(-1)
    out["1d-syr2k"] = _gathered(_counted(
        wire, "1d-syr2k", lambda: onedim.syr2k_1d(a, b, mesh)),
        comm).reshape(-1)
    packed = torch.from_numpy(onedim.pack_for_1d_symm(S, P))
    out["1d-symm"] = np.concatenate(list(_gathered(_counted(
        wire, "1d-symm", lambda: onedim.symm_1d(packed, b, n1, mesh)),
        comm)), axis=-1)
    if P in (4, 8):
        n2 = 24 * P                   # Thm 9 case 1: the planner's 1d
        A = rng.standard_normal((n1, n2)).astype(np.float32)
        B = rng.standard_normal((n1, n2)).astype(np.float32)
        a, b = torch.from_numpy(A), torch.from_numpy(B)
        out["blas1d-syrk"] = _counted(wire, "blas1d-syrk", lambda: blas.syrk(
            a, fill="packed", mesh=mesh, M=None)).numpy()
        out["blas1d-syr2k"] = _counted(
            wire, "blas1d-syr2k", lambda: blas.syr2k(
                a, b, fill="packed", mesh=mesh, M=None)).numpy()
        out["blas1d-symm"] = _counted(wire, "blas1d-symm", lambda: blas.symm(
            torch.from_numpy(S), b, mesh=mesh, M=None)).numpy()
        out["blas1d-routes"] = [blas.plan_route(op, n1, n2, device="cpu",
                                                mesh=mesh, M=None).path
                                for op in ("syrk", "syr2k", "symm")]
    if P == 4:
        for name, shape in (("orth1d", (16, 64)),
                            ("orth1d-stack", (3, 16, 64))):
            g = torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32))
            _counted(wire, name, lambda: muon.orthogonalize_1d(
                g, mesh, "x", steps=5))
    if P in (6, 12):
        c = 2 if P == 6 else 3
        n1, n2 = 4 * c * c, 3 * (c + 1)
        plan = twodim.make_2d_plan(c, n1, n2)
        A = rng.standard_normal((n1, n2)).astype(np.float32)
        B = rng.standard_normal((n1, n2)).astype(np.float32)
        S = rng.standard_normal((n1, n1)).astype(np.float32)
        S = np.tril(S) + np.tril(S, -1).T
        a_dist = torch.from_numpy(twodim.distribute_rows(A, plan))
        b_dist = torch.from_numpy(twodim.distribute_rows(B, plan))
        off, diag = _counted(wire, "2d-syrk",
                             lambda: twodim.syrk_2d(a_dist, plan, mesh))
        out["2d-syrk"] = (_gathered(off, comm), _gathered(diag, comm))
        off, diag = _counted(wire, "2d-syr2k", lambda: twodim.syr2k_2d(
            a_dist, b_dist, plan, mesh))
        out["2d-syr2k"] = (_gathered(off, comm), _gathered(diag, comm))
        s_off, s_diag = (torch.from_numpy(x)
                         for x in twodim.distribute_sym(S, plan))
        out["2d-symm"] = _gathered(_counted(
            wire, "2d-symm", lambda: twodim.symm_2d(s_off, s_diag, b_dist,
                                                    plan, mesh)), comm)
    return out


def _flops(fn):
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def _flop_cases(mesh, P):
    """Per-rank dot flops at n1 = 2048, n2 = 512: ring at P = 8, the 2d
    route (c = 2) at P = 6."""
    from repro_torch.blas import meshpath
    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.standard_normal((2048, 512)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2048, 512)).astype(np.float32))
    if P == 8:
        return {"ring-syrk": _flops(lambda: meshpath.syrk_ring_packed(
                    a, mesh, "x")),
                "ring-syr2k": _flops(lambda: meshpath.syr2k_ring_packed(
                    a, b, mesh, "x"))}
    return {"2d-syrk": _flops(lambda: meshpath.syrk_2d_sharded(
                a, 2, mesh, "x").to_packed()),
            "2d-syr2k": _flops(lambda: meshpath.syr2k_2d_sharded(
                a, b, 2, mesh, "x").to_packed())}


def _special_cases(mesh, P):
    """Words of the 1D SYRK alone at n1 = 64 (P = 4), a group of the wrong
    size (P = 4), and a two-axis mesh (P = 8)."""
    import torch.distributed as dist

    from repro_torch import blas
    from repro_torch.core import onedim
    from repro_torch.distributed import collectives
    from repro_torch.distributed.mesh import Comm, Mesh, make_mesh
    out = {}
    rng = np.random.default_rng(12)
    if P == 4:
        a = torch.from_numpy(rng.standard_normal((64, 256)).astype(
            np.float32))
        collectives.reset_word_counts()
        onedim.syrk_1d(a, mesh)
        out["syrk64-schedule"] = collectives.word_counts()
        collectives.reset_word_counts()
        blas.syrk(a, fill="packed", mesh=mesh, M=None)
        out["syrk64-blas"] = collectives.word_counts()
        halves = [dist.new_group([0, 1]), dist.new_group([2, 3])]
        me = dist.get_rank()
        bad = Mesh({"x": 4}, rank=me, groups={"x": Comm(
            "x", 4, me, (0, 1, 2, 3), halves[me // 2])})
        try:
            blas.syrk(a, mesh=bad, M=None)
            out["wrong-size"] = "no error"
        except RuntimeError as e:
            out["wrong-size"] = str(e)
    if P == 8:
        two = make_mesh({"data": 2, "model": 4}, device=mesh.device)
        A, B, S, _ = _inputs(13, False, n1=24, n2=96)
        a, b, s = (torch.from_numpy(x) for x in (A, B, S))
        collectives.reset_word_counts()
        got = blas.syrk(a, fill="packed", mesh=two, M=None)
        g = A.astype(np.float64) @ A.T.astype(np.float64)
        out["two-axis"] = {
            "route": blas.plan_route("syrk", 24, 96, device="cpu", mesh=two,
                                     M=None).path,
            "axis": blas.plan_route("syrk", 24, 96, device="cpu", mesh=two,
                                    M=None).axis,
            "err": _normalized_err(got.numpy(), g[_tril_idx(24)]),
            "words": collectives.word_counts(),
            "symm_err": _normalized_err(
                blas.symm(s, b, mesh=two, axis="data", M=None).numpy(),
                (np.tril(S) + np.tril(S, -1).T).astype(np.float64) @ B)}
    return out


def rank_main(mesh, P):
    from repro_torch import blas
    torch.manual_seed(0)
    out = {"cases": {}}
    for i, (P_, route, case) in enumerate(CASES):
        if P_ != P:
            continue
        path, kw = next((p, k) for p, k in ROUTES[P]
                        if _route_name(p, k) == route)
        op, form, bt = case.split("-")
        out["cases"][(route, case)] = _run_case(
            mesh, blas, P, path, kw, op, form, bt == "b", seed=i)
    out["reference"] = _reference_cases(mesh, P)
    if P in (6, 8):
        out["flops"] = _flop_cases(mesh, P)
    out["special"] = _special_cases(mesh, P)
    return out


_RESULTS = {}


def _results(P):
    if P not in _RESULTS:
        _RESULTS[P] = run_ranks("test_torch_mesh:rank_main", P,
                                device="cpu", kwargs={"P": P},
                                paths=[TESTS], timeout=400)
    return _RESULTS[P]


# --------------------------------------------------------------------------
# the reference's shard_map outputs (one subprocess, 12 fake devices)
# --------------------------------------------------------------------------
_REF_PROBE = r"""
import sys, numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
import repro.core.twodim as rt
from repro.core.triangle import TrianglePartition
from repro_torch.core.triangle import affine_partition as port_affine
orig = rt.affine_partition
def affine(c, alpha=2):
    p, q = orig(c, alpha), port_affine(c, alpha)
    assert p.blocks == q.blocks
    return TrianglePartition(n=p.n, blocks=p.blocks,
                             construction=p.construction, diag=q.diag)
rt.affine_partition = affine
from repro import blas
from repro.core import onedim
from repro.optim.muon import orthogonalize_1d
import json

# words a device sends in fn's collectives, by kind, read off its jaxpr
# (shard_map bodies see per-device shapes; a scan's body counts its trip
# count times), with the port's per-collective accounting
def wire(name, fn, *args):
    words = {}
    def add(kind, w):
        if w:
            words[kind] = words.get(kind, 0) + int(w)
    def walk(j, mult):
        for e in j.eqns:
            nm = e.primitive.name
            n = sum(int(np.prod(v.aval.shape)) for v in e.invars)
            if nm == "reduce_scatter":
                add("reduce_scatter", mult * (n * (P - 1) // P))
            elif nm == "all_gather":
                add("all_gather", mult * n * (P - 1))
            elif nm == "all_to_all":
                add("all_to_all", mult * (n * (P - 1) // P))
            elif nm.startswith("psum"):
                add("all_reduce", mult * (2 * n * (P - 1) // P))
            elif nm in ("ppermute", "while", "psum_scatter", "pmax",
                        "pmin"):
                raise AssertionError(f"{name}: unhandled {nm}")
            m = mult * e.params["length"] if nm == "scan" else mult
            for p in e.params.values():
                for sp in (p if isinstance(p, (list, tuple)) else [p]):
                    if hasattr(sp, "jaxpr") and hasattr(sp.jaxpr, "eqns"):
                        walk(sp.jaxpr, m)
                    elif hasattr(sp, "eqns"):
                        walk(sp, m)
    walk(jax.make_jaxpr(fn)(*args).jaxpr, 1)
    out[f"{P}/wire/{name}"] = np.array(json.dumps(words))

out = {}
for P in (4, 6, 8, 12):
    mesh = Mesh(np.array(jax.devices()[:P]), ("x",))
    rng = np.random.default_rng(100 + P)
    n1, n2 = 24, 8 * P
    A = rng.standard_normal((n1, n2)).astype(np.float32)
    B = rng.standard_normal((n1, n2)).astype(np.float32)
    S = rng.standard_normal((n1, n1)).astype(np.float32)
    S = np.tril(S) + np.tril(S, -1).T
    out[f"{P}/1d-syrk"] = np.asarray(onedim.syrk_1d(jnp.asarray(A), mesh))
    out[f"{P}/1d-syr2k"] = np.asarray(onedim.syr2k_1d(
        jnp.asarray(A), jnp.asarray(B), mesh))
    out[f"{P}/1d-symm"] = np.asarray(onedim.symm_1d(
        jnp.asarray(onedim.pack_for_1d_symm(S, P)), jnp.asarray(B), n1,
        mesh))
    wire("1d-syrk", lambda a: onedim.syrk_1d(a, mesh), A)
    wire("1d-syr2k", lambda a, b: onedim.syr2k_1d(a, b, mesh), A, B)
    wire("1d-symm", lambda p, b: onedim.symm_1d(p, b, n1, mesh),
         onedim.pack_for_1d_symm(S, P), B)
    if P in (4, 8):
        n2 = 24 * P
        A = rng.standard_normal((n1, n2)).astype(np.float32)
        B = rng.standard_normal((n1, n2)).astype(np.float32)
        for op in ("syrk", "syr2k", "symm"):
            assert blas.plan_route(op, n1, n2, mesh=mesh, M=None).path == \
                "1d", op
        out[f"{P}/blas1d-syrk"] = np.asarray(blas.syrk(
            A, fill="packed", mesh=mesh, M=None))
        out[f"{P}/blas1d-syr2k"] = np.asarray(blas.syr2k(
            A, B, fill="packed", mesh=mesh, M=None))
        out[f"{P}/blas1d-symm"] = np.asarray(blas.symm(S, B, mesh=mesh,
                                                       M=None))
        wire("blas1d-syrk", lambda a: blas.syrk(a, fill="packed", mesh=mesh,
                                                M=None), A)
        wire("blas1d-syr2k", lambda a, b: blas.syr2k(
            a, b, fill="packed", mesh=mesh, M=None), A, B)
        wire("blas1d-symm", lambda s, b: blas.symm(s, b, mesh=mesh, M=None),
             S, B)
    if P == 4:
        for name, shape in (("orth1d", (16, 64)),
                            ("orth1d-stack", (3, 16, 64))):
            wire(name, lambda g: orthogonalize_1d(g, mesh, "x", steps=5),
                 np.zeros(shape, np.float32))
    if P in (6, 12):
        c = 2 if P == 6 else 3
        n1, n2 = 4 * c * c, 3 * (c + 1)
        plan = rt.make_2d_plan(c, n1, n2)
        A = rng.standard_normal((n1, n2)).astype(np.float32)
        B = rng.standard_normal((n1, n2)).astype(np.float32)
        S = rng.standard_normal((n1, n1)).astype(np.float32)
        S = np.tril(S) + np.tril(S, -1).T
        a_dist = jnp.asarray(rt.distribute_rows(A, plan))
        b_dist = jnp.asarray(rt.distribute_rows(B, plan))
        wire("2d-syrk", lambda a: rt.syrk_2d(a, plan, mesh), a_dist)
        wire("2d-syr2k", lambda a, b: rt.syr2k_2d(a, b, plan, mesh),
             a_dist, b_dist)
        off, diag = rt.syrk_2d(a_dist, plan, mesh)
        out[f"{P}/2d-syrk-off"], out[f"{P}/2d-syrk-diag"] = \
            np.asarray(off), np.asarray(diag)
        off, diag = rt.syr2k_2d(a_dist, b_dist, plan, mesh)
        out[f"{P}/2d-syr2k-off"], out[f"{P}/2d-syr2k-diag"] = \
            np.asarray(off), np.asarray(diag)
        s_off, s_diag = rt.distribute_sym(S, plan)
        wire("2d-symm", lambda o, d, b: rt.symm_2d(o, d, b, plan, mesh),
             s_off, s_diag, b_dist)
        out[f"{P}/2d-symm"] = np.asarray(rt.symm_2d(
            jnp.asarray(s_off), jnp.asarray(s_diag), b_dist, plan, mesh))
np.savez(sys.argv[1], **out)
print("REFERENCE-OK", len(out))
"""

_REF = {}


def _reference(tmp_path_factory):
    if "out" not in _REF:
        path = str(tmp_path_factory.mktemp("mesh_ref") / "ref.npz")
        env = dict(os.environ)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=12"
        env["JAX_PLATFORMS"] = "cpu"
        env["PYTHONPATH"] = os.path.join(ROOT, "src")
        out = subprocess.run([sys.executable, "-c", _REF_PROBE, path],
                             capture_output=True, text=True, env=env,
                             timeout=300)
        assert out.returncode == 0, out.stderr[-4000:]
        _REF["out"] = dict(np.load(path))
    return _REF["out"]


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------
@pytest.mark.parametrize("P,route,case", CASES)
def test_schedule_matches_oracle_and_its_words(P, route, case):
    """Every rank's result within 2e-4 of the numpy oracle, and every
    rank's words by kind equal to the schedule's closed form."""
    path, kw = next((p, k) for p, k in ROUTES[P]
                    if _route_name(p, k) == route)
    op, form, bt = case.split("-")
    want = _expected_words(path, kw, op, form, bt == "b", N1, N2, P)
    m = 1 if op == "syrk" else 2
    print(f"P={P} {route} {case}: words a rank {want}, predicted "
          f"{_predicted(path, kw, m, P):.1f}, Thm 9 lower bound "
          f"{memory_independent_lower_bound(N1, N2, P, m).bound:.1f}")
    for rank, res in enumerate(_results(P)):
        r = res["cases"][(route, case)]
        assert r["err"] <= 1.0, (rank, r)
        assert r["words"] == want, (rank, r["words"], want)
        if path == "ring":           # ⌊P/2⌋ shifts, one more for SYMM
            assert r["calls"]["ppermute"] == P // 2 + (op == "symm"), r


@pytest.mark.parametrize("P", [4, 6, 8, 12])
@pytest.mark.parametrize("op", ["syrk", "syr2k", "symm"])
def test_1d_core_matches_reference_shard_map(tmp_path_factory, P, op):
    ref = _reference(tmp_path_factory)[f"{P}/1d-{op}"]
    got = _results(P)[0]["reference"][f"1d-{op}"]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


WIRE_CASES = ([(P, f"1d-{op}") for P in (4, 6, 8, 12)
               for op in ("syrk", "syr2k", "symm")]
              + [(P, f"blas1d-{op}") for P in (4, 8)
                 for op in ("syrk", "syr2k", "symm")]
              + [(P, f"2d-{op}") for P in (6, 12)
                 for op in ("syrk", "syr2k", "symm")]
              + [(4, "orth1d"), (4, "orth1d-stack")])


@pytest.mark.parametrize("P,name", WIRE_CASES)
def test_schedule_words_are_the_reference_wire(tmp_path_factory, P, name):
    """The words of the port's schedule (its replication aside) equal
    those of the collectives in the reference's own ``shard_map``
    program for the same call and shapes, read off its jaxpr: the 1D
    core and blas route, the 2D core, and Muon's orthogonalize_1d."""
    import json
    ref = json.loads(str(_reference(tmp_path_factory)[f"{P}/wire/{name}"]))
    print(f"P={P} {name}: reference wire {ref}")
    assert ref, name
    for rank, r in enumerate(_results(P)):
        assert r["reference"]["wire"][name] == ref, (rank,
                                                     r["reference"]["wire"])


@pytest.mark.parametrize("P", [4, 8])
@pytest.mark.parametrize("op", ["syrk", "syr2k", "symm"])
def test_1d_blas_matches_reference_blas(tmp_path_factory, P, op):
    ref = _reference(tmp_path_factory)[f"{P}/blas1d-{op}"]
    res = _results(P)
    assert res[0]["reference"]["blas1d-routes"] == ["1d"] * 3
    for r in res:
        np.testing.assert_allclose(r["reference"][f"blas1d-{op}"], ref,
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("P", [6, 12])
@pytest.mark.parametrize("op", ["syrk", "syr2k", "symm"])
def test_2d_core_matches_reference_shard_map(tmp_path_factory, P, op):
    ref = _reference(tmp_path_factory)
    got = _results(P)[0]["reference"][f"2d-{op}"]
    if op == "symm":
        np.testing.assert_allclose(got, ref[f"{P}/2d-symm"], rtol=RTOL,
                                   atol=ATOL)
        return
    np.testing.assert_allclose(got[0], ref[f"{P}/2d-{op}-off"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got[1], ref[f"{P}/2d-{op}-diag"], rtol=RTOL,
                               atol=ATOL)


def test_1d_syrk_moves_the_packed_row_words():
    """P = 4, n1 = 64: the 1D SYRK's reduce-scatter moves (1 − 1/P) of the
    padded packed triangle, 1560 words a rank (BENCH_blas_mesh.json's
    row); the blas call adds the same again in the all-gather of the
    packed slices that the reference's body makes too."""
    from repro_torch.core.dispatch import predicted_words_1d
    from repro_torch.core.lower_bounds import memory_independent_lower_bound
    res = _results(4)
    lb = memory_independent_lower_bound(64, 256, 4, 1).bound
    print(f"1d SYRK P=4 n1=64: words {res[0]['special']['syrk64-schedule']}"
          f", predicted {predicted_words_1d(64, 4)}, lower bound {lb:.1f}")
    for r in res:
        assert r["special"]["syrk64-schedule"] == {"reduce_scatter": 1560}
        assert r["special"]["syrk64-blas"] == {"reduce_scatter": 1560,
                                               "all_gather": 1560}
    assert predicted_words_1d(64, 4) == 1560


def test_predicted_words_are_the_schedules_closed_forms():
    """dispatch's predictions against the schedules' counted forms at
    padding-free shapes: 1d exactly, 2d exactly (all-to-all words),
    3d's slice all-to-all plus its replication reduce-scatter."""
    from repro_torch.core.dispatch import (predicted_words_1d,
                                           predicted_words_2d,
                                           predicted_words_3d)
    w = _expected_words("1d", {}, "syrk", "packed", False, 64, 256, 4)
    assert w["reduce_scatter"] == predicted_words_1d(64, 4)
    w = _expected_words("2d", {"c": 2}, "syrk", "sharded", False, 64, 96, 6)
    assert w == {"all_to_all": predicted_words_2d(64, 96, 1, 2)}
    w = _expected_words("2d", {"c": 3}, "syr2k", "sharded", False, 81, 96,
                        12)
    assert w == {"all_to_all": predicted_words_2d(81, 96, 2, 3)}
    w = _expected_words("3d", {"c": 2, "p2": 2}, "syrk", "sharded", False,
                        64, 96, 12)
    # the slice's 2D words plus (1 − 1/p2) of its triangle block, against
    # the (n1·n2/(c·p2) + n1²/(2·p1)) of eq. (7)
    assert w["all_to_all"] == 64 * 48 // 2 * 5 // 6
    assert w["reduce_scatter"] == (1 + 1) * 16 * 16 // 2
    assert predicted_words_3d(64, 96, 1, 2, 2) == 64 * 96 / 4 + 64 * 64 / 12


@pytest.mark.parametrize("P", [4, 6, 8, 12])
def test_ranks_agree_and_every_route_ran(P):
    res = _results(P)
    assert len(res) == P
    routes = {route for route, _ in res[0]["cases"]}
    assert routes == {_route_name(p, k) for p, k in ROUTES[P]}
    for r in res[1:]:
        for key, case in r["cases"].items():
            assert case["shape"] == res[0]["cases"][key]["shape"]


def test_ring_halves_the_2d_flops():
    """The reference's gate: ring (P = 8) against 2d (P = 6, c = 2) at
    n1 = 2048, n2 = 512, per-rank dot flops (the largest rank's)."""
    ring = {k: max(r["flops"][k] for r in _results(8))
            for k in ("ring-syrk", "ring-syr2k")}
    two = {k: max(r["flops"][k] for r in _results(6))
           for k in ("2d-syrk", "2d-syr2k")}
    syrk = ring["ring-syrk"] / two["2d-syrk"]
    syr2k_model = ring["ring-syr2k"] / (2 * two["2d-syrk"])
    syr2k = ring["ring-syr2k"] / two["2d-syr2k"]
    print(f"ring/2d per-rank dot flops: syrk {syrk:.4f}, syr2k vs two 2d "
          f"syrk {syr2k_model:.4f}, syr2k vs 2d syr2k {syr2k:.4f}")
    assert syrk <= 0.6
    assert syr2k_model <= 0.6
    assert syr2k <= 0.7


def test_a_group_of_the_wrong_size_raises():
    msg = _results(4)[0]["special"]["wrong-size"]
    assert "has size 4 but its group has 2 ranks" in msg, msg


def test_a_two_axis_mesh_runs_on_its_named_axis():
    r = _results(8)[0]["special"]["two-axis"]
    assert (r["route"], r["axis"]) == ("1d", "model")
    assert r["err"] <= 1.0 and r["symm_err"] <= 1.0
    L = tril_size(24)
    Lp = -(-L // 4) * 4
    assert r["words"]["reduce_scatter"] == Lp * 3 // 4
