"""Autodiff through the mesh routes and Muon's 1D Newton–Schulz, on gloo
CPU groups, against the JAX package.

One launch per group size runs every case on every rank: P = 4 (1d,
ring), P = 6 (2d, 3d-limited with p2 = 1), P = 12 (3d, 3d-limited with
p2 = 2), each route pinned with ``blas.pinned(Route(...))``.  A case
differentiates vdot(W, op(...)) for a fixed random W (the same on every
rank) through ``blas.syrk`` / ``syr2k`` (fills tril, full, packed,
sharded, the accumulate epilogue, a batched packed stack) or
``blas.symm`` (a dense, TriTiles or ShardedTriTiles operand), and every
rank's gradients are held to ``jax.grad`` of the reference's dense
function on the same numpy inputs at rtol = atol = 2e-4.  A
``fill="sharded"`` output's loss is each rank's weights on its own
shard, whose gradient is that of the weights on the whole packed
triangle.

Muon: ``orthogonalize_1d`` on 4 ranks (a matrix and a stack), each
rank's column shard against the reference's ``orthogonalize_reference``
at rtol = atol = 2e-3 (as ``tests/test_optim.py``), its words against
the closed form, and ``Muon(mode="syrk-1d", mesh=...)`` choosing it.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.core.dispatch import AlgoChoice
from repro_torch.core.packing import tril_size
from repro_torch.distributed.collectives import REPLICATE as REP
from repro_torch.distributed.launch import run_ranks
from test_torch_hygiene import limit_torch_threads  # noqa: F401

TESTS = os.path.dirname(os.path.abspath(__file__))
RTOL = ATOL = 2e-4
N1, N2, K = 29, 24, 2

ROUTES = {
    4: [("1d", {}), ("ring", {})],
    6: [("2d", {"c": 2}), ("3d-limited", {"c": 2, "p2": 1, "b": 5})],
    12: [("3d", {"c": 2, "p2": 2}),
         ("3d-limited", {"c": 2, "p2": 2, "b": 5})],
}

CASES_OF = ["syrk-tril", "syrk-full", "syrk-packed", "syrk-sharded",
            "syrk-packed-batched", "syr2k-tril", "syr2k-packed",
            "syr2k-sharded", "syr2k-accumulate", "symm-dense",
            "symm-tritiles", "symm-sharded", "symm-dense-batched"]

CASES = [(P, path, case) for P, routes in ROUTES.items()
         for path, _ in routes for case in CASES_OF]


def _choice(path, P, c=0, p2=1, b=0):
    if path == "ring":
        return AlgoChoice("ring", 3, P, p1=P, p2=1)
    if not c:
        return AlgoChoice("1d", 1, P, p1=1, p2=P)
    return AlgoChoice(path, 3, P, c=c, p1=c * (c + 1), p2=p2, b=b)


def _inputs(case, seed):
    rng = np.random.default_rng(seed)
    lead = (K,) if case.endswith("batched") else ()
    A = rng.standard_normal(lead + (N1, N2)).astype(np.float32)
    B = rng.standard_normal(lead + (N1, N2)).astype(np.float32)
    S = rng.standard_normal(lead + (N1, N1)).astype(np.float32)
    C0 = rng.standard_normal(lead + (N1, N1)).astype(np.float32)
    W = rng.standard_normal(lead + (N1, N1)).astype(np.float32)
    Wp = rng.standard_normal(lead + (tril_size(N1),)).astype(np.float32)
    Wc = rng.standard_normal(lead + (N1, N2)).astype(np.float32)
    return A, B, S, C0, W, Wp, Wc


def _sharded_weights(Wp, c):
    """The packed weights as every device's shards (global form)."""
    from repro_torch.core.packing import ShardedTriTiles
    return ShardedTriTiles.from_packed(torch.from_numpy(Wp), N1, c)


def _run(mesh, P, path, kw, case, seed):
    from repro_torch import blas
    from repro_torch.blas.routing import Route
    from repro_torch.core.packing import ShardedTriTiles, TriTiles, pack_tril
    A, B, S, C0, W, Wp, Wc = _inputs(case, seed)
    parts = case.split("-")
    op, form = parts[0], parts[1]
    a, b, s, c0 = (torch.from_numpy(x).requires_grad_(True)
                   for x in (A, B, S, C0))
    grid = path in ("2d", "3d", "3d-limited")
    c = kw.get("c", 2)
    route = Route(op, path, "pinned by the test", N1, N2, P=P, axis="x",
                  choice=_choice(path, P, **kw))
    with blas.pinned(route):
        if op == "symm":
            if form == "tritiles":
                t = TriTiles.from_tril(torch.tril(s.detach()), 8)
                leaf = t.tiles.requires_grad_(True)
                out = blas.symm(TriTiles(leaf, N1, 8), b, mesh=mesh)
            elif form == "sharded":
                p = pack_tril(s.detach())
                st = ShardedTriTiles.from_packed(p, N1, c, mesh, "x") \
                    if grid else ShardedTriTiles.from_packed(p, N1, 2)
                off = st.off.requires_grad_(True)
                diag = st.diag.requires_grad_(True)
                out = blas.symm(ShardedTriTiles(off, diag, N1, st.c, st.mesh,
                                                st.axis), b, mesh=mesh)
            else:
                out = blas.symm(s, b, mesh=mesh)
            loss = (out * torch.from_numpy(Wc)).sum()
            loss.backward()
            if form == "tritiles":
                da = TriTiles(leaf.grad, N1, 8).to_tril()
            elif form == "sharded":
                da = ShardedTriTiles(off.grad, diag.grad, N1, st.c, st.mesh,
                                     st.axis).to_tril()
            else:
                da = s.grad
            return {"dA": da.numpy(), "dB": b.grad.numpy()}
        kwargs = dict(mesh=mesh)
        if form == "accumulate":
            kwargs.update(fill="tril", c=c0, alpha=2.0, beta=0.5)
        else:
            kwargs.update(fill=form)
        out = blas.syrk(a, **kwargs) if op == "syrk" else \
            blas.syr2k(a, b, **kwargs)
        if form == "sharded":
            wst = _sharded_weights(Wp, out.c)
            if out.local:
                k = out.shard_index()
                loss = (out.off * wst.off[k]).sum() + \
                    (out.diag * wst.diag[k]).sum()
            else:
                loss = (out.off * wst.off).sum() + (out.diag * wst.diag).sum()
        elif form == "packed":
            loss = (out * torch.from_numpy(Wp)).sum()
        else:
            loss = (out * torch.from_numpy(W)).sum()
        loss.backward()
        res = {"dA": a.grad.numpy()}
        if op == "syr2k":
            res["dB"] = b.grad.numpy()
        if form == "accumulate":
            res["dC"] = c0.grad.numpy()
        return res


def _muon(mesh):
    from repro_torch.distributed import collectives
    from repro_torch.optim import muon
    rng = np.random.default_rng(21)
    G = rng.standard_normal((16, 64)).astype(np.float32)
    Gs = rng.standard_normal((3, 16, 64)).astype(np.float32)
    out = {}
    collectives.reset_word_counts()
    out["one"] = muon.orthogonalize_1d(torch.from_numpy(G), mesh, "x",
                                       steps=5).numpy()
    out["one_words"] = collectives.word_counts()
    out["stack"] = muon.orthogonalize_1d(torch.from_numpy(Gs), mesh, "x",
                                         steps=5).numpy()
    opt = muon.Muon(mode="syrk-1d", mesh=mesh, axis="x")
    collectives.reset_word_counts()
    out["muon_wide"] = opt._orthogonalize(torch.from_numpy(G)).numpy()
    out["muon_tall"] = opt._orthogonalize(torch.from_numpy(G.T.copy())) \
        .numpy()
    out["muon_words"] = collectives.word_counts()
    return out


def rank_main(mesh, P):
    torch.manual_seed(0)
    out = {"grads": {}}
    for i, (P_, path, case) in enumerate(CASES):
        if P_ != P:
            continue
        kw = dict(ROUTES[P])[path]
        out["grads"][(path, case)] = _run(mesh, P, path, kw, case, seed=i)
    if P == 4:
        out["muon"] = _muon(mesh)
    return out


_RESULTS = {}


def _results(P):
    if P not in _RESULTS:
        _RESULTS[P] = run_ranks("test_torch_mesh_grad:rank_main", P,
                                device="cpu", kwargs={"P": P},
                                paths=[TESTS], timeout=400)
    return _RESULTS[P]


def _reference_grads(case, seed, c_weights):
    """jax.grad of the reference's dense function on the same inputs."""
    import jax
    import jax.numpy as jnp

    from repro import blas as rblas
    A, B, S, C0, W, Wp, Wc = _inputs(case, seed)
    parts = case.split("-")
    op, form = parts[0], parts[1]
    if op == "symm":
        f = lambda a, b: jnp.vdot(jnp.asarray(Wc), rblas.symm(a, b))  # noqa
        da, db = jax.grad(f, argnums=(0, 1))(S, B)
        return {"dA": np.tril(np.asarray(da)) if form != "dense"
                else np.asarray(da), "dB": np.asarray(db)}
    call = (lambda a, b, **kw: rblas.syrk(a, **kw)) if op == "syrk" else \
        (lambda a, b, **kw: rblas.syr2k(a, b, **kw))
    if form == "accumulate":
        def f(a, b, c0):
            return jnp.vdot(jnp.asarray(W), call(a, b, fill="tril", c=c0,
                                                 alpha=2.0, beta=0.5))
        g = jax.grad(f, argnums=(0, 1, 2))(A, B, C0)
        out = {"dA": g[0], "dC": g[2]}
        if op == "syr2k":
            out["dB"] = g[1]
        return {k: np.asarray(v) for k, v in out.items()}
    if form == "sharded":
        wp = _sharded_weights(Wp, c_weights).to_packed().numpy()
        fill, w = "packed", wp
    else:
        fill, w = form, (Wp if form == "packed" else W)
    g = jax.grad(lambda a, b: jnp.vdot(jnp.asarray(w), call(a, b,
                                                            fill=fill)),
                 argnums=(0, 1))(A, B)
    out = {"dA": np.asarray(g[0])}
    if op == "syr2k":
        out["dB"] = np.asarray(g[1])
    return out


@pytest.mark.parametrize("P,path,case", CASES)
def test_mesh_gradients_match_jax_grad(P, path, case):
    seed = CASES.index((P, path, case))
    kw = dict(ROUTES[P])[path]
    c = kw.get("c", 2)
    want = _reference_grads(case, seed, c)
    for rank, res in enumerate(_results(P)):
        got = res["grads"][(path, case)]
        assert set(got) == set(want), (got.keys(), want.keys())
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                       atol=ATOL, err_msg=f"rank {rank} {k}")


def _ref_orth(g):
    from repro.optim import orthogonalize_reference
    return np.asarray(orthogonalize_reference(g, steps=5))


def test_orthogonalize_1d_matches_reference():
    """Each rank returns its column shard of the reference's result, as
    the reference's ``shard_map`` does."""
    rng = np.random.default_rng(21)
    G = rng.standard_normal((16, 64)).astype(np.float32)
    Gs = rng.standard_normal((3, 16, 64)).astype(np.float32)
    want = _ref_orth(G)
    want_s = np.stack([_ref_orth(g) for g in Gs])
    res = _results(4)
    w = 64 // len(res)
    for r, rr in enumerate(res):
        m = rr["muon"]
        cols = slice(r * w, (r + 1) * w)
        np.testing.assert_allclose(m["one"], want[..., cols], rtol=2e-3,
                                   atol=2e-3)
        np.testing.assert_allclose(m["stack"], want_s[..., cols], rtol=2e-3,
                                   atol=2e-3)


def test_orthogonalize_1d_words_are_the_closed_form():
    """The reference's wire: per NS step one reduce-scatter and one
    all-gather of the padded packed (16 × 16) Gram, (1 − 1/P) of it
    each, and the norm's all-reduce; nothing else (the result stays
    sharded).  Muon's update adds one gather of the shards, counted as
    the replication."""
    P, m, n, steps = 4, 16, 64, 5
    Lp = -(-tril_size(m) // P) * P
    want = {"reduce_scatter": steps * Lp * (P - 1) // P,
            "all_gather": steps * (P - 1) * Lp // P,
            "all_reduce": 2 * 1 * (P - 1) // P}
    for res in _results(4):
        assert res["muon"]["one_words"] == want
        assert res["muon"]["muon_words"][REP] == 2 * (P - 1) * m * n // P


def test_muon_syrk_1d_mode_runs_orthogonalize_1d():
    rng = np.random.default_rng(21)
    G = rng.standard_normal((16, 64)).astype(np.float32)
    want = _ref_orth(G)
    for res in _results(4):
        m = res["muon"]
        np.testing.assert_allclose(m["muon_wide"], want, rtol=2e-3,
                                   atol=2e-3)
        np.testing.assert_allclose(m["muon_tall"], want.T, rtol=2e-3,
                                   atol=2e-3)
        assert m["muon_words"]["reduce_scatter"] == 2 * 5 * 136 * 3 // 4
