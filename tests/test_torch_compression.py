"""The port's int8 gradient compression
(``repro_torch.distributed.compression``) against the reference's
(``repro.distributed.compression``).

The same numpy inputs (from a seed) go to both.  ``quantize_int8`` /
``dequantize_int8`` and 50 steps of ``ErrorFeedbackInt8.compress``
(plain leaves, a ``sym_mask``, a ``PackedTriangle`` leaf) are bit-equal
to the reference run op by op (under ``jax.jit`` XLA turns the scale's
``/ 127`` into ``* (1/127)``, which moves a scale by an ulp now and
then); ``wire_bytes_per_device`` is the reference's float.

The compressed all-reduces run on gloo CPU groups of 2, 4 and 6 ranks
(``run_ranks``, one launch per group size), each rank with its own
input.  The reference's collective needs one device per rank, and this
process has one, so they are held bit for bit to a numpy oracle of the
same algorithm (per-rank quantization, the stripes summed as a left fold
in rank order, requantized), and on equal replicas to the input within
the reference test's own atol (``max|x|/50`` dense, ``max|S|/30``
symmetric, ``tests/test_distributed.py``).  Their bytes a rank
(``collectives.byte_counts()``) are ``wire_bytes_per_device`` exactly
where ``block·P`` divides the length, and the padded count stated here
where it does not.

The trainer's ``--compress-grads``: a 2 + 2-step resume equal to the
uninterrupted run bit for bit, the EF residuals included, and
checkpoints ``{"params", "opt", "ef"}`` written by either package
restored by the other with 0 mismatches.
"""
import dataclasses
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core.packing import PackedTriangle, tril_size
from repro_torch.distributed import compression as tc
from repro_torch.distributed.launch import run_ranks
from test_torch_hygiene import limit_torch_threads  # noqa: F401

TESTS = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def ref():
    """The reference's modules, imported here and not at the top: the
    rank processes of the all-reduce tests import this file and need no
    jax."""
    import jax
    import jax.numpy as jnp

    from repro.core import packing
    from repro.distributed import compression
    return SimpleNamespace(jax=jax, jnp=jnp, comp=compression, pk=packing)


def _np(x) -> np.ndarray:
    return np.asarray(x.vec if hasattr(x, "vec") else x)


def _sym(n, seed=0):
    a = np.random.default_rng(seed).standard_normal((n, n))
    return ((a + a.T) / 2).astype(np.float32)


# ---------------------------------------------------------------------------
# quantize / dequantize
# ---------------------------------------------------------------------------
def _quant_input(block, n, seed):
    """Normal values with an all-zero block (the 1e-12 scale floor) and
    a block whose scale is exactly 1 (max 127) holding half-way ties,
    ±127 included."""
    x = (np.random.default_rng(seed).standard_normal(n) * 3) \
        .astype(np.float32)
    x[:block] = 0.0
    ties = np.array([127.0, -127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5],
                    np.float32)
    x[block:block + len(ties)] = ties
    return x


@pytest.mark.parametrize("block", [16, 64, 128, 256])
@pytest.mark.parametrize("ragged", [False, True])
def test_quantize_dequantize_bit_equal(ref, block, ragged):
    n = block * 7 + (block // 2 + 3 if ragged else 0)
    x = _quant_input(block, n, seed=block)
    qj, sj = ref.comp.quantize_int8(ref.jnp.asarray(x), block)
    qt, st = tc.quantize_int8(torch.from_numpy(x), block)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert tuple(qt.shape) == (-(-n // block), block)
    assert tuple(st.shape) == (-(-n // block), 1)
    assert np.array_equal(qt.numpy(), _np(qj))
    assert np.array_equal(st.numpy(), _np(sj))
    assert float(st[0, 0]) == np.float32(1e-12)          # the zero block
    # max|block| / 127 rounded once (no multiply by a rounded 1/127)
    amax = np.abs(np.pad(x, (0, (-n) % block))).reshape(-1, block) \
        .max(axis=1, keepdims=True)
    once = (amax.astype(np.float64) / 127).astype(np.float32)
    assert np.array_equal(st.numpy(), np.maximum(once, np.float32(1e-12)))
    assert qt[1, :8].tolist() == [127, -127, 0, 2, 2, 0, -2, 126]
    for shape in [(n,), (1, n)]:
        dj = ref.comp.dequantize_int8(qj, sj, shape)
        dt = tc.dequantize_int8(qt, st, shape)
        assert tuple(dt.shape) == shape and dt.dtype == torch.float32
        assert np.array_equal(dt.numpy(), _np(dj))
    dt = tc.dequantize_int8(qt, st, (n,), dtype=torch.bfloat16)
    assert dt.dtype == torch.bfloat16


def test_int8_quant_roundtrip_error_bound():
    """The reference's own test, on the port."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(1000)
                         .astype(np.float32) * 3)
    q, s = tc.quantize_int8(x, block=128)
    back = tc.dequantize_int8(q, s, x.shape)
    assert (back - x).abs().max() <= x.abs().max() / 127.0


# ---------------------------------------------------------------------------
# error feedback
# ---------------------------------------------------------------------------
def _ef_case(case, rng):
    """(numpy leaves, sym_mask or None, block) of one EF case."""
    if case == "plain":
        return {"w": rng.standard_normal((3, 40)).astype(np.float32),
                "b": (rng.standard_normal(50) * 1e-3).astype(np.float32)}, \
            None, 64
    if case == "sym_mask":
        return {"g": _sym(12, 9), "w": rng.standard_normal(8)
                .astype(np.float32)}, {"g": True, "w": False}, 16
    return {"p": ("packed", rng.standard_normal(tril_size(10))
                  .astype(np.float32), 10),
            "w": rng.standard_normal(20).astype(np.float32)}, None, 16


def _to(pkg, leaves, jnp, JPacked):
    """The case's tree for the reference ("j") or the port ("t")."""
    out = {}
    for k, v in leaves.items():
        if isinstance(v, tuple):
            out[k] = JPacked(jnp.asarray(v[1]), v[2]) if pkg == "j" \
                else PackedTriangle(torch.from_numpy(v[1]), v[2])
        else:
            out[k] = jnp.asarray(v) if pkg == "j" else torch.from_numpy(v)
    return out


@pytest.mark.parametrize("case", ["plain", "sym_mask", "packed"])
def test_error_feedback_50_steps_bit_equal(ref, case):
    """50 steps of fresh gradients: every output and every residual is
    the reference's bit for bit; sym-masked outputs are exactly
    symmetric with a (tril_size(n),) residual; a PackedTriangle comes
    back as one."""
    rng = np.random.default_rng(3)
    leaves, mask, block = _ef_case(case, rng)
    JPacked, jnp = ref.pk.PackedTriangle, ref.jnp
    cj = ref.comp.ErrorFeedbackInt8(block=block, sym_mask=mask)
    ct = tc.ErrorFeedbackInt8(block=block, sym_mask=mask)
    sj = cj.init(_to("j", leaves, jnp, JPacked))
    st = ct.init(_to("t", leaves, jnp, JPacked))
    if case == "sym_mask":
        assert tuple(st.error["g"].shape) == (tril_size(12),)
    for step in range(50):
        g = {k: (v[0], v[1] * rng.standard_normal(v[1].shape)
                 .astype(np.float32), v[2]) if isinstance(v, tuple)
             else v * rng.standard_normal(v.shape).astype(np.float32)
             for k, v in leaves.items()}
        gj, sj = cj.compress(_to("j", g, jnp, JPacked), sj)
        gt, st = ct.compress(_to("t", g, jnp, JPacked), st)
        assert sorted(gt) == sorted(g)
        for k in g:
            assert type(gt[k]) is (PackedTriangle if k == "p"
                                   else torch.Tensor), k
            assert np.array_equal(_np(gt[k]), _np(gj[k])), (step, k)
            assert np.array_equal(_np(st.error[k]), _np(sj.error[k])), \
                (step, k)
            assert _np(st.error[k]).dtype == np.float32
        if case == "sym_mask":
            assert torch.equal(gt["g"], gt["g"].T)


def test_error_feedback_mask_length_and_shape_raise(ref):
    grads = {"a": torch.zeros(4), "b": torch.zeros(3, 3)}
    for pkg, cls in (("t", tc.ErrorFeedbackInt8),
                     ("j", ref.comp.ErrorFeedbackInt8)):
        tree = grads if pkg == "t" else \
            {k: ref.jnp.zeros(tuple(v.shape)) for k, v in grads.items()}
        with pytest.raises(ValueError, match="sym_mask has 1 leaves, "
                                             "grads have 2"):
            cls(sym_mask={"b": True}).init(tree)
        with pytest.raises(ValueError, match="must be"):
            cls(sym_mask={"a": True, "b": False}).init(tree)


def test_error_feedback_accumulates_residual():
    """The reference's test, on the port: the sum of EF-compressed tiny
    gradients converges to the sum of the true ones."""
    comp = tc.ErrorFeedbackInt8(block=64)
    state = comp.init({"w": torch.zeros(64)})
    g = {"w": torch.full((64,), 1e-3)}
    acc = torch.zeros(64)
    for _ in range(50):
        dq, state = comp.compress(g, state)
        acc = acc + dq["w"]
    np.testing.assert_allclose(acc.numpy(), np.full(64, 50e-3), rtol=0.05)


def test_error_feedback_sym_mask_packed_residual():
    """The reference's test, on the port."""
    n = 12
    s = torch.from_numpy(_sym(n, 9))
    comp = tc.ErrorFeedbackInt8(block=16, sym_mask={"g": True, "w": False})
    state = comp.init({"g": s, "w": torch.zeros(8)})
    assert tuple(state.error["g"].shape) == (tril_size(n),)
    g = {"g": s * 1e-3, "w": torch.full((8,), 1e-3)}
    acc = torch.zeros(n, n)
    for _ in range(50):
        dq, state = comp.compress(g, state)
        assert torch.equal(dq["g"], dq["g"].T)
        acc = acc + dq["g"]
    np.testing.assert_allclose(acc.numpy(), s.numpy() * 50e-3, rtol=0.05,
                               atol=1e-6)


@pytest.mark.parametrize("n", [1_000_000, 11_534_336, 1000, 300])
@pytest.mark.parametrize("p", [1, 2, 4, 6, 16])
def test_wire_bytes_model_is_the_reference(ref, n, p):
    for block in (16, 64, 256):
        for compressed in (True, False):
            for sym_n in (None, 10, 1000):
                kw = dict(compressed=compressed, block=block, sym_n=sym_n)
                assert tc.wire_bytes_per_device(n, p, **kw) == \
                    ref.comp.wire_bytes_per_device(n, p, **kw)
    assert tc.wire_bytes_per_device(11_534_336, 4, compressed=True) == \
        17_571_840
    assert tc.wire_bytes_per_device(2048 * 2048, 4, compressed=True,
                                    sym_n=2048) == 3_196_440


# ---------------------------------------------------------------------------
# the compressed all-reduces on gloo CPU groups
# ---------------------------------------------------------------------------
GROUPS = [2, 4, 6]
#: (name, kind, shape, block, equal replicas)
AR_CASES = [
    ("dense_aligned", "dense", (24, 96), 64, False),   # 64·P divides 2304
    ("dense_ragged", "dense", (1000,), 64, False),
    ("dense_replicas", "dense", (512,), 128, True),     # the reference's
    ("sym_aligned", "sym", (128, 128), 16, False),     # 16·P | 8256
    ("sym_ragged", "sym", (24, 24), 64, False),
    ("sym_replicas", "sym", (24, 24), 64, True),
    ("packed", "packed", (24, 24), 64, False),
    ("packed_replicas", "packed", (24, 24), 64, True),
]


def _ar_input(name, shape, rank, equal):
    seed = 1000 * (1 + [c[0] for c in AR_CASES].index(name)) \
        + (0 if equal else rank)
    rng = np.random.default_rng(seed)
    if len(shape) == 2 and shape[0] == shape[1]:
        a = rng.standard_normal(shape)
        return ((a + a.T) / 2).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def rank_main(mesh):
    """One rank: every case with this rank's input, its output and the
    words and bytes it sent; then one uncompressed all-reduce."""
    from repro_torch.distributed import collectives
    comm = mesh.comm("x")
    out = {}
    for name, kind, shape, block, equal in AR_CASES:
        x = torch.from_numpy(_ar_input(name, shape, mesh.rank, equal))
        collectives.reset_word_counts()
        if kind == "dense":
            y = tc.compressed_allreduce(x, comm, block=block)
        elif kind == "sym":
            y = tc.compressed_allreduce_sym(x, comm, block=block)
        else:
            y = tc.compressed_allreduce_sym(PackedTriangle.from_dense(x),
                                            comm, block=block)
        out[name] = {"type": type(y).__name__, "dtype": str(y.dtype),
                     "y": _np(y).copy(),
                     "words": collectives.word_counts(),
                     "bytes": collectives.byte_counts()}
    x = torch.from_numpy(_ar_input("dense_aligned", (24, 96), mesh.rank,
                                   False))
    collectives.reset_word_counts()
    y = collectives.all_reduce(x, comm)
    out["all_reduce"] = {"y": y.numpy().copy(),
                         "words": collectives.word_counts(),
                         "bytes": collectives.byte_counts()}
    return out


_RESULTS = {}


def _group(P):
    if P not in _RESULTS:
        _RESULTS[P] = run_ranks("test_torch_compression:rank_main", P,
                                device="cpu", paths=[TESTS], timeout=300)
    return _RESULTS[P]


def _np_quant(x, block):
    flat = x.reshape(-1)
    flat = np.pad(flat, (0, (-flat.size) % block))
    blocks = flat.reshape(-1, block)
    scale = np.maximum(np.abs(blocks).max(axis=1, keepdims=True)
                       / np.float32(127.0), np.float32(1e-12))
    q = np.clip(np.round(blocks / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def _padded_blocks(n, P, block):
    nb = -(-n // block)
    return nb + (-nb) % P


def _np_allreduce(xs, block):
    """The oracle: each rank's blocks quantized, stripe j summed over the
    ranks as a left fold in rank order, / P, requantized, dequantized."""
    P, n = len(xs), xs[0].size
    nb = _padded_blocks(n, P, block)
    qs = [_np_quant(np.pad(x.reshape(-1), (0, nb * block - n)), block)
          for x in xs]
    stripe = nb // P
    parts = []
    for j in range(P):
        rows = slice(j * stripe, (j + 1) * stripe)
        acc = qs[0][0][rows].astype(np.float32) * qs[0][1][rows]
        for q, s in qs[1:]:
            acc = acc + q[rows].astype(np.float32) * s[rows]
        q2, s2 = _np_quant(acc / np.float32(P), block)
        parts.append(q2.astype(np.float32) * s2)
    return np.concatenate(parts).reshape(-1)[:n].reshape(xs[0].shape)


def _np_pack(a):
    return a[np.tril_indices(a.shape[-1])]


def _np_unpack_sym(v, n):
    out = np.zeros((n, n), np.float32)
    out[np.tril_indices(n)] = v
    return np.where(np.eye(n, dtype=bool), out, out + out.T)


@pytest.mark.parametrize("P", GROUPS)
@pytest.mark.parametrize("name,kind,shape,block,equal", AR_CASES)
def test_compressed_allreduce_gloo(P, name, kind, shape, block, equal):
    """Every rank gets the oracle's mean bit for bit; equal replicas
    come back within the reference test's atol of the input; symmetric
    leaves exactly symmetric, packed ones packed; each rank's bytes the
    byte model's (or the stated padded count) and its words the
    elements it sent."""
    res = _group(P)
    xs = [_ar_input(name, shape, r, equal) for r in range(P)]
    if kind == "dense":
        want, n = _np_allreduce(xs, block), xs[0].size
    else:
        m = shape[0]
        packed = _np_allreduce([_np_pack(x) for x in xs], block)
        want = packed if kind == "packed" else _np_unpack_sym(packed, m)
        n = tril_size(m)
    for r in res:
        got = r[name]
        assert got["type"] == ("PackedTriangle" if kind == "packed"
                               else "Tensor")
        assert got["dtype"] == "torch.float32"
        assert got["y"].shape == want.shape
        assert np.array_equal(got["y"], want), (name, P)
        if kind == "sym":
            assert np.array_equal(got["y"], got["y"].T)
        if equal:
            x = _np_pack(xs[0]) if kind == "packed" else xs[0]
            tol = np.abs(x).max() / (50 if kind == "dense" else 30)
            np.testing.assert_allclose(got["y"], x, atol=tol)
        nb = _padded_blocks(n, P, block)
        words = nb * (block + 1) * (P - 1) // P
        assert got["words"] == {"all_to_all": words, "all_gather": words}
        wire = 2 * (P - 1) * nb * (block + 4) // P
        assert sum(got["bytes"].values()) == wire
        assert got["bytes"]["all_to_all"] == got["bytes"]["all_gather"]
        if n % (block * P) == 0:
            sym_n = None if kind == "dense" else shape[0]
            assert wire == tc.wire_bytes_per_device(
                int(np.prod(shape)), P, compressed=True, block=block,
                sym_n=sym_n)


@pytest.mark.parametrize("P", GROUPS)
def test_uncompressed_all_reduce_bytes_are_four_a_word(P):
    """``word_counts`` keep their meaning (elements) and ``byte_counts``
    give 4 bytes an f32 element: the byte model's uncompressed count."""
    xs = [_ar_input("dense_aligned", (24, 96), r, False) for r in range(P)]
    want = xs[0].copy()
    for x in xs[1:]:
        want = want + x
    for r in _group(P):
        got = r["all_reduce"]
        np.testing.assert_allclose(got["y"], want, rtol=1e-6, atol=1e-5)
        n = 24 * 96
        assert got["words"] == {"all_reduce": 2 * n * (P - 1) // P}
        assert got["bytes"] == {"all_reduce": 8 * n * (P - 1) // P}
        assert got["bytes"]["all_reduce"] == tc.wire_bytes_per_device(
            n, P, compressed=False)


def test_compressed_allreduce_on_one_rank_is_quantize_twice():
    """A group of one moves nothing and returns the input quantized,
    then requantized (the reference's naxis = 1)."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed.mesh import Comm
    x = torch.from_numpy(_ar_input("dense_ragged", (1000,), 0, False))
    collectives.reset_word_counts()
    y = tc.compressed_allreduce(x, Comm("x", 1, 0, (0,)), block=64)
    assert collectives.byte_counts() == {}
    assert np.array_equal(y.numpy(), _np_allreduce([x.numpy()], 64))


# ---------------------------------------------------------------------------
# the trainer: resume and checkpoints with the EF state
# ---------------------------------------------------------------------------
def _args(**kw):
    from repro_torch.launch import train as ttrain
    args = ttrain.build_argparser().parse_args([])
    for k, v in dict(device="cpu", steps=4, layers=1, d_model=64, d_ff=128,
                     global_batch=4, seq_len=32, loss_chunk=16,
                     log_every=1, compress_grads=True, ckpt_every=2)\
            .items():
        setattr(args, k, v)
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def _run(monkeypatch, **kw):
    """``train`` with its model kept: (summary, model)."""
    from repro_torch.launch import train as ttrain
    made = []
    init = ttrain.init_model

    def keep(cfg, seed, device):
        made.append(init(cfg, seed=seed, device=device))
        return made[-1]

    monkeypatch.setattr(ttrain, "init_model", keep)
    return ttrain.train(_args(**kw)), made[-1]


@pytest.mark.parametrize("optimizer", ["muon", "adamw"])
def test_compressed_train_resume_is_bit_exact(monkeypatch, tmp_path,
                                              optimizer):
    """Two steps, a checkpoint, then a run to step 4 on the same dir
    equal an uninterrupted 4-step run bit for bit: losses, parameters,
    optimizer state and the EF residuals."""
    from repro_torch.distributed import read_manifest, restore_checkpoint
    from repro_torch.distributed.checkpoint import _flatten
    from repro_torch.launch import train as ttrain
    full, m_full = _run(monkeypatch, optimizer=optimizer,
                        ckpt_dir=str(tmp_path / "u"))
    assert full["compress_grads"] and len(full["compress_s"]) == 4
    first, _ = _run(monkeypatch, optimizer=optimizer, steps=2,
                    ckpt_dir=str(tmp_path / "r"))
    assert first["losses"] == full["losses"][:2]
    out, m_res = _run(monkeypatch, optimizer=optimizer,
                      ckpt_dir=str(tmp_path / "r"))
    assert out["resumed"] and out["start_step"] == 2
    assert out["restore_verified"]["mismatches"] == []
    assert out["losses"] == full["losses"][2:]
    for a, b in zip(m_full.parameters(), m_res.parameters()):
        assert torch.equal(a, b)
    params = m_full.stacked()
    like = {"params": params,
            "opt": ttrain.make_optimizer(ttrain.build_config(_args()),
                                         optimizer).init(params),
            "ef": tc.ErrorFeedbackInt8().init(params)}
    _, want = restore_checkpoint(str(tmp_path / "u"), like)
    _, got = restore_checkpoint(str(tmp_path / "r"), like)
    ef = 0
    for (k, a), (_, b) in zip(_flatten(want), _flatten(got)):
        if isinstance(a, int):
            assert a == b, k
        else:
            assert torch.equal(a, b), k
        ef += k.startswith("ef")
    assert ef == len(params)
    assert any(float(e.abs().max()) > 0 for e in want["ef"].error.values())
    keys = read_manifest(str(tmp_path / "r"))["leaves"]
    assert sorted(k for k in keys if k.startswith("ef")) == \
        sorted(k for k, _ in _flatten({"ef": like["ef"]}))


def _smoke(ref):
    """The stablelm smoke config (2 layers, d_model 64) of the port and
    the reference's init as numpy arrays."""
    from repro.configs import get_smoke_config as jcfg
    from repro.models.model import init_params
    from repro_torch.configs import get_smoke_config as tcfg
    over = dict(n_layers=2, d_model=64, d_ff=128)
    cj = dataclasses.replace(jcfg("stablelm-1.6b"), **over)
    ct = dataclasses.replace(tcfg("stablelm-1.6b"), **over)
    params = init_params(cj, ref.jax.random.key(0))
    return ct, ref.jax.tree.map(np.asarray, params)


def _grads(ref, np_params, seed=1):
    """The same f32 gradients as a reference tree and a port dict."""
    tu = ref.jax.tree_util
    rng = np.random.default_rng(seed)
    flat, treedef = tu.tree_flatten_with_path(np_params)
    arrs = [rng.standard_normal(np.shape(v)).astype(np.float32)
            for _, v in flat]
    keys = [tuple(k.key for k in path) for path, _ in flat]
    return (tu.tree_unflatten(treedef, [ref.jnp.asarray(a) for a in arrs]),
            {k: torch.from_numpy(a) for k, a in zip(keys, arrs)})


def _states(ref):
    """Both packages' params, Muon state and EF state after one
    compressed update from the same numbers."""
    from repro.optim import Muon as JMuon
    from repro_torch.models.model import from_jax_params
    from repro_torch.optim.muon import Muon as TMuon
    ct, np_params = _smoke(ref)
    gj, gt = _grads(ref, np_params)
    params_j = ref.jax.tree.map(ref.jnp.asarray, np_params)
    comp_j = ref.comp.ErrorFeedbackInt8()
    dq_j, ef_j = comp_j.compress(gj, comp_j.init(params_j))
    jopt = JMuon()
    pj, oj = jopt.update(dq_j, jopt.init(params_j), params_j)
    model = from_jax_params(np_params, ct, device="cpu")
    params_t = model.stacked()
    comp_t = tc.ErrorFeedbackInt8()
    dq_t, ef_t = comp_t.compress(gt, comp_t.init(params_t))
    topt = TMuon()
    pt, ot = topt.update(dq_t, topt.init(params_t), params_t)
    return ({"params": pj, "opt": oj, "ef": ef_j}, jopt, comp_j,
            {"params": pt, "opt": ot, "ef": ef_t}, topt, comp_t, np_params)


def _bytes(x):
    if isinstance(x, torch.Tensor):
        return (str(x.dtype).removeprefix("torch."), tuple(x.shape),
                x.contiguous().reshape(-1).view(torch.uint8).numpy()
                .tobytes())
    if isinstance(x, int):
        x = np.int32(x)
    a = np.asarray(x)
    return str(a.dtype), a.shape, a.tobytes()


def test_reference_ef_checkpoint_restores_in_the_port(ref, tmp_path):
    from repro.distributed import save_checkpoint as j_save
    from repro.distributed.checkpoint import _flatten as j_flatten
    from repro_torch.distributed import (read_manifest, restore_checkpoint,
                                         verify_restored)
    from repro_torch.distributed.checkpoint import _flatten
    jtree, _, _, ttree, topt, comp_t, _ = _states(ref)
    d = str(tmp_path)
    j_save(d, 3, jtree)
    like = {"params": ttree["params"], "opt": topt.init(ttree["params"]),
            "ef": comp_t.init(ttree["params"])}
    assert {k for k, _ in _flatten(like)} == set(read_manifest(d)["leaves"])
    step, back = restore_checkpoint(d, like)
    assert step == 3 and isinstance(back["ef"], tc.EFState)
    live = dict(j_flatten(jtree))
    got = _flatten(back)
    assert [k for k, _ in got] == list(live)
    for k, v in got:
        assert _bytes(v) == _bytes(live[k]), k
    assert verify_restored(d, back)["mismatches"] == []
    # the port's own EF state is the reference's, bit for bit
    for k, v in _flatten({"ef": ttree["ef"]}):
        assert _bytes(v) == _bytes(live[k]), k


def test_port_ef_checkpoint_restores_in_the_reference(ref, tmp_path):
    from repro.distributed import restore_checkpoint as j_restore
    from repro.distributed import verify_restored as j_verify
    from repro.distributed.checkpoint import _flatten as j_flatten
    from repro_torch.distributed import read_manifest, save_checkpoint
    from repro_torch.distributed.checkpoint import _flatten
    _, jopt, comp_j, ttree, _, _, np_params = _states(ref)
    d = str(tmp_path)
    save_checkpoint(d, 4, ttree)
    shape = ref.jax.eval_shape(
        lambda: ref.jax.tree.map(ref.jnp.asarray, np_params))
    step, back = j_restore(d, {"params": shape,
                               "opt": ref.jax.eval_shape(jopt.init, shape),
                               "ef": ref.jax.eval_shape(comp_j.init,
                                                        shape)})
    assert step == 4
    vr = j_verify(d, back, step=step)
    assert vr["mismatches"] == [] and \
        vr["checked"] == len(read_manifest(d)["leaves"])
    got = dict(j_flatten(back))
    for k, v in _flatten(ttree):
        assert _bytes(got[k]) == _bytes(v), k
