"""xlstm training in the port against the JAX package, on the CPU.

Oracles, on the same numpy inputs from a seed:

- the sLSTM scan's gradient: autograd of the plain scan
  (``kernels.slstm._slstm_scan_plain``), the plain version of the
  backward kernel (``slstm_scan_bwd`` on CPU tensors) and the autograd
  operator ``SlstmScan`` against ``jax.grad`` of the reference's
  ``_slstm_seq``, f32, with ties forced where they occur in training
  (f == i at t = 0 against m0 = 0; n_t = 1 exactly): within 2e-5,
  relative and absolute (the reference kernel test's y tolerance);
- the running maximum of the chunkwise mLSTM (``ssm._cummax``) against
  ``lax.cummax``'s gradient at ties, exactly;
- the sLSTM and mLSTM mixers' gradients (bf16 weights and input) against
  ``jax.grad`` of the reference's mixers at s = 32 and s = 256 (the
  reference's ``_slstm_parallel`` for s > 8, its chunkwise mLSTM at
  256): ``max |Δ| <= 3e-2 · max |g|`` a leaf, the rule of
  ``tests/test_torch_train.py`` (a few bf16 ulps of the largest entry);
- ``lm_loss`` and its gradient at the xlstm smoke config against
  ``jax.value_and_grad(lm_loss)``: at s = 32 with the bf16 weights
  under that rule, the loss at 2e-4; at s = 256 (the chunkwise mLSTM,
  the scan over 256 steps) with the weights in f32 on both sides, each
  leaf within 1e-4 · max |g| (measured 4.5e-6).  In bf16 at s = 256 the
  two frameworks' gradients sit 10-30 % of a leaf's largest entry from
  the f32 gradient, each as far as the other, so no bf16 bound there
  tells the algorithm apart from rounding;
- 3 steps of ``train --arch xlstm-350m --smoke`` (AdamW, Muon; and with
  4 heads, where the mLSTM's ``wif`` stack is a Muon matrix) against the
  reference's single-device train step from the same init, losses at
  ``rtol=2e-3`` a step;
- a resume after ``--fail-at`` bit for bit, and the refusal of a model
  axis that would cut a head (``--devices 4 --max-model 4`` at 2 heads).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import tree_flatten_with_path

from repro.configs import get_smoke_config as jcfg
from repro.data import DataConfig as JData
from repro.data import make_train_iterator as j_iter
from repro.models import ssm as jssm
from repro.models.common import ArchConfig as JArchConfig
from repro.models.model import init_params
from repro.models.model import lm_loss as j_loss
from repro_torch.configs import get_smoke_config as tcfg
from repro_torch.kernels import counts
from repro_torch.kernels import slstm as tslstm
from repro_torch.launch import train as ttrain
from repro_torch.models import ssm
from repro_torch.models.common import ArchConfig
from repro_torch.models.model import from_jax_params
from repro_torch.models.model import lm_loss as t_loss
from test_torch_hygiene import limit_torch_threads  # noqa: F401

GRAD_TOL = dict(rtol=2e-5, atol=2e-5)
LEAF_RTOL = 3e-2
ARCH = "xlstm-350m"


def _close_leaf(got, want, key):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got.float()) - want).max()
    assert err <= LEAF_RTOL * np.abs(want).max(), (key, err)


# ---------------------------------------------------------------------------
# the scan's gradient
# ---------------------------------------------------------------------------
def _scan_inputs(case, b=2, s=40, d=16, seed=0):
    """(pre (B, S, d, 4), c0, n0, m0, gy, final-state cotangents), f32.
    "ties": f == i at t = 0 on every other channel (m0 = 0, so the
    stabiliser compares the two); "n1": input gates of -30 for the first
    steps from n0 = 1, so n_t stays 1 exactly; "warm": a carried
    state."""
    r = np.random.default_rng(seed)
    pre = (r.standard_normal((b, s, d, 4))
           * np.array([1.0, 2.5, 2.5, 1.0])).astype(np.float32)
    c0, n0, m0 = (np.zeros((b, d), np.float32), np.ones((b, d), np.float32),
                  np.zeros((b, d), np.float32))
    if case == "ties":
        pre[:, 0, ::2, 2] = pre[:, 0, ::2, 1]
    elif case == "n1":
        pre[:, :6, :, 1] = -30.0
        pre[:, :6, :, 2] = np.abs(pre[:, :6, :, 2])
    else:
        c0 = r.standard_normal((b, d)).astype(np.float32)
        n0 = (1.0 + np.abs(r.standard_normal((b, d)))).astype(np.float32)
        m0 = r.standard_normal((b, d)).astype(np.float32)
    gy = r.standard_normal((b, s, d)).astype(np.float32)
    fin = [r.standard_normal((b, d)).astype(np.float32) for _ in range(3)]
    return pre, c0, n0, m0, gy, fin


def _jax_scan_grads(pre, c0, n0, m0, gy, fin):
    def f(pre, c0, n0, m0):
        y, st = jssm._slstm_seq(pre[..., 0], pre[..., 1], pre[..., 2],
                                pre[..., 3], {"c": c0, "n": n0, "m": m0})
        return (y * gy).sum() + sum((st[k] * g).sum()
                                    for k, g in zip("cnm", fin))
    grad = jax.jit(jax.grad(f, argnums=(0, 1, 2, 3)))
    return [np.asarray(g) for g in grad(*map(jnp.asarray,
                                             (pre, c0, n0, m0)))]


def _loss(y, c, n, m, gy, fin):
    return (y * torch.tensor(gy)).sum() + sum(
        (x * torch.tensor(g)).sum() for x, g in zip((c, n, m), fin))


@pytest.mark.parametrize("case", ["ties", "n1", "warm"])
def test_scan_gradients_match_jax_grad_of_slstm_seq(case):
    pre, c0, n0, m0, gy, fin = _scan_inputs(case)
    want = _jax_scan_grads(pre, c0, n0, m0, gy, fin)
    if case == "ties":                       # the tie really is one
        assert (pre[:, 0, ::2, 2] == pre[:, 0, ::2, 1]).all()
    if case == "n1":                         # n_t = 1 on the first steps
        _, _, _, _, st = tslstm._slstm_scan_plain(
            *torch.tensor(pre).unbind(-1),
            *map(torch.tensor, (c0, n0, m0)), stash=True)
        assert bool((st[1][:, :6] == 1.0).all())

    # autograd of the plain scan
    leaves = [torch.tensor(x, requires_grad=True) for x in (pre, c0, n0, m0)]
    _loss(*tslstm._slstm_scan_plain(*leaves[0].unbind(-1), *leaves[1:]),
          gy, fin).backward()
    # the autograd operator (forward with stash, plain backward on the CPU)
    op = [torch.tensor(x, requires_grad=True) for x in (pre, c0, n0, m0)]
    _loss(*tslstm.SlstmScan.apply(*op), gy, fin).backward()
    # the backward kernel's plain version, called as the operator calls it
    y, c, n, m, st = tslstm.slstm_scan(
        *torch.tensor(pre).unbind(-1), *map(torch.tensor, (c0, n0, m0)),
        stash=True)
    bwd = tslstm.slstm_scan_bwd(torch.tensor(pre), st,
                                *map(torch.tensor, (c0, n0, m0)),
                                torch.tensor(gy), *map(torch.tensor, fin))
    for got in ([x.grad for x in leaves], [x.grad for x in op], bwd):
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL)


def test_scan_stash_holds_every_step_and_keeps_y():
    pre, c0, n0, m0, _, _ = _scan_inputs("warm", s=13)
    gates = torch.tensor(pre).unbind(-1)
    state = list(map(torch.tensor, (c0, n0, m0)))
    plain = tslstm.slstm_scan(*gates, *state)
    y, c, n, m, st = tslstm.slstm_scan(*gates, *state, stash=True)
    for a, b in zip(plain, (y, c, n, m)):
        assert torch.equal(a, b)
    assert st.shape == (3, 2, 13, 16) and st.dtype == torch.float32
    for k, last in enumerate((c, n, m)):
        assert torch.equal(st[k][:, -1], last)
    y2, *_ = tslstm.slstm_scan(*(g[:, :5] for g in gates), *state)
    assert torch.equal(y2, y[:, :5])


def test_scan_bf16_quads_take_a_bf16_gradient():
    """bf16 gates: the operator upcasts in its forward, and d(pre) is the
    f32 gradient rounded once to bf16."""
    pre, c0, n0, m0, gy, fin = _scan_inputs("ties", seed=3)
    pre_bf = torch.tensor(pre).to(torch.bfloat16)
    want = _jax_scan_grads(pre_bf.float().numpy(), c0, n0, m0, gy, fin)
    leaf = pre_bf.clone().requires_grad_(True)
    _loss(*tslstm.SlstmScan.apply(leaf, *map(torch.tensor, (c0, n0, m0))),
          gy, fin).backward()
    assert leaf.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(
        leaf.grad.float().numpy(),
        torch.tensor(want[0]).to(torch.bfloat16).float().numpy(),
        rtol=2.0 ** -7, atol=2e-5)


def test_scan_bwd_checks_its_operands():
    pre, c0, n0, m0, gy, _ = map(
        lambda x: torch.tensor(x) if isinstance(x, np.ndarray) else x,
        _scan_inputs("warm", s=4))
    st = torch.zeros(3, 2, 4, 16)
    with pytest.raises(ValueError):
        tslstm.slstm_scan_bwd(pre[..., :3], st, c0, n0, m0, gy)
    with pytest.raises(ValueError):
        tslstm.slstm_scan_bwd(pre, st[:, :, :3], c0, n0, m0, gy)
    with pytest.raises(TypeError):
        tslstm.slstm_scan_bwd(pre, st, c0, n0, m0, gy.double())
    with pytest.raises(RuntimeError):               # no kernel, no fallback
        tslstm._kernel_device(types.SimpleNamespace(device=torch.device("xpu")))
    # meta (the dry run): a shape function, never the plain version
    plain = tslstm._slstm_scan_bwd_plain
    tslstm._slstm_scan_bwd_plain = None
    try:
        out = tslstm.slstm_scan_bwd(pre.to("meta"), st.to("meta"),
                                    c0.to("meta"), n0.to("meta"),
                                    m0.to("meta"), gy.to("meta"))
    finally:
        tslstm._slstm_scan_bwd_plain = plain
    assert [(o.device.type, tuple(o.shape)) for o in out] == \
        [("meta", tuple(pre.shape))] + [("meta", tuple(c0.shape))] * 3
    with pytest.raises(ValueError):           # the stash needs the quads
        tslstm.slstm_scan(*(g.contiguous() for g in pre.unbind(-1)),
                          c0, n0, m0, stash=True)


def test_cpu_training_launches_no_kernel():
    pre, c0, n0, m0, gy, fin = _scan_inputs("warm", s=5)
    counts.reset_launch_counts()
    leaf = torch.tensor(pre, requires_grad=True)
    _loss(*tslstm.SlstmScan.apply(leaf, *map(torch.tensor, (c0, n0, m0))),
          gy, fin).backward()
    assert counts.launch_counts() == {"rank_update": 0, "sym_stream": 0,
                                      "slstm_scan": 0, "slstm_scan_bwd": 0}


# ---------------------------------------------------------------------------
# the chunkwise mLSTM's running maximum
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 2, 3, 8, 9, 128])
def test_cummax_gradient_splits_ties_as_jax(n):
    r = np.random.default_rng(n)
    a = np.round(r.standard_normal((2, n, 3)) * 1.5).astype(np.float32)
    w = r.standard_normal((2, n, 3)).astype(np.float32)
    x = torch.tensor(a, requires_grad=True)
    y = ssm._cummax(x, dim=1)
    assert torch.equal(y, torch.cummax(x, dim=1).values)
    (y * torch.tensor(w)).sum().backward()
    want = jax.jit(jax.grad(
        lambda t: (jax.lax.cummax(t, axis=1) * w).sum()))(jnp.asarray(a))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))
    if n >= 8:                      # ties here, where torch.cummax differs
        x2 = torch.tensor(a, requires_grad=True)
        (torch.cummax(x2, dim=1).values * torch.tensor(w)).sum().backward()
        assert not np.array_equal(x2.grad.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the mixers' gradients
# ---------------------------------------------------------------------------
D_MODEL, B = 64, 2


def _mixer_cfgs(heads):
    kw = dict(name="mixer", n_layers=1, d_model=D_MODEL, n_heads=heads,
              n_kv_heads=heads, d_ff=0, vocab=16)
    return JArchConfig(**kw), ArchConfig(**kw)


class _P(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        for k, v in params.items():
            setattr(self, k, torch.nn.Parameter(torch.tensor(
                np.asarray(v, np.float32)).to(torch.bfloat16)))


@pytest.mark.parametrize("kind,s,heads", [("slstm", 32, 2),
                                          ("slstm", 256, 2),
                                          ("mlstm", 32, 2),
                                          ("mlstm", 256, 4)])
def test_mixer_gradients_match_jax_grad(kind, s, heads):
    jc, tc = _mixer_cfgs(heads)
    init = jssm.mlstm_params if kind == "mlstm" else jssm.slstm_params
    params = init(jc, jax.random.key(s))
    r = np.random.default_rng(s + heads)
    x = r.standard_normal((B, s, D_MODEL)).astype(np.float32)
    w = r.standard_normal((B, s, D_MODEL)).astype(np.float32)
    jmix = jssm.mlstm_mixer if kind == "mlstm" else jssm.slstm_mixer
    tmix = ssm.mlstm_mixer if kind == "mlstm" else ssm.slstm_mixer

    def jf(p, xb):
        out, _ = jmix(jc, p, xb)
        return (out.astype(jnp.float32) * w).sum()
    xj = jnp.asarray(x, jnp.bfloat16)
    gp, gx = jax.jit(jax.grad(jf, argnums=(0, 1)))(
        jax.tree.map(lambda a: a.astype(jnp.bfloat16), params), xj)
    p = _P(params)
    xt = torch.tensor(x).to(torch.bfloat16).requires_grad_(True)
    out, _ = tmix(tc, p, xt)
    (out.float() * torch.tensor(w)).sum().backward()
    for k in params:
        assert getattr(p, k).grad.dtype == torch.bfloat16
        _close_leaf(getattr(p, k).grad, gp[k], k)
    _close_leaf(xt.grad, gx, "x")


def test_mixer_trains_through_the_operator_and_serves_through_the_scan(
        monkeypatch):
    """With a gradient to take the sLSTM mixer calls ``SlstmScan`` on the
    whole pre-activation; without one (serving) ``slstm_scan`` on its
    four views, as before."""
    jc, tc = _mixer_cfgs(2)
    p = _P(jssm.slstm_params(jc, jax.random.key(0)))
    x = torch.tensor(np.random.default_rng(0).standard_normal(
        (B, 12, D_MODEL)).astype(np.float32)).to(torch.bfloat16)
    calls = []
    real_scan, real_op = ssm.slstm_scan, ssm.SlstmScan

    class Op:
        @staticmethod
        def apply(pre, *state):
            calls.append(("op", tuple(pre.shape), pre.dtype))
            return real_op.apply(pre, *state)

    def scan(*args, **kw):
        calls.append(("scan", len(args), kw))
        return real_scan(*args, **kw)
    monkeypatch.setattr(ssm, "SlstmScan", Op)
    monkeypatch.setattr(ssm, "slstm_scan", scan)
    out, _ = ssm.slstm_mixer(tc, p, x)
    out.float().sum().backward()
    with torch.no_grad():
        again, _ = ssm.slstm_mixer(tc, p, x)
    assert calls == [("op", (B, 12, D_MODEL, 4), torch.bfloat16),
                     ("scan", 7, {})]
    assert torch.equal(out, again)


# ---------------------------------------------------------------------------
# lm_loss at the smoke config
# ---------------------------------------------------------------------------
def _setup(seed=0, **over):
    cj = dataclasses.replace(jcfg(ARCH), **over)
    ct = dataclasses.replace(tcfg(ARCH), **over)
    params = init_params(cj, jax.random.key(seed))
    return cj, ct, params, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("s,dtype", [(32, "bfloat16"), (256, "float32")])
def test_lm_loss_and_grad_match_reference(s, dtype):
    cj, ct, params, np_tree = _setup()
    if dtype == "float32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    r = np.random.default_rng(s)
    toks = r.integers(0, ct.vocab, (2, s)).astype(np.int32)
    labs = r.integers(0, ct.vocab, (2, s)).astype(np.int32)
    labs[0, :3] = -1
    lj, gj = jax.jit(jax.value_and_grad(lambda p: j_loss(
        cj, p, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)},
        chunk=128)))(params)
    model = from_jax_params(np_tree, ct, device="cpu")
    if dtype == "float32":
        model = model.float()
    lt = t_loss(model, {"tokens": torch.from_numpy(toks).long(),
                        "labels": torch.from_numpy(labs).long()}, chunk=128)
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), rtol=2e-4)
    flat, _ = tree_flatten_with_path(gj)
    tree = model.stacked(lambda p: p.grad)
    assert [tuple(k.key for k in path) for path, _ in flat] == list(tree)
    for (_, g), (key, got) in zip(flat, tree.items()):
        assert str(got.dtype) == f"torch.{g.dtype}", key
        assert got.shape == g.shape, key
        if dtype == "bfloat16":
            _close_leaf(got, g, key)
        else:
            want = np.asarray(g)
            err = np.abs(got.numpy() - want).max()
            assert err <= 1e-4 * np.abs(want).max(), (key, err)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------
def _args(**kw):
    args = ttrain.build_argparser().parse_args([])
    for k, v in dict(device="cpu", arch=ARCH, steps=3, global_batch=4,
                     seq_len=32, loss_chunk=16, log_every=1).items():
        setattr(args, k, v)
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def _follow_reference(monkeypatch, optimizer, **over):
    """``train --arch xlstm-350m --smoke`` on the CPU from the reference's
    init (config overrides ``over`` on both), and the reference's jitted
    train step on the same data with the same optimizer: (the port's
    summary, the reference's losses)."""
    from repro.launch.steps import make_optimizer as j_make_opt
    from repro.launch.steps import make_train_step as j_make_step
    args = _args(optimizer=optimizer)
    cj, ct, params, np_tree = _setup(seed=args.seed, **over)
    build = ttrain.build_config
    monkeypatch.setattr(ttrain, "build_config", lambda a: dataclasses.replace(
        build(a), **over))
    monkeypatch.setattr(ttrain, "init_model", lambda cfg, seed, device:
                        from_jax_params(np_tree, cfg, device=device))
    assert dataclasses.asdict(ttrain.build_config(args)) == \
        dataclasses.asdict(ct)
    out = ttrain.train(args)
    # on one device the reference's "muon" runs muon-syrk's chain
    opt = j_make_opt(cj, "muon" if optimizer.startswith("muon")
                     else optimizer, lr=args.lr)
    step = jax.jit(j_make_step(cj, opt, loss_chunk=args.loss_chunk))
    state = opt.init(params)
    it = j_iter(JData(seq_len=args.seq_len, global_batch=args.global_batch,
                      vocab_size=cj.vocab, seed=args.data_seed))
    want = []
    try:
        for _ in range(args.steps):
            params, state, metrics = step(params, state, next(it))
            want.append(float(metrics["loss"]))
    finally:
        it.close()
    return out, want


@pytest.mark.parametrize("optimizer,heads", [("adamw", 2), ("muon-syrk", 2),
                                             ("muon-syrk", 4)])
def test_train_cli_follows_reference_losses(monkeypatch, optimizer, heads):
    out, want = _follow_reference(monkeypatch, optimizer, n_heads=heads,
                                  n_kv_heads=heads)
    assert out["arch"] == "xlstm-350m-smoke" and out["device"] == "cpu"
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    np.testing.assert_allclose(out["losses"], want, rtol=2e-3)
    assert out["losses"][-1] < out["losses"][0]
    assert out["kernel_launches"] == {"rank_update": 0, "sym_stream": 0,
                                      "slstm_scan": 0, "slstm_scan_bwd": 0}
    if optimizer.startswith("muon"):
        # 4 heads: the mLSTM's wif stack (1, 64, 8) is a Muon matrix
        wif = [r for r in out["routes"] if r[0] == "syrk" and r[1] == 8]
        assert bool(wif) == (heads == 4), out["routes"]


def test_train_resume_after_fail_at_is_bit_exact(monkeypatch, tmp_path):
    """A run killed by ``--fail-at 3`` after its step-2 checkpoint, then
    resumed, equals an uninterrupted 4-step run bit for bit (losses and
    parameters); the Grams ride along in the checkpoint."""
    made = []
    init = ttrain.init_model

    def keep(cfg, seed, device):
        made.append(init(cfg, seed=seed, device=device))
        return made[-1]
    monkeypatch.setattr(ttrain, "init_model", keep)
    kw = dict(optimizer="muon-syrk", track_gram=True, steps=4, ckpt_every=2)
    full = ttrain.train(_args(ckpt_dir=str(tmp_path / "u"), **kw))
    d = str(tmp_path / "r")
    with pytest.raises(ttrain.InjectedFailure):
        ttrain.train(_args(ckpt_dir=d, fail_at=3, **kw))
    out = ttrain.train(_args(ckpt_dir=d, **kw))
    assert out["resumed"] and out["start_step"] == 2
    assert out["restore_verified"]["mismatches"] == []
    assert out["losses"] == full["losses"][2:]
    for a, b in zip(made[0].parameters(), made[-1].parameters()):
        assert torch.equal(a, b)


def test_train_xlstm_on_a_mesh_raises_a9b():
    """xlstm trains on a mesh (``tests/test_torch_xlstm_mesh.py``); what
    still raises is a model axis that would cut a head: the smoke
    config's 2 heads over model=4."""
    with pytest.raises(ValueError, match="n_heads=2 does not split"):
        ttrain.train(_args(devices=4, max_model=4))
