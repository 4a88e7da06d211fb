"""Training jamba in the port against the JAX package, on the CPU.

Oracles, on the same numpy inputs from a seed:

- the capacity form's experts (``moe.CapacityExperts``) against
  ``jax.vjp`` of the reference's ``_grouped_mm_capacity`` (its
  ``_grouped_core`` custom VJP), with a capacity of 8 rows that drops
  the overflow of two of the four experts: the (E·cap, d) windows and
  the gradients of xs, wi, wg and wo from one cotangent on them.  f32:
  ``F32_RTOL`` of each result's largest entry; bf16: ``ULPS`` bf16 ulps
  of it (test_torch_jamba.py's block bound).  A dropped row's gradient
  is 0 on both sides, exactly;
- the dropless gather form's backward against ``jax.grad`` of
  ``moe_apply(impl="gather")`` at the published top-2 routing,
  teacher-forced: the cotangent is 0 on the tokens whose reference gate
  margin is under ``TIE_MARGIN`` (a one-ulp input difference may route
  them elsewhere, test_torch_jamba.py), so that no gradient reads them;
  the gradients of x, the router, wi, wg and wo within ``LEAF_RTOL`` of
  each leaf's largest entry (the bf16 rule of tests/test_torch_train.py:
  the reference's gather form sums each expert's token gradients in
  bf16, the port in one f32-accumulated product);
- ``mamba_mixer``'s gradients (the causal conv's bf16 adds, softplus,
  the scan) on both scan paths, the sequential at s = 32 and the chunked
  at s = 128, against ``jax.grad`` of the reference's ``mamba_mixer``,
  and the scans' own gradients: in f32, ``F32_RTOL`` of each leaf's
  largest entry (test_torch_jamba.py's 2e-4 scan bound); in bf16, the
  mixer's within ``LEAF_RTOL``;
- the remat policies: ``lm_loss``'s gradients under "names" bit-equal to
  "full", "dots" and no remat at all, on the gather and the capacity
  forms (the routing reruns in the recompute and its host-read group
  sizes must give the tensors the first pass saved); "names" keeps the
  tagged scan outputs (the tag runs once, not again in the recompute);
- Muon on a (1, 4, 64, 128) expert stack (and its (1, 4, 128, 64) ``wo``
  form) against the reference's ``Muon.update``, 3 steps: the
  parameters within tests/test_torch_optim.py's NS bound, the momentum
  within its AdamW bound;
- ``train --device cpu --arch jamba-v0.1-52b`` against the reference's
  jitted train step for 3 steps, losses at ``rtol=2e-3`` a step
  (tests/test_torch_train.py's bound), with AdamW and ``muon-syrk``, on
  the smoke config with every expert routed (top_k = n_experts: no
  routing discontinuity), at 4 × 32 tokens (the gather form) and at 4 ×
  128 (the capacity form and the chunked scan);
- the refusal: ``--devices 4 --max-model 4`` would cut the smoke config's
  2 KV heads and raises ``ValueError`` before any weight is drawn (jamba
  on a mesh: tests/test_torch_jamba_mesh.py; deepseek's refusal:
  tests/test_torch_deepseek.py).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_smoke_config as j_smoke
from repro.data import DataConfig as JData
from repro.data import make_train_iterator as j_iter
from repro.launch.steps import make_optimizer as j_make_opt
from repro.launch.steps import make_train_step as j_make_step
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models.common import MoECfg as JMoECfg
from repro.models.model import init_params
from repro.optim import Muon as JMuon
from repro_torch.configs import get_smoke_config
from repro_torch.launch import train as ttrain
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models.common import SCAN_OUT
from repro_torch.models.common import MoECfg
from repro_torch.models.model import from_jax_params, lm_loss
from repro_torch.optim.muon import Muon as TMuon
from test_torch_hygiene import limit_torch_threads  # noqa: F401

ARCH = "jamba-v0.1-52b"
STEPS = 3
LOSS_RTOL = 2e-3
F32_RTOL = 2e-4
ULPS = 4
LEAF_RTOL = 3e-2
TIE_MARGIN = 1e-2
CPU = torch.device("cpu")


def _np(a):
    return np.array(a, np.float32)


def _t(a, dtype=torch.bfloat16):
    return torch.from_numpy(_np(a)).to(dtype)


def _close(got, want, what, rtol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    tol = rtol * float(np.abs(want).max())
    print(f"{what}: max_abs_err {err:.3g}, bound {tol:.3g}")
    assert err <= tol, f"{what}: max_abs_err {err:.4g} > {tol:.4g}"


def _all_experts(cfg, moe_cls):
    return dataclasses.replace(cfg, moe=moe_cls(
        cfg.moe.n_experts, cfg.moe.n_experts, cfg.moe.n_shared,
        cfg.moe.d_ff_expert))


# ---------------------------------------------------------------------------
# the capacity form's custom backward
# ---------------------------------------------------------------------------
#: group sizes of the 4 experts: the first and third overflow cap = 8
SIZES, CAP, D, F = (13, 5, 11, 0), 8, 16, 24


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_capacity_vjp_matches_reference(dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(3)
    e, n = len(SIZES), sum(SIZES)
    xs, wi, wg = (rng.standard_normal(s).astype(np.float32) * 0.5
                  for s in ((n, D), (e, D, F), (e, D, F)))
    wo = rng.standard_normal((e, F, D)).astype(np.float32) * 0.5
    dy = rng.standard_normal((e * CAP, D)).astype(np.float32)
    gs = jnp.asarray(SIZES, jnp.int32)
    ins = [jnp.asarray(a, jdt) for a in (xs, wi, wg, wo)]

    def ref(xs, wi, wg, wo):
        return jmoe._grouped_mm_capacity(xs, wi, wg, wo, gs, "silu",
                                         CAP)[0]
    want, pull = jax.vjp(ref, *ins)
    want_g = pull(jnp.asarray(dy))
    offsets = [sum(SIZES[:i]) for i in range(e)]
    tin = [_t(a, tdt).requires_grad_() for a in ins]
    out = tmoe.CapacityExperts.apply(*tin, offsets, list(SIZES), CAP,
                                     "silu")
    assert out.shape == (e * CAP + 1, D) and out.dtype == torch.float32
    assert not out[-1].any()                   # the dropped pairs' row
    out[:-1].backward(torch.from_numpy(dy))
    rtol = F32_RTOL if dtype == "float32" else ULPS * 2.0 ** -8
    _close(out[:-1].detach(), want, "windows", rtol)
    for name, t, w in zip(("xs", "wi", "wg", "wo"), tin, want_g):
        assert t.grad.dtype == tdt, name
        _close(t.grad.float(), w, f"d{name}", rtol)
    # a row past its expert's window is dropped: 0 on both sides
    dropped = np.concatenate([np.arange(o + CAP, o + s) for o, s in
                              zip(offsets, SIZES) if s > CAP])
    assert dropped.size == 8
    assert not tin[0].grad[dropped].any()
    assert not np.asarray(want_g[0], np.float32)[dropped].any()


def test_capacity_backward_keeps_no_window_stack():
    """The Function saves its inputs only: no (E, cap, d) tensor and no
    expert output among the saved tensors."""
    e, n = len(SIZES), sum(SIZES)
    g = torch.Generator().manual_seed(0)
    ins = [torch.randn(s, generator=g).requires_grad_() for s in
           ((n, D), (e, D, F), (e, D, F), (e, F, D))]
    out = tmoe.CapacityExperts.apply(*ins, [0, 13, 18, 29], list(SIZES),
                                     CAP, "silu")
    saved = out.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in saved] == [tuple(t.shape) for t in ins]


# ---------------------------------------------------------------------------
# the dropless gather form under autograd
# ---------------------------------------------------------------------------
def test_gather_backward_matches_reference_teacher_forced():
    jcfg, cfg = j_smoke(ARCH), get_smoke_config(ARCH)
    jp = jmoe.moe_params(jcfg, jax.random.key(2))
    m = tmoe.MoE(cfg, torch.Generator(), CPU)
    for k, v in jp.items():
        getattr(m, k).data.copy_(_t(v, getattr(m, k).dtype))
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.standard_normal((2, 32, 64)), jnp.bfloat16)
    gates = jax.nn.softmax(x.reshape(64, 64).astype(jnp.float32)
                           @ jp["router"], axis=-1)
    top = jnp.sort(gates, axis=-1)[:, ::-1]
    near = np.array(top[:, 1] - top[:, 2] < TIE_MARGIN)
    assert 0 < near.sum() < 16              # some left out, most kept
    g = rng.standard_normal((64, 64)).astype(np.float32)
    g[near] = 0.0
    g = g.reshape(2, 32, 64)

    def f(p, x):
        y = jmoe.moe_apply(jcfg, p, x, impl="gather")
        return jnp.sum(y.astype(jnp.float32) * g)
    want = jax.jit(jax.grad(f, argnums=(0, 1)))(jp, x)
    tx = _t(x).requires_grad_()
    y = m(tx, impl="gather")
    assert y.dtype == torch.bfloat16
    (y.float() * torch.from_numpy(g)).sum().backward()
    _close(tx.grad.float(), want[1], "dx", LEAF_RTOL)
    assert not tx.grad.reshape(64, 64)[torch.from_numpy(near)].any()
    for k in ("router", "wi", "wg", "wo"):
        got = getattr(m, k).grad
        assert got.dtype == getattr(m, k).dtype, k
        _close(got.float(), want[0][k], f"d{k}", LEAF_RTOL)


# ---------------------------------------------------------------------------
# the Mamba backward
# ---------------------------------------------------------------------------
def _scan_inputs(b, s, di=24, ds=8, seed=0):
    r = np.random.default_rng(seed)
    u = r.standard_normal((b, s, di)).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((b, s, di)))).astype(np.float32)
    A = -np.broadcast_to(np.arange(1, ds + 1, dtype=np.float32),
                         (di, ds)).copy()
    B, C = (r.standard_normal((b, s, ds)).astype(np.float32)
            for _ in range(2))
    D = r.standard_normal(di).astype(np.float32)
    h0 = r.standard_normal((b, di, ds)).astype(np.float32)
    gy = r.standard_normal((b, s, di)).astype(np.float32)
    gh = r.standard_normal((b, di, ds)).astype(np.float32)
    return (u, dt, A, B, C, D, h0), gy, gh


@pytest.mark.parametrize("s", [32, 128])
def test_selective_scan_gradients_match_jax_grad(s):
    """s = 32: the sequential scan; 128: two chunks of the chunked one,
    whose associative scans differentiate through their slices."""
    args, gy, gh = _scan_inputs(2, s, seed=s)

    def f(*a):
        y, h = jssm._selective_scan(*a)
        return jnp.sum(y * gy) + jnp.sum(h * gh)
    want = jax.jit(jax.grad(f, argnums=tuple(range(7))))(
        *map(jnp.asarray, args))
    tin = [torch.from_numpy(a.copy()).requires_grad_() for a in args]
    y, h = tssm._selective_scan(*tin)
    ((y * torch.from_numpy(gy)).sum()
     + (h * torch.from_numpy(gh)).sum()).backward()
    for name, t, w in zip(("u", "dt", "A", "B", "C", "D", "h0"), tin, want):
        _close(t.grad, w, f"d{name}", F32_RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [32, 128])
def test_mamba_mixer_gradients_match_jax_grad(s, dtype):
    jcfg, cfg = j_smoke(ARCH), get_smoke_config(ARCH)
    jp = jssm.mamba_params(jcfg, jax.random.key(1))
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    m = tssm.Mamba(cfg, torch.Generator(), CPU)
    for k, v in jp.items():
        p = getattr(m, k)
        p.data = _t(v, torch.float32 if dtype == "float32" else p.dtype)
    rng = np.random.default_rng(s)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    x = jnp.asarray(rng.standard_normal((2, s, 64)), jdt)
    g = rng.standard_normal((2, s, 64)).astype(np.float32)

    def f(p, x):
        y, _ = jssm.mamba_mixer(jcfg, p, x)
        return jnp.sum(y.astype(jnp.float32) * g)
    want = jax.jit(jax.grad(f, argnums=(0, 1)))(jp, x)
    tx = _t(x, getattr(torch, dtype)).requires_grad_()
    y, _ = tssm.mamba_mixer(cfg, m, tx)
    (y.float() * torch.from_numpy(g)).sum().backward()
    rtol = F32_RTOL if dtype == "float32" else LEAF_RTOL
    _close(tx.grad.float(), want[1], "dx", rtol)
    for k, w in want[0].items():
        _close(getattr(m, k).grad.float(), w, f"d{k}", rtol)


# ---------------------------------------------------------------------------
# the remat policies
# ---------------------------------------------------------------------------
class _CountTag(TorchDispatchMode):
    """How often the ``scan_out`` tag really runs."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func == SCAN_OUT
        return func(*args, **(kwargs or {}))


@functools.lru_cache(maxsize=None)
def _reference(seed=0, every_expert=True):
    """The reference's smoke config (every expert routed) and its init,
    jitted: (config, params, numpy tree)."""
    cj = j_smoke(ARCH)
    if every_expert:
        cj = _all_experts(cj, JMoECfg)
    params = jax.jit(functools.partial(init_params, cj))(jax.random.key(seed))
    return cj, params, jax.tree.map(np.asarray, params)


def _port_cfg(every_expert=True, **over):
    ct = get_smoke_config(ARCH)
    if every_expert:
        ct = _all_experts(ct, MoECfg)
    return dataclasses.replace(ct, **over)


@pytest.mark.parametrize("seq", [32, 128])
def test_names_policy_is_bit_equal_to_full_and_keeps_the_scan_outputs(seq):
    """2 × 32 tokens a layer (the gather form, the sequential scan) and
    2 × 128 (the capacity form, the chunked scan: 2 chunks of 64 a Mamba
    layer), at the published top-2: every gradient under "names" equal
    to "full", "dots" and no remat, bit for bit; the tag runs once a
    chunk under "names" and again in the recompute under "full"."""
    _, _, np_tree = _reference(every_expert=False)
    rng = np.random.default_rng(seq)
    batch = {k: torch.from_numpy(rng.integers(0, 256, (2, seq))).long()
             for k in ("tokens", "labels")}
    grads, tags = {}, {}
    for policy in ("names", "full", "dots", None):
        cfg = _port_cfg(False, remat_policy=policy or "full")
        model = from_jax_params(np_tree, cfg, device="cpu")
        with _CountTag() as mode:
            loss = lm_loss(model, batch, chunk=32, remat=policy is not None)
            loss.backward()
        tags[policy] = mode.n
        grads[policy] = model.stacked(lambda p: p.grad)
    for policy in ("full", "dots", None):
        for k, g in grads["names"].items():
            assert torch.equal(g, grads[policy][k]), (policy, k)
    chunks = 7 * seq // 64 if seq > 64 else 0     # 7 Mamba layers
    assert tags == {"names": chunks, "full": 2 * chunks, "dots": chunks,
                    None: chunks}


# ---------------------------------------------------------------------------
# Muon on the expert stacks
# ---------------------------------------------------------------------------
def test_muon_on_expert_stacks_matches_reference():
    shapes = {"wi": (1, 4, 64, 128), "wo": (1, 4, 128, 64),
              "router": (1, 64, 4)}
    rng = np.random.default_rng(4)
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.02
         for k, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    jo, to = JMuon(lr=0.02, mode="reference"), TMuon(lr=0.02,
                                                     mode="reference")
    js, ts = jo.init(jp), to.init(tp)
    for step in range(3):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
        jp, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                           jp)
        tp, ts = to.update({k: torch.from_numpy(v) for k, v in g.items()},
                           ts, tp)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), _np(jp[k]),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
            np.testing.assert_allclose(ts.momentum[k].numpy(),
                                       _np(js.momentum[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------
def _args(**kw):
    args = ttrain.build_argparser().parse_args([])
    for k, v in dict(device="cpu", arch=ARCH, steps=STEPS, global_batch=4,
                     seq_len=32, loss_chunk=16, log_every=1).items():
        setattr(args, k, v)
    for k, v in kw.items():
        setattr(args, k, v)
    return args


@pytest.mark.parametrize("seq", [32, 128])
@pytest.mark.parametrize("optimizer", ["adamw", "muon-syrk"])
def test_train_cli_follows_reference_losses(monkeypatch, optimizer, seq):
    args = _args(optimizer=optimizer, seq_len=seq)
    cj, params, np_tree = _reference(args.seed)
    build = ttrain.build_config
    monkeypatch.setattr(ttrain, "build_config", lambda a: _all_experts(
        build(a), MoECfg))
    monkeypatch.setattr(ttrain, "init_model", lambda cfg, seed, device:
                        from_jax_params(np_tree, cfg, device=device))
    assert dataclasses.asdict(ttrain.build_config(args)) == \
        dataclasses.asdict(_port_cfg())
    out = ttrain.train(args)
    opt = j_make_opt(cj, "muon" if optimizer.startswith("muon")
                     else optimizer, lr=args.lr)
    step = jax.jit(j_make_step(cj, opt, loss_chunk=args.loss_chunk))
    state = opt.init(params)
    it = j_iter(JData(seq_len=args.seq_len, global_batch=args.global_batch,
                      vocab_size=cj.vocab, seed=args.data_seed))
    want = []
    try:
        for _ in range(STEPS):
            params, state, metrics = step(params, state, next(it))
            want.append(float(metrics["loss"]))
    finally:
        it.close()
    assert out["arch"] == "jamba-v0.1-52b-smoke" and out["steps"] == STEPS
    assert all(np.isfinite(out["losses"]))
    np.testing.assert_allclose(out["losses"], want, rtol=LOSS_RTOL)
    assert out["losses"][-1] < out["losses"][0]
    assert out["params"] == sum(int(np.prod(x.shape))
                                for x in jax.tree.leaves(params))
    assert set(out["kernel_launches"].values()) == {0}   # the CPU
    if optimizer.startswith("muon"):
        # every expert stack, the router and the Mamba projections are
        # Muon matrices: one NS call a stack (a (1, 4, 64, 128) SYRK)
        syrk = {(r[1], r[2], r[4]) for r in out["routes"] if r[0] == "syrk"}
        assert (64, 128, True) in syrk, out["routes"]


def test_mesh_refuses_before_drawing_weights(monkeypatch):
    """jamba trains on a mesh (tests/test_torch_jamba_mesh.py), but a
    model axis of 4 would cut the smoke config's 2 KV heads: ``--devices
    4 --max-model 4`` raises ``ValueError`` before any rank starts or
    any weight is drawn."""
    def no_init(*a, **kw):
        raise AssertionError("weights drawn before the refusal")
    monkeypatch.setattr(ttrain, "init_model", no_init)
    monkeypatch.setattr(ttrain, "run_ranks", no_init)
    with pytest.raises(ValueError, match="n_kv_heads=2") as e:
        ttrain.train(_args(devices=4, max_model=4, steps=1))
    assert "--max-model" in str(e.value)
