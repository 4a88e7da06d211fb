"""Training deepseek in the port against the JAX package, on the CPU.

Oracles, on the same numpy inputs from a seed:

- MLA's gradients (the input and every weight, ``q_lora`` set and
  unset) against ``jax.grad`` of the reference's ``mla_attention``: in
  f32 within ``F32_RTOL`` of each leaf's largest entry, in bf16 within
  ``LEAF_RTOL`` (tests/test_torch_jamba_train.py's bounds);
- the MoE's backward with 1 and 2 shared experts, in the dropless
  gather form and the capacity form, against ``jax.grad`` of
  ``moe_apply``, teacher-forced as tests/test_torch_jamba_train.py's
  gather test is (a zero cotangent on the tokens whose reference gate
  margin is under ``TIE_MARGIN``): x, the router, the routed stacks and
  the shared experts' weights within ``LEAF_RTOL``;
- ``lm_loss``'s gradients with the MTP term (weight 0.3, labels shifted
  by 2) against ``jax.grad`` of the reference's ``lm_loss`` on the v3
  smoke config with every expert routed, every leaf within twice the
  reference's own gap (its SiLU rounded once against it) and never
  looser than ``LEAF_RTOL`` (tests/test_torch_train.py's rule); the
  port's gradients bit-equal under the "full", "names" and "dots" remat
  policies and no remat;
- Muon's matrix rule on every leaf of the full deepseek-v3 tree, the
  reference's, and the NS Gram's route at full width: ``w_kr`` (7168,
  64) dense, every other MLA and MLP matrix on the kernel;
- ``train --device cpu`` against the reference's jitted
  ``make_train_step`` for 3 steps at ``rtol=2e-3`` a step, with AdamW
  and ``muon-syrk``, on the v3 and v2 smoke configs with every expert
  routed (no routing discontinuity), and on the zero-period cut (v3
  smoke at ``n_layers = len(prefix)``, ``--layers 1``: the reference
  initialised one period deeper and its periods sliced to ``[:0]``);
- a ``--fail-at`` run resumed bit-equal to the uninterrupted one, and
  the port's deepseek checkpoint (prefix, MTP, Muon with its Grams)
  restored by ``repro`` with every leaf's crc.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_full
from repro.configs import get_smoke_config as j_smoke
from repro.data import DataConfig as JData
from repro.data import make_train_iterator as j_iter
from repro.distributed import restore_checkpoint as j_restore
from repro.distributed import verify_restored as j_verify
from repro.launch.steps import make_optimizer as j_make_opt
from repro.launch.steps import make_train_step as j_make_step
from repro.models import attention as jattn
from repro.models import model as jm
from repro.models import moe as jmoe
from repro.models.common import MoECfg as JMoECfg
from repro.optim import Muon as JMuon
from repro.optim.muon import _is_matrix as j_is_matrix
from repro_torch.blas.routing import plan_route
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.distributed import read_manifest
from repro_torch.launch import train as ttrain
from repro_torch.models import moe as tmoe
from repro_torch.models.attention import MLA
from repro_torch.models.common import BlockSpec, MoECfg
from repro_torch.models.model import Model, from_jax_params, lm_loss
from repro_torch.optim.muon import _is_matrix
from test_torch_deepseek import _mla_cfgs, _traced
from test_torch_hygiene import limit_torch_threads  # noqa: F401
from test_torch_jamba import _within_gap
from test_torch_jamba_train import (F32_RTOL, LEAF_RTOL, TIE_MARGIN,
                                    _all_experts, _close, _np, _t)

STEPS = 3
LOSS_RTOL = 2e-3
CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# MLA under autograd
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_lora", [48, 0])
def test_mla_gradients_match_jax_grad(q_lora, dtype):
    jcfg, cfg = _mla_cfgs(q_lora)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jp = jax.tree.map(lambda a: a.astype(jdt),
                      jattn.mla_params(jcfg, jax.random.key(7)))
    m = MLA(cfg, torch.Generator(), CPU)
    for k, v in jp.items():
        getattr(m, k).data = _t(v, tdt)
    assert set(jp) == {n for n, _ in m.named_parameters()}
    rng = np.random.default_rng(q_lora + 1)
    x = jnp.asarray(rng.standard_normal((2, 24, 64)), jdt)
    pos = np.broadcast_to(np.arange(24)[None], (2, 24)).copy()
    g = rng.standard_normal((2, 24, 64)).astype(np.float32)
    spec = BlockSpec()

    def f(p, x):
        y, _ = jattn.mla_attention(jcfg, spec, p, x, jnp.asarray(pos))
        return jnp.sum(y.astype(jnp.float32) * g)
    want = jax.jit(jax.grad(f, argnums=(0, 1)))(jp, x)
    tx = _t(x, tdt).requires_grad_()
    y, _ = m(spec, tx, torch.from_numpy(pos).long())
    assert y.dtype == tdt
    (y.float() * torch.from_numpy(g)).sum().backward()
    rtol = F32_RTOL if dtype == "float32" else LEAF_RTOL
    _close(tx.grad.float(), want[1], "dx", rtol)
    for k, w in want[0].items():
        got = getattr(m, k).grad
        assert got.dtype == tdt, k
        _close(got.float(), w, f"d{k}", rtol)


# ---------------------------------------------------------------------------
# the shared experts' backward, beside the routed ones
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", ["gather", "capacity"])
@pytest.mark.parametrize("n_shared", [1, 2])
def test_shared_experts_backward_teacher_forced(n_shared, impl):
    jcfg, cfg = (dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, n_shared=n_shared)) for c in (
            j_smoke("deepseek-v2-236b"), get_smoke_config("deepseek-v2-236b")))
    jp = jmoe.moe_params(jcfg, jax.random.key(9 + n_shared))
    rng = np.random.default_rng(17 + n_shared)
    t = 64 if impl == "gather" else 160
    x = rng.standard_normal((t, 64)).astype(np.float32)
    if impl == "capacity":
        # skew the router towards expert 0, whose window then drops rows
        u = rng.standard_normal(64).astype(np.float32)
        u /= np.linalg.norm(u)
        x += 2.0 * u
        jp["router"] = jp["router"].at[:, 0].add(0.5 * jnp.asarray(u))
    x = jnp.asarray(x.reshape(2, t // 2, 64), jnp.bfloat16)
    m = tmoe.MoE(cfg, torch.Generator(), CPU)
    for k, v in jp.items():
        if k != "shared":
            getattr(m, k).data.copy_(_t(v, getattr(m, k).dtype))
    for k, v in jp["shared"].items():
        getattr(m.shared, k).data.copy_(_t(v))
    gates = jax.nn.softmax(x.reshape(t, 64).astype(jnp.float32)
                           @ jp["router"], axis=-1)
    top = np.asarray(jnp.sort(gates, axis=-1)[:, ::-1])
    k = cfg.moe.top_k
    near = top[:, k - 1] - top[:, k] < TIE_MARGIN
    assert 0 < near.sum() < t // 4              # some left out, most kept
    g = rng.standard_normal((t, 64)).astype(np.float32)
    g[near] = 0.0
    g = g.reshape(2, t // 2, 64)

    def f(p, x):
        y = jmoe.moe_apply(jcfg, p, x, impl=impl)
        return jnp.sum(y.astype(jnp.float32) * g)
    want = jax.jit(jax.grad(f, argnums=(0, 1)))(jp, x)
    if impl == "capacity":
        cap = tmoe._capacity(t * k, cfg.moe.n_experts)
        counts = np.bincount(np.asarray(jmoe._route(
            jp, x.reshape(t, 64), k)[1]).reshape(-1),
            minlength=cfg.moe.n_experts)
        assert counts.max() > cap, (counts, cap)
    tx = _t(x).requires_grad_()
    y = m(tx, impl=impl)
    (y.float() * torch.from_numpy(g)).sum().backward()
    _close(tx.grad.float(), want[1], "dx", LEAF_RTOL)
    for k in ("router", "wi", "wg", "wo"):
        got = getattr(m, k).grad
        assert got.dtype == getattr(m, k).dtype, k
        _close(got.float(), want[0][k], f"d{k}", LEAF_RTOL)
    for k, w in want[0]["shared"].items():
        got = getattr(m.shared, k).grad
        assert got.dtype == torch.bfloat16, k
        _close(got.float(), w, f"dshared/{k}", LEAF_RTOL)


# ---------------------------------------------------------------------------
# lm_loss with the MTP term
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _reference(arch, seed=0, zero_periods=False):
    """The reference's smoke config with every expert routed and its
    jitted init: (config, params, numpy tree).  ``zero_periods``: cut to
    its prefix blocks, the reference initialised one period deeper and
    its periods sliced to ``[:0]`` (its ``init_params`` stacks at least
    one period)."""
    cj = _all_experts(j_smoke(arch), JMoECfg)
    first = len(cj.prefix)
    if zero_periods:
        cj = dataclasses.replace(cj, n_layers=first + 1)
    params = jax.jit(functools.partial(jm.init_params, cj))(
        jax.random.key(seed))
    if zero_periods:
        params["periods"] = jax.tree.map(lambda a: a[:0], params["periods"])
        cj = dataclasses.replace(cj, n_layers=first)
    return cj, params, jax.tree.map(np.asarray, params)


def _port_cfg(arch, **over):
    return dataclasses.replace(_all_experts(get_smoke_config(arch), MoECfg),
                               **over)


def _ref_grads(cj, params, jb, once):
    """``jax.grad`` of the reference's ``lm_loss`` (with its SiLU rounded
    once: ``once``), by path, as f32 numpy."""
    fn = _traced(functools.partial(jm.lm_loss, cj, chunk=16), once)
    flat, _ = jax.tree_util.tree_flatten_with_path(jax.jit(jax.grad(fn))(
        params, jb))
    return {tuple(k.key for k in path): g for path, g in flat}


def test_lm_loss_gradients_with_the_mtp_term():
    """Every leaf of ``lm_loss``'s gradient, the MTP block's and
    ``mtp_norm``'s included, against ``jax.grad`` of the reference's: in
    bf16 through 4 blocks of experts summed in bf16 the reference's
    gradient moves by up to ~5 % of a leaf's largest entry when only its
    SiLU's rounding changes (``test_torch_deepseek._silu_once``), so each
    leaf is held within ``GAP_FACTOR`` times that gap of its own, never
    looser than ``LEAF_RTOL``, as tests/test_torch_deepseek.py holds the
    model end to end."""
    arch = "deepseek-v3-671b"
    cj, params, np_tree = _reference(arch)
    rng = np.random.default_rng(21)
    toks = rng.integers(0, 256, (2, 32)).astype(np.int32)
    labs = rng.integers(0, 256, (2, 32)).astype(np.int32)
    labs[0, :3], labs[1, -4:] = -1, -1
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)}
    want, once = (_ref_grads(cj, params, jb, o) for o in (False, True))
    assert ("mtp", "mixer", "w_uq") in want and ("mtp_norm", "scale") in want
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labs).long()}
    grads = {}
    for policy in ("full", "names", "dots", None):
        model = from_jax_params(np_tree, _port_cfg(
            arch, remat_policy=policy or "full"), device="cpu")
        lm_loss(model, batch, chunk=16, remat=policy is not None).backward()
        grads[policy] = model.stacked(lambda p: p.grad)
    got = grads["full"]
    assert list(got) == list(want)
    for k, g in got.items():
        assert str(g.dtype) == f"torch.{want[k].dtype}", k
        w = _np(want[k])
        _within_gap([(g.float(), w)], [(once[k], w)],
                    LEAF_RTOL * float(np.abs(w).max()), "/".join(k))
    for policy in ("names", "dots", None):
        for k, g in got.items():
            assert torch.equal(g, grads[policy][k]), (policy, k)


# ---------------------------------------------------------------------------
# Muon on MLA's leaves
# ---------------------------------------------------------------------------
def test_muon_matrix_rule_and_routes_on_the_full_tree():
    """Every leaf of the full deepseek-v3 tree is a Muon matrix in the
    port exactly where it is in the reference; on the card the NS Gram of
    ``w_kr`` (short side 64, below ``KERNEL_MIN_N1``) is dense and every
    other prefix / MTP matrix reaches the kernels."""
    cfg, jcfg = get_config("deepseek-v3-671b"), j_full("deepseek-v3-671b")
    shapes = Model(cfg, torch.Generator(),
                   torch.device("meta")).stacked_shapes()
    jshapes = jax.eval_shape(functools.partial(jm.init_params, jcfg),
                             jax.random.key(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(jshapes)
    jshapes = {tuple(k.key for k in path): a for path, a in flat}
    assert shapes == {k: tuple(a.shape) for k, a in jshapes.items()}
    for k, s in shapes.items():
        assert _is_matrix(torch.empty(s, device="meta")) == \
            j_is_matrix(jshapes[k]), k
    cuda = torch.device("cuda")
    routes = {k: plan_route("syrk", min(s[-2:]), max(s[-2:]), device=cuda,
                            batch=len(s) > 2).path
              for k, s in shapes.items() if k[0] in ("prefix", "mtp")
              and len(s) == 2}
    assert len(routes) == 4 * 10            # 3 prefix blocks + MTP, 10 each
    assert {k for k, p in routes.items() if p == "dense"} == {
        ("prefix", f"b{i}", "mixer", "w_kr") for i in range(3)} | {
        ("mtp", "mixer", "w_kr")}
    assert set(routes.values()) == {"dense", "kernel"}


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------
def _args(**kw):
    args = ttrain.build_argparser().parse_args([])
    for k, v in dict(device="cpu", arch="deepseek-v3-671b", smoke=True,
                     steps=STEPS, global_batch=4, seq_len=32, loss_chunk=16,
                     log_every=1).items():
        setattr(args, k, v)
    for k, v in kw.items():
        setattr(args, k, v)
    return args


@pytest.mark.parametrize("optimizer", ["adamw", "muon-syrk"])
@pytest.mark.parametrize("arch,zero", [("deepseek-v3-671b", False),
                                       ("deepseek-v2-236b", False),
                                       ("deepseek-v3-671b", True)])
def test_train_cli_follows_reference_losses(monkeypatch, arch, zero,
                                            optimizer):
    args = _args(arch=arch, optimizer=optimizer,
                 layers=len(get_smoke_config(arch).prefix) if zero else 0)
    cj, params, np_tree = _reference(arch, args.seed, zero)
    build = ttrain.build_config
    monkeypatch.setattr(ttrain, "build_config", lambda a: _all_experts(
        build(a), MoECfg))
    monkeypatch.setattr(ttrain, "init_model", lambda cfg, seed, device:
                        from_jax_params(np_tree, cfg, device=device))
    cfg = ttrain.build_config(args)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cj)
    assert cfg.n_periods == (0 if zero else cj.n_periods)
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
    assert out["steps"] == STEPS and all(np.isfinite(out["losses"]))
    np.testing.assert_allclose(out["losses"], want, rtol=LOSS_RTOL)
    assert out["losses"][-1] < out["losses"][0]
    assert out["params"] == sum(int(np.prod(x.shape))
                                for x in jax.tree.leaves(params))
    assert set(out["kernel_launches"].values()) == {0}   # the CPU
    if optimizer.startswith("muon"):
        # MLA's leaves are Muon matrices: w_kr (64, 8), w_uq (48, 96)
        syrk = {(r[1], r[2]) for r in out["routes"] if r[0] == "syrk"}
        assert {(8, 64), (48, 96)} <= syrk, out["routes"]


def test_zero_period_tree_is_the_reference_s_without_its_empty_stacks():
    """The zero-period cut holds the reference's leaves that hold
    anything, in its order, and refuses a tree whose periods hold
    weights; a one-period model still reads its stacked leaves as views
    of its parameters."""
    _, params, np_tree = _reference("deepseek-v3-671b", 0, True)
    cfg = _port_cfg("deepseek-v3-671b", n_layers=1)
    model = from_jax_params(np_tree, cfg, device="cpu")
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    want = [tuple(k.key for k in path) for path, a in flat if a.size]
    assert all(path[0].key == "periods" for path, a in flat if not a.size)
    tree = {k: v.clone() for k, v in model.stacked().items()}
    assert list(tree) == want and len(model.blocks) == 1
    model.load_stacked({k: v + 1 for k, v in tree.items()})
    for k, v in model.stacked().items():
        assert torch.equal(v, tree[k] + 1), k
    with pytest.raises(ValueError, match="periods/b0/.*no periods"):
        from_jax_params(_reference("deepseek-v3-671b")[2], cfg, device="cpu")
    one = Model(_port_cfg("deepseek-v3-671b", n_layers=2),
                torch.Generator(), CPU)
    for k, v in one.stacked().items():
        if k[0] == "periods":
            p, = one.param_tree()[k]
            assert v.data_ptr() == p.data_ptr(), k


def _keep_models(monkeypatch):
    made = []
    init = ttrain.init_model

    def keep(cfg, seed, device):
        made.append(init(cfg, seed=seed, device=device))
        return made[-1]
    monkeypatch.setattr(ttrain, "init_model", keep)
    return made


def test_fail_at_resume_is_bit_exact(monkeypatch, tmp_path):
    """A v3 smoke run (prefix, MoE periods, MTP; Muon with its Grams)
    killed by ``--fail-at 3`` after its step-2 checkpoint, then resumed,
    equals the uninterrupted 4-step run bit for bit: losses and every
    parameter, the prefix's and the MTP block's included."""
    made = _keep_models(monkeypatch)
    kw = dict(optimizer="muon-syrk", track_gram=True, steps=4, ckpt_every=2)
    full = ttrain.train(_args(ckpt_dir=str(tmp_path / "u"), **kw))
    d = str(tmp_path / "r")
    with pytest.raises(ttrain.InjectedFailure):
        ttrain.train(_args(ckpt_dir=d, fail_at=3, **kw))
    out = ttrain.train(_args(ckpt_dir=d, **kw))
    assert out["resumed"] and out["start_step"] == 2
    assert out["restore_verified"]["mismatches"] == []
    assert out["losses"] == full["losses"][2:]
    leaves = read_manifest(d)["leaves"]
    for part in ("params____prefix____b0____", "params____mtp____",
                 "params____mtp_norm____", "opt__.momentum__mtp____",
                 "opt__.gram__prefix____b0____"):
        assert any(k.startswith(part) for k in leaves), part
    for (na, a), (nb, b) in zip(made[0].named_parameters(),
                                made[-1].named_parameters()):
        assert na == nb and torch.equal(a, b), na


def test_reference_restores_the_port_checkpoint(tmp_path):
    """The port's deepseek-v3 checkpoint after 2 Muon steps (prefix,
    periods, MTP, the momentum and the packed Grams) restores in
    ``repro`` from a ``jax.eval_shape`` like: every leaf's crc, and the
    parameters the port's bit for bit."""
    from repro_torch.distributed.checkpoint import _flatten
    d = str(tmp_path)
    out = ttrain.train(_args(optimizer="muon-syrk", track_gram=True,
                             steps=2, ckpt_dir=d, ckpt_every=2))
    assert out["steps"] == 2
    like = jax.eval_shape(functools.partial(jm.init_params,
                                            j_smoke("deepseek-v3-671b")),
                          jax.random.key(0))
    jopt = JMuon(gram_decay=0.99)
    step, back = j_restore(d, {"params": like,
                               "opt": jax.eval_shape(jopt.init, like)})
    assert step == 2 and int(back["opt"].step) == 2
    vr = j_verify(d, back, step=step)
    assert vr["mismatches"] == [] and vr["checked"] == \
        len(read_manifest(d)["leaves"])
    from repro_torch.distributed import restore_checkpoint
    model = from_jax_params(jax.tree.map(np.asarray, back["params"]),
                            get_smoke_config("deepseek-v3-671b"),
                            device="cpu")
    _, mine = restore_checkpoint(d, {"params": model.stacked()})
    for (k, a), (_, b) in zip(_flatten({"params": model.stacked()}),
                              _flatten(mine)):
        assert torch.equal(a, b), k
