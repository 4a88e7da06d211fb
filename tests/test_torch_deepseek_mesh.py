"""deepseek on a (data, model) mesh of gloo CPU ranks: the
tensor-parallel MLA (its three latents gathered whole over 'model'), the
prefix blocks and the MTP block split as a period's blocks are,
``fsdp_params`` over their weights, the MTP term's global mean, Muon on
the split leaves and a mesh checkpoint.

Two launches, 4 ranks on (2, 2) first and 2 ranks on (1, 2) after it,
each running every case of its mesh in turn (the 2-rank launch also
plans its ranks as (2, 1) for the MTP term):

* the MLA mixer (v3's smoke width, ``q_lora`` 48 and 0), each data rank
  on its rows, ``fsdp_params`` where 'data' > 1:
  - in f32, cache-free, against the reference's ``mla_attention`` on the
    same weights (bf16 values, as ``test_torch_deepseek.py::
    test_mla_matches_reference`` loads them, held in f32), within that
    test's ``ULPS``; the one-device port's own gap to the reference is
    printed beside (``-s``) and the mesh's held within twice it where it
    exceeds ``ULPS``;
  - in bf16 against the port's one-device MLA on the same rows: the
    output within ``ULPS`` and the gradients of x and of every weight
    within ``LEAF_RTOL`` (on (2, 2) the weights' gradients, gathered over
    'data' and reduce-scattered, against the sum over the data rows');
* the MoE layer with deepseek-v2's 2 shared experts on (1, 2): the
  output and the gradients against one device;
* the MTP term on (2, 2) and (2, 1), on labels whose -1 positions differ
  by data rank (one data rank's rows hold 2 valid labels a row, so its
  t+2 count is half its t+1 count, against 31 / 32 on the other), the
  reference's v3 smoke weights: the global loss of
  ``steps.data_parallel_loss``
  against the one-device ``lm_loss`` on the whole batch and against the
  reference's ``lm_loss``, and every gradient, reduced as the train step
  reduces it, against the one-device gradients; the per-rank mean the
  port took before (each data rank's t+2 mean at its t+1 count's
  scale) misses the reference by more than the bound;
* the trainer (``launch.train._run``) on deepseek-v2's and v3's smoke
  configs, every expert routed (top_k = n_experts: no routing
  discontinuity), ``fsdp_params`` where 'data' > 1, AdamW and
  ``muon-syrk``, 3 steps from the port's seed-0 init, against the port's
  one-device run (``test_torch_dense_train_mesh.py``'s ``LOSS_RTOL`` and
  ``PARAM_TOL``), every rank's losses identical; each rank's loss +
  backward words a step the closed form (``chip_smoke.py::
  deepseek_tp_closed_form``, what the card's check reads; on (2, 2) with
  ZeRO-3's all-gathers and reduce-scatters, ``chip_smoke.py::
  fsdp_closed_form``, and the counts' and the loss's all-reduces over
  'data'); Muon's route for every matrix leaf;
* v3's ``--layers 1`` cut on (1, 2) (its prefix block and the MTP block,
  no periods: the card's path), its words that closed form and its
  losses one device's;
* the (2, 2) v3 ``muon-syrk`` run's checkpoint restored onto (1, 2) (and
  verified there), onto one device and by ``repro``: every leaf,
  parameters and Muon's momentum, bit-equal to the one-device restore
  and to the (2, 2) run's gathered parameters.
"""
import dataclasses
import math
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.distributed.launch import run_ranks
from repro_torch.launch import train as ttrain
from repro_torch.models import moe as tmoe
from repro_torch.models.attention import MLA
from repro_torch.models.common import BlockSpec, MLACfg, MoECfg
from test_torch_hygiene import limit_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")
ARCHS = ["deepseek-v2-236b", "deepseek-v3-671b"]
V3 = "deepseek-v3-671b"
STEPS = 3
LOSS_RTOL = 5e-4            # tests/test_torch_dense_train_mesh.py
PARAM_TOL = 2e-3            # the whole model, relative Frobenius norm
#: bf16 ulps of the largest entry (tests/test_torch_deepseek.py's bound)
ULPS = 4
#: a bf16 gradient leaf against one device, of its largest entry
#: (tests/test_torch_jamba_mesh.py's LEAF_RTOL)
LEAF_RTOL = 3e-2
#: the loss against the reference's, relative
#: (test_torch_deepseek.py::test_lm_loss_with_mtp_matches_reference)
REF_LOSS_RTOL = 2e-4
#: (data, arch, optimizer); the (2, 2) v3 muon-syrk run writes the
#: checkpoint
TRAIN_CASES = [(d, a, o) for d in (2, 1) for a in ARCHS
               for o in ("adamw", "muon-syrk")]
Q_LORAS = (48, 0)
#: the MTP cases' batch: rows x positions, and the data rank whose rows
#: hold 2 valid labels a row
MTP_BATCH, MTP_SEQ, MTP_CHUNK, SPARSE_RANK = 4, 32, 16, 1


# ---------------------------------------------------------------------------
# configs and helpers
# ---------------------------------------------------------------------------
def _every_expert(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, top_k=cfg.moe.n_experts))


def _train_cfg(arch, data, layers=0):
    """``arch``'s smoke config, every expert routed, ``fsdp_params``
    where ``data`` > 1; ``layers`` cuts it as ``--layers`` does."""
    cfg = _every_expert(get_smoke_config(arch))
    cfg = dataclasses.replace(cfg, fsdp_params=data > 1)
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


def _mla_cfg(q_lora):
    cfg = get_smoke_config(V3)
    return dataclasses.replace(cfg, mla=MLACfg(**{
        **dataclasses.asdict(cfg.mla), "q_lora": q_lora}))


def _args(**kw):
    args = ttrain.build_argparser().parse_args([])
    for k, v in dict(device="cpu", steps=STEPS, global_batch=4, seq_len=32,
                     loss_chunk=16, log_every=1).items():
        setattr(args, k, v)
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def _close(got, want, what, rtol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    tol = rtol * float(np.abs(want).max())
    print(f"{what}: max_abs_err {err:.3g}, bound {tol:.3g}")
    assert err <= tol, f"{what}: max_abs_err {err:.4g} > {tol:.4g}"
    return err


def _rows(a, r, d):
    """Data rank ``r`` of ``d``'s rows of ``a`` (rows on dim 0)."""
    n = a.shape[0]
    return a[r * n // d:(r + 1) * n // d]


def _shard_module(module, cfg, mesh, owners):
    """``module``'s parameters cut to this rank's blocks under their
    leaf specs (``fsdp_params`` where 'data' > 1), as ``Model.shard_``
    cuts a block's: each split over 'data' registered with the module
    ``owners(name)`` that gathers it.  Returns the specs by name."""
    from repro_torch.models.sharding import leaf_spec, shard_leaf
    cfg = dataclasses.replace(cfg, fsdp_params=mesh.shape["data"] > 1)
    specs = {}
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.split(".")[-1]
            spec = leaf_spec(cfg, leaf, tuple(p.shape), mesh)
            specs[name] = spec
            p.data = shard_leaf(p.data, spec, mesh).clone()
            if "data" in spec and mesh.shape["data"] > 1:
                owners(name).fsdp[leaf] = (mesh.comm("data"),
                                           spec.index("data"))
    return specs


def _grads(module, xi, specs, mesh):
    """x's gradient and every parameter's, gathered whole."""
    from repro_torch.models.sharding import gather_leaf
    out = {"x": xi.grad.float().numpy()}
    for n, p in module.named_parameters():
        g = p.grad if specs is None else gather_leaf(p.grad, specs[n], mesh)
        out[n] = g.float().numpy()
    return out


# ---------------------------------------------------------------------------
# the MLA mixer
# ---------------------------------------------------------------------------
def _mla(q_lora, params, dtype):
    """A one-device ``MLA`` holding the reference's ``params`` (numpy,
    bf16 values) in ``dtype``."""
    m = MLA(_mla_cfg(q_lora), torch.Generator(), torch.device("cpu"))
    with torch.no_grad():
        for name, p in m.named_parameters():
            p.data = torch.from_numpy(params[name]).to(dtype)
    return m


def _mla_inputs(q_lora):
    """f32 input (bf16 values), bf16 input and cotangent, positions:
    (4, 16) tokens."""
    gen = np.random.default_rng(20 + q_lora)
    x = torch.from_numpy(gen.standard_normal((4, 16, 64)).astype(
        np.float32)).to(torch.bfloat16)
    g = torch.from_numpy(gen.standard_normal((4, 16, 64)).astype(
        np.float32))
    pos = torch.arange(16)[None].expand(4, -1)
    return x.float(), x, g, pos


def _mla_run(m, x, pos, g=None):
    xi = x.clone().requires_grad_(g is not None)
    y, _ = m(BlockSpec(), xi, pos)
    if g is not None:
        (y.float() * g).sum().backward()
    return y.detach(), xi


def _mla_cases(mesh, ref):
    r, d = mesh.index("data"), mesh.shape["data"]
    out = {}
    for q in Q_LORAS:
        xf, xb, g, pos = _mla_inputs(q)
        m = _mla(q, ref["mla"][q], torch.float32)
        m.tp = mesh.comm("model")
        _shard_module(m, _mla_cfg(q), mesh, lambda name, m=m: m)
        with torch.no_grad():
            yf, _ = _mla_run(m, _rows(xf, r, d), _rows(pos, r, d))
        m = _mla(q, ref["mla"][q], torch.bfloat16)
        m.tp = mesh.comm("model")
        specs = _shard_module(m, _mla_cfg(q), mesh, lambda name, m=m: m)
        yb, xi = _mla_run(m, _rows(xb, r, d), _rows(pos, r, d),
                          _rows(g, r, d))
        out[q] = {"f32": yf.numpy(), "out": yb.float().numpy(),
                  "grads": _grads(m, xi, specs, mesh)}
    return out


# ---------------------------------------------------------------------------
# the MoE layer with 2 shared experts (on (1, 2))
# ---------------------------------------------------------------------------
def _moe_cfg():
    cfg = get_smoke_config("deepseek-v2-236b")
    return dataclasses.replace(cfg, moe=MoECfg(
        n_experts=cfg.moe.n_experts, top_k=cfg.moe.top_k, n_shared=2,
        d_ff_expert=cfg.moe.d_ff_expert))


def _moe_inputs():
    gen = np.random.default_rng(3)
    x = torch.from_numpy(gen.standard_normal((64, 64)).astype(
        np.float32)).to(torch.bfloat16)
    return x, torch.from_numpy(gen.standard_normal((64, 64)).astype(
        np.float32))


def _moe_run(layer, x, g):
    xi = x.clone().requires_grad_()
    y = tmoe.moe_local(_moe_cfg(), layer, xi, impl="gather")
    (y.float() * g).sum().backward()
    return y.detach().float().numpy(), xi


def _moe_layer():
    return tmoe.MoE(_moe_cfg(), torch.Generator().manual_seed(5),
                    torch.device("cpu"))


def _moe_case(mesh):
    layer = _moe_layer()
    assert layer.shared.wi.shape == (64, 64)
    layer.tp = layer.shared.tp = mesh.comm("model")
    specs = _shard_module(
        layer, _moe_cfg(), mesh,
        lambda name: layer.shared if name.startswith("shared.") else layer)
    x, g = _moe_inputs()
    y, xi = _moe_run(layer, x, g)
    return {"out": y, "grads": _grads(layer, xi, specs, mesh)}


# ---------------------------------------------------------------------------
# the MTP term over 'data'
# ---------------------------------------------------------------------------
def _mtp_batch():
    """The MTP cases' global batch, as numpy: tokens and labels with -1
    at every position of ``SPARSE_RANK``'s rows (of 2 data ranks) but 0
    and 1, and at each row's last."""
    gen = np.random.default_rng(17)
    toks = gen.integers(0, 256, (MTP_BATCH, MTP_SEQ)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    half = MTP_BATCH // 2
    labels[SPARSE_RANK * half:(SPARSE_RANK + 1) * half, 2:] = -1
    return toks, labels


def _per_rank_mean(model, batch, dp, chunk):
    """The loss the port differentiated before: each data rank's t+2
    mean at its t+1 count's scale, (what to differentiate, the global
    loss), as :func:`steps.data_parallel_loss` returns them."""
    from repro_torch.distributed import collectives
    from repro_torch.models.model import MTP_WEIGHT, lm_loss_terms
    (tot, cnt), (tot2, cnt2) = lm_loss_terms(model, batch, chunk)
    tot = tot + MTP_WEIGHT * tot2 / torch.clamp(cnt2, min=1.0) \
        * torch.clamp(cnt, min=1.0)
    n, n_dp = cnt.detach(), math.prod(c.size for c in dp)
    for c in dp:
        n = collectives.all_reduce(n, c)
    loss = tot * (n_dp / torch.clamp(n, min=1.0))
    total = loss.detach()
    for c in dp:
        total = collectives.all_reduce(total, c)
    return loss, total / n_dp


def _mtp_case(mesh, np_tree):
    """On this mesh, for the loss of ``steps.data_parallel_loss`` and
    for :func:`_per_rank_mean`: the global loss and the gradients,
    reduced over 'data' as the train step reduces them, gathered
    whole."""
    from repro_torch.distributed import collectives
    from repro_torch.launch.steps import _split_axes, data_parallel_loss
    from repro_torch.models.model import from_jax_params
    from repro_torch.models.sharding import (batch_specs, gather_leaf,
                                             shard_leaf)
    data = mesh.shape["data"]
    cfg = _train_cfg(V3, data)
    model = from_jax_params(np_tree, cfg, device="cpu", mesh=mesh)
    toks, labels = _mtp_batch()
    bs = batch_specs(cfg, mesh, MTP_BATCH, False)
    batch = {k: shard_leaf(torch.from_numpy(v).long(), bs[k], mesh)
             for k, v in (("tokens", toks), ("labels", labels))}
    dp = [mesh.comm("data")] if data > 1 else []
    out = {}
    for name, fn in (("global", data_parallel_loss),
                     ("per_rank", _per_rank_mean)):
        model.zero_grad(set_to_none=True)
        loss, glob = fn(model, batch, dp, MTP_CHUNK)
        loss.backward()
        grads = {}
        for k, g in model.stacked(lambda p: p.grad).items():
            g = g.float()
            if data > 1 and "data" not in _split_axes(model.specs[k], mesh):
                g = collectives.all_reduce(g, dp[0])
            grads["/".join(k)] = gather_leaf(g / data, model.specs[k],
                                             mesh).numpy()
        out[name] = {"loss": float(glob), "grads": grads}
    return out


# ---------------------------------------------------------------------------
# the trainer on the ranks
# ---------------------------------------------------------------------------
def _train_case(mesh, arch, optimizer, ckpt_dir=None, layers=0):
    """``train._run`` on this mesh from the port's seed-0 init: losses,
    words, Muon's routes and the gathered parameters."""
    from repro_torch.models.sharding import gather_leaf
    data, model_ax = mesh.shape["data"], mesh.shape["model"]
    made, init = [], ttrain.init_model

    def keep(cfg, seed, device, **kw):
        made.append(init(cfg, seed=seed, device=device, **kw))
        return made[-1]

    ttrain.init_model = keep
    try:
        out = ttrain._run(_args(optimizer=optimizer, arch=arch,
                                devices=data * model_ax, max_model=model_ax,
                                ckpt_dir=ckpt_dir),
                          _train_cfg(arch, data, layers), mesh.device,
                          mesh=mesh, say=lambda line: None)
    finally:
        ttrain.init_model = init
    model = made[-1]
    return {"coords": (mesh.index("data"), mesh.index("model")),
            "losses": out["losses"], "words": out["words"],
            "leaf_routes": out["leaf_routes"],
            "params": {k: gather_leaf(v, model.specs[k], mesh).float()
                       .numpy() for k, v in model.stacked().items()}}


def _restore_case(mesh, ckpt_dir):
    """The (2, 2) checkpoint restored onto this mesh's blocks and
    verified; every leaf gathered back whole."""
    from repro_torch.distributed import restore_checkpoint, verify_restored
    from repro_torch.launch.steps import make_optimizer
    from repro_torch.models.model import init_model
    from repro_torch.models.sharding import gather_leaf
    cfg = _train_cfg(V3, mesh.shape["data"])
    model = init_model(cfg, seed=1, device="cpu", mesh=mesh)
    opt = make_optimizer(cfg, "muon-syrk", mesh=mesh, specs=model.specs)
    like = {"params": model.stacked(), "opt": opt.init(model.stacked())}
    on = {"mesh": mesh, "specs": model.specs}
    step, state = restore_checkpoint(ckpt_dir, like, **on)
    verified = verify_restored(ckpt_dir, state, step=step, **on)
    opt_state = state["opt"]
    whole = {"params": {k: gather_leaf(v, model.specs[k], mesh)
                        for k, v in state["params"].items()},
             "opt": opt_state._replace(momentum={
                 k: gather_leaf(v, model.specs[k], mesh)
                 for k, v in opt_state.momentum.items()})}
    return {"step": step, "mismatches": len(verified["mismatches"]),
            "leaves": _leaves(whole)}


def _leaves(tree):
    """A checkpoint tree's leaves by the checkpoint's keys, tensors as
    f32 numpy."""
    from repro_torch.distributed.checkpoint import _flatten
    return {k: v.float().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in _flatten(tree)}


def rank_main(mesh_x, world, ref, ckpt_dir):
    from repro_torch.distributed.mesh import make_mesh
    data = world // 2
    mesh = make_mesh({"data": data, "model": 2}, device="cpu")
    res = {"rank": mesh.rank, "mla": _mla_cases(mesh, ref), "train": {}}
    if data == 2:
        res["mtp"] = {(2, 2): _mtp_case(mesh, ref["tree"])}
    for d, arch, optimizer in TRAIN_CASES:
        if d == data:
            res["train"][arch, optimizer] = _train_case(
                mesh, arch, optimizer,
                ckpt_dir if (data, arch, optimizer) == (2, V3, "muon-syrk")
                else None)
    if data == 1:
        res["moe"] = _moe_case(mesh)
        res["cut"] = _train_case(mesh, V3, "adamw", layers=1)
        res["restore"] = _restore_case(mesh, ckpt_dir)
        rows = make_mesh({"data": 2, "model": 1}, device="cpu")
        res["mtp"] = {(2, 1): _mtp_case(rows, ref["tree"])}
    return res


# ---------------------------------------------------------------------------
# the reference (this process) and the launches
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference():
    """The reference's MLA weights (v3's smoke width, both ``q_lora``),
    its outputs in f32 on the f32 MLA input, its v3 smoke tree (every
    expert routed) and its ``lm_loss`` on the MTP cases' batch, as
    numpy."""
    import functools

    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as j_smoke
    from repro.models import attention as jattn
    from repro.models import model as jm
    from repro.models.common import MoECfg as JMoECfg
    out = {"mla": {}, "mla_ref": {}}
    for q in Q_LORAS:
        jcfg = j_smoke(V3)
        jcfg = dataclasses.replace(jcfg, mla=dataclasses.replace(
            jcfg.mla, q_lora=q))
        jp = jattn.mla_params(jcfg, jax.random.key(4))
        out["mla"][q] = {k: np.asarray(v, np.float32) for k, v in jp.items()}
        xf, _, _, pos = _mla_inputs(q)
        y, _ = jattn.mla_attention(
            jcfg, BlockSpec(),
            {k: jnp.asarray(v) for k, v in out["mla"][q].items()},
            jnp.asarray(xf.numpy()), jnp.asarray(pos.numpy()))
        out["mla_ref"][q] = np.asarray(y, np.float32)
    jcfg = j_smoke(V3)
    jcfg = dataclasses.replace(jcfg, moe=JMoECfg(
        jcfg.moe.n_experts, jcfg.moe.n_experts, jcfg.moe.n_shared,
        jcfg.moe.d_ff_expert))
    # jitted: init_params's values, bit for bit, in half the time
    params = jax.jit(functools.partial(jm.init_params, jcfg))(
        jax.random.key(0))
    # f32 numpy (the values are bf16's): the ranks unpickle them
    out["tree"] = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    toks, labels = _mtp_batch()
    loss = functools.partial(jm.lm_loss, jcfg, chunk=MTP_CHUNK, remat=False)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    value, grads = jax.jit(jax.value_and_grad(loss))(params, jb)
    out["ref_loss"] = float(value)
    flat, _ = jax.tree_util.tree_flatten_with_path(grads)
    out["ref_grads"] = {"/".join(k.key for k in path): np.asarray(
        g, np.float32) for path, g in flat}
    return out


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("deepseek_mesh_ckpt"))


def _ref_for_ranks(reference):
    return {k: reference[k] for k in ("mla", "tree")}


@pytest.fixture(scope="module")
def launch22(reference, ckpt_dir):
    return run_ranks("test_torch_deepseek_mesh:rank_main", 4, device="cpu",
                     paths=[TESTS], timeout=900,
                     kwargs={"world": 4, "ref": _ref_for_ranks(reference),
                             "ckpt_dir": ckpt_dir})


@pytest.fixture(scope="module")
def launch12(launch22, reference, ckpt_dir):
    return run_ranks("test_torch_deepseek_mesh:rank_main", 2, device="cpu",
                     paths=[TESTS], timeout=900,
                     kwargs={"world": 2, "ref": _ref_for_ranks(reference),
                             "ckpt_dir": ckpt_dir})


@pytest.fixture(scope="module")
def launches(launch12, launch22):
    return {1: launch12, 2: launch22}


# ---------------------------------------------------------------------------
# the one-device oracles (this process)
# ---------------------------------------------------------------------------
_SINGLE = {}


def _single(arch, optimizer, layers=0):
    """The port's one-device trainer run: (losses, whole params)."""
    key = (arch, optimizer, layers)
    if key not in _SINGLE:
        made, init = [], ttrain.init_model

        def keep(cfg, seed, device, **kw):
            made.append(init(cfg, seed=seed, device=device, **kw))
            return made[-1]
        ttrain.init_model = keep
        try:
            out = ttrain._run(_args(optimizer=optimizer, arch=arch),
                              _train_cfg(arch, 1, layers),
                              torch.device("cpu"), say=lambda line: None)
        finally:
            ttrain.init_model = init
        _SINGLE[key] = (out["losses"], {
            k: v.float().numpy() for k, v in made[-1].stacked().items()})
    return _SINGLE[key]


def _chip_smoke():
    """``chip_smoke.py``'s closed forms (the card's checks read them)."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    return chip_smoke


# ---------------------------------------------------------------------------
# the MLA mixer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("data", [1, 2])
@pytest.mark.parametrize("q_lora", Q_LORAS)
def test_mla_matches_the_reference_in_f32(launches, reference, data,
                                          q_lora):
    """f32, cache-free, each data rank's rows: within ``ULPS`` of the
    reference's ``mla_attention`` (and within twice the one-device
    port's own gap to it, printed)."""
    want = reference["mla_ref"][q_lora]
    xf, _, _, pos = _mla_inputs(q_lora)
    with torch.no_grad():
        one, _ = _mla_run(_mla(q_lora, reference["mla"][q_lora],
                               torch.float32), xf, pos)
    gap = float(np.abs(one.numpy() - want).max())
    tol = ULPS * 2.0 ** -8 * float(np.abs(want).max())
    print(f"q_lora {q_lora}: the one-device port's gap to the reference "
          f"{gap:.3g}")
    for rk in launches[data]:
        r = rk["rank"] // 2
        rows = _rows(want, r, data)
        err = float(np.abs(rk["mla"][q_lora]["f32"] - rows).max())
        print(f"({data}, 2) rank {rk['rank']}: {err:.3g} (bound {tol:.3g})")
        assert err <= max(tol, 2 * gap)


@pytest.mark.parametrize("data", [1, 2])
@pytest.mark.parametrize("q_lora", Q_LORAS)
def test_mla_matches_one_device_with_gradients(launches, reference, data,
                                               q_lora):
    """bf16, each data rank's rows: the output within ``ULPS`` of the
    one-device MLA's largest entry, x's gradient (a data rank's own) and
    every weight's (on (2, 2) split over 'data' too: the sum over the
    data rows') within ``LEAF_RTOL``."""
    _, xb, g, pos = _mla_inputs(q_lora)
    one = []
    for r in range(data):
        m = _mla(q_lora, reference["mla"][q_lora], torch.bfloat16)
        y, xi = _mla_run(m, _rows(xb, r, data), _rows(pos, r, data),
                         _rows(g, r, data))
        one.append((y.float().numpy(), _grads(m, xi, None, None)))
    for rk in launches[data]:
        r = rk["rank"] // 2
        got = rk["mla"][q_lora]
        y, grads = one[r]
        _close(got["out"], y, f"out rank {rk['rank']}", ULPS * 2.0 ** -8)
        assert set(got["grads"]) == set(grads)
        for name, gv in got["grads"].items():
            want = grads[name] if name == "x" else \
                sum(o[1][name] for o in one)
            _close(gv, want, f"d{name} rank {rk['rank']}", LEAF_RTOL)


def test_moe_with_two_shared_experts_matches_one_device(launch12):
    """(1, 2), deepseek-v2's 2 shared experts beside top-2 of 8: the
    output within ``ULPS`` and the gradients of x, the router, the
    stacks and the shared experts' weights within ``LEAF_RTOL``."""
    layer = _moe_layer()
    x, g = _moe_inputs()
    y, xi = _moe_run(layer, x, g)
    grads = _grads(layer, xi, None, None)
    assert {n for n in grads if n.startswith("shared.")} == {
        "shared.wi", "shared.wg", "shared.wo"}
    for rk in launch12:
        _close(rk["moe"]["out"], y, "moe out", ULPS * 2.0 ** -8)
        for name, want in grads.items():
            _close(rk["moe"]["grads"][name], want, f"moe d{name}",
                   LEAF_RTOL)


# ---------------------------------------------------------------------------
# the MTP term
# ---------------------------------------------------------------------------
_MTP_ONE = {}


def _mtp_one_device(reference):
    """The one-device ``lm_loss`` on the whole batch and its gradients."""
    if not _MTP_ONE:
        from repro_torch.models.model import from_jax_params, lm_loss
        model = from_jax_params(reference["tree"], _train_cfg(V3, 1),
                                device="cpu")
        toks, labels = _mtp_batch()
        loss = lm_loss(model, {"tokens": torch.from_numpy(toks).long(),
                               "labels": torch.from_numpy(labels).long()},
                       chunk=MTP_CHUNK)
        loss.backward()
        _MTP_ONE.update(loss=float(loss.detach()), grads={
            "/".join(k): g.float().numpy()
            for k, g in model.stacked(lambda p: p.grad).items()})
    return _MTP_ONE


@pytest.mark.parametrize("mesh", [(2, 2), (2, 1)])
def test_mtp_term_is_the_global_mean(launches, reference, mesh):
    """Labels whose -1 positions differ by data rank, every rank's loss
    the same: the mesh's loss within ``LOSS_RTOL`` of the one-device
    ``lm_loss`` on the whole batch and within ``REF_LOSS_RTOL`` of the
    reference's; each gradient leaf within twice the one-device port's
    own gap to ``jax.grad`` of the reference's loss (whole-model bf16
    gradients move by a few percent of a leaf's largest entry with any
    rounding, tests/test_torch_deepseek_train.py), never looser than
    ``LEAF_RTOL``.  The per-rank mean the port took before misses both:
    its loss by more than ``REF_LOSS_RTOL``, its gradients by more than
    the bound."""
    one = _mtp_one_device(reference)
    ref, ref_grads = reference["ref_loss"], reference["ref_grads"]
    # (2, 2) ran on the 4-rank launch, (2, 1) on the 2-rank one
    ranks = [rk["mtp"][mesh] for rk in launches[mesh[1]]]
    assert len(ranks) == math.prod(mesh)
    assert one["grads"].keys() == ref_grads.keys()
    bound = {k: max(LEAF_RTOL * float(np.abs(w).max()),
                    2 * float(np.abs(w - ref_grads[k]).max()))
             for k, w in one["grads"].items()}

    def misses(grads):
        return {k: float(np.abs(grads[k] - w).max()) / bound[k]
                for k, w in one["grads"].items()}

    for how in ("global", "per_rank"):
        got = ranks[0][how]
        rel = abs(got["loss"] - ref) / abs(ref)
        worst = max(misses(got["grads"]).items(), key=lambda kv: kv[1])
        print(f"{mesh} {how}: loss {got['loss']} (one device "
              f"{one['loss']}, reference {ref}: rel {rel:.3g}); the worst "
              f"gradient leaf {worst[0]} at {worst[1]:.3g} of its bound")
    old = ranks[0]["per_rank"]
    assert abs(old["loss"] - ref) > REF_LOSS_RTOL * abs(ref)
    assert max(misses(old["grads"]).values()) > 1
    for r in ranks:
        got = r["global"]
        assert got["loss"] == ranks[0]["global"]["loss"]
        assert abs(got["loss"] - one["loss"]) <= LOSS_RTOL * abs(one["loss"])
        assert abs(got["loss"] - ref) <= REF_LOSS_RTOL * abs(ref)
        assert got["grads"].keys() == one["grads"].keys()
        bad = {k: v for k, v in misses(got["grads"]).items() if v > 1}
        assert not bad, bad


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------
def _train(launches, data, arch, optimizer):
    return [rk["train"][arch, optimizer] for rk in launches[data]]


def _params_close(got, params, what):
    assert got.keys() == params.keys()
    diff = sum(float(np.sum((got[k] - p) ** 2)) for k, p in params.items())
    norm = sum(float(np.sum(p ** 2)) for p in params.values())
    print(f"{what}: params rel {(diff / norm) ** 0.5:.3g}")
    assert diff <= PARAM_TOL ** 2 * norm, (diff / norm) ** 0.5


@pytest.mark.parametrize("data,arch,optimizer", TRAIN_CASES)
def test_trainer_ranks_agree_and_follow_one_device(launches, data, arch,
                                                   optimizer):
    ranks = _train(launches, data, arch, optimizer)
    losses = ranks[0]["losses"]
    assert len(losses) == STEPS and all(np.isfinite(losses))
    for r in ranks[1:]:
        assert r["losses"] == losses, "ranks disagree"
    want, params = _single(arch, optimizer)
    print(f"({data}, 2) {arch} {optimizer}: losses {losses} vs {want}")
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL)
    _params_close(ranks[0]["params"], params, f"({data}, 2) {arch}")


def _mesh_words(cfg, data, model):
    """A rank's loss + backward words a step on (data, model), by kind:
    the tensor-parallel closed form on its data rank's tokens, and over
    'data' ZeRO-3's and the counts' and the loss's all-reduces."""
    cs = _chip_smoke()
    args = _args()
    rows = args.global_batch // data
    want = cs.deepseek_tp_closed_form(cfg, rows * args.seq_len, model,
                                      args.seq_len, args.loss_chunk)
    if data > 1:
        for kind, n in cs.fsdp_closed_form(cfg, data, model).items():
            want[kind] += n
        want["all_reduce"] += cs._ar_words(2 if cfg.mtp else 1, data) \
            + cs._ar_words(1, data)
    return want


@pytest.mark.parametrize("data,arch,optimizer", TRAIN_CASES)
def test_trainer_words_are_the_closed_form(launches, data, arch,
                                           optimizer):
    """Each rank's loss + backward words a step: the tensor-parallel
    closed form (the latents' all-gathers and reduce-scatters, the exit
    sums and the inputs' gradients, the vocab-parallel loss of both
    heads) and, on (2, 2), ZeRO-3's all-gathers and reduce-scatters of
    every leaf split over 'data' (the MLA, prefix and MTP leaves
    included) and the all-reduces of the counts and the loss."""
    want = _mesh_words(_train_cfg(arch, data), data, 2)
    assert want["all_gather"] > 0 and want["reduce_scatter"] > 0
    for r in _train(launches, data, arch, optimizer):
        for step in r["words"]:
            assert step["loss_backward"] == want, (r["coords"],
                                                   step["loss_backward"],
                                                   want)


def test_the_cards_cut_on_1x2(launch12):
    """v3's ``--layers 1`` cut (the prefix block and the MTP block, no
    periods), the card's path: its words a step ``chip_smoke.py``'s
    closed form, and its losses one device's."""
    cfg = _train_cfg(V3, 1, layers=1)
    assert cfg.n_periods == 0 and cfg.mtp
    want = _mesh_words(cfg, 1, 2)
    losses, _ = _single(V3, "adamw", layers=1)
    for rk in launch12:
        cut = rk["cut"]
        assert not any(k[0] == "periods" for k in cut["params"])
        np.testing.assert_allclose(cut["losses"], losses, rtol=LOSS_RTOL)
        for step in cut["words"]:
            assert step["loss_backward"] == want, (step, want)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("data", [1, 2])
def test_muon_routes_every_matrix_leaf(launches, data, arch):
    """Muon's route for each matrix leaf, the prefix's and the MTP
    block's included, as ``Muon.shard_route`` names it and the trainer
    reports it: on (2, 2) every leaf split over 'data' is gathered; on
    (1, 2) the leaves go as their specs and shapes send them (no route
    rule changed), each with words only where it is split."""
    from repro_torch.distributed.mesh import planning_mesh
    from repro_torch.models.model import Model
    from repro_torch.models.sharding import is_sharded, param_specs
    from repro_torch.optim.muon import Muon
    cfg = _train_cfg(arch, data)
    mesh = planning_mesh({"data": data, "model": 2})
    shapes = Model(cfg, torch.Generator(),
                   torch.device("meta")).stacked_shapes()
    specs = param_specs(cfg, shapes, mesh)
    opt = Muon(mode="syrk-1d", mesh=mesh, specs=specs)
    matrices = {k for k, s in shapes.items() if len(s) >= 2
                and min(s[-2:]) >= 8}
    assert any(k[0] == "prefix" for k in matrices)
    assert any(k[0] == "mtp" for k in matrices) == (arch == V3)
    for r in _train(launches, data, arch, "muon-syrk"):
        routes = r["leaf_routes"]
        assert set(routes) == {"/".join(k) for k in matrices}
        for k in matrices:
            route, words = routes["/".join(k)]
            local = tuple(n // (2 if a == "model" else data if a == "data"
                                else 1) for n, a in zip(shapes[k], specs[k]))
            assert route == opt.shard_route(local, specs[k]), k
            assert bool(words) == is_sharded(specs[k]), (k, words)
            if data > 1 and "data" in specs[k]:
                assert route == "gathered", k
        print(f"({data}, 2) {arch} routes: {routes}")


# ---------------------------------------------------------------------------
# the checkpoint
# ---------------------------------------------------------------------------
def _one_device_restore(ckpt_dir):
    """The checkpoint on one device: (step, its leaves by key, the
    params by path)."""
    from repro_torch.distributed import restore_checkpoint
    from repro_torch.launch.steps import make_optimizer
    from repro_torch.models.model import init_model
    cfg = _train_cfg(V3, 2)
    model = init_model(cfg, seed=1, device="cpu")
    opt = make_optimizer(cfg, "muon-syrk")
    like = {"params": model.stacked(), "opt": opt.init(model.stacked())}
    step, state = restore_checkpoint(ckpt_dir, like)
    return step, _leaves(state), state["params"]


def test_checkpoint_restores_on_one_device_and_on_1x2(launches, ckpt_dir):
    """The (2, 2) v3 ``muon-syrk`` run's checkpoint: restored on one
    device its parameters are the run's gathered ones bit for bit;
    restored onto (1, 2) and verified there (0 mismatches), every leaf
    gathered back (parameters, Muon's step and momentum, the prefix's
    and the MTP block's included) is the one-device restore's bit for
    bit."""
    step, whole, params = _one_device_restore(ckpt_dir)
    assert step == STEPS
    gathered = _train(launches, 2, V3, "muon-syrk")[0]["params"]
    assert gathered.keys() == params.keys()
    for k, v in gathered.items():
        assert np.array_equal(params[k].float().numpy(), v), k
    assert sum("momentum" in k for k in whole) == len(params)
    assert any("mtp" in k for k in whole) and any("prefix" in k
                                                  for k in whole)
    for rk in launches[1]:
        got = rk["restore"]
        assert got["step"] == STEPS and got["mismatches"] == 0
        assert got["leaves"].keys() == whole.keys()
        for k, v in whole.items():
            if isinstance(v, np.ndarray):
                assert np.array_equal(got["leaves"][k], v), k
            else:
                assert got["leaves"][k] == v, k


def test_reference_restores_the_mesh_checkpoint(launches, ckpt_dir):
    """``repro`` reads the (2, 2) checkpoint from a ``jax.eval_shape``
    like of its own Muon state: every leaf equal to the port's one-device
    restore."""
    import jax

    from repro.configs import get_smoke_config as j_smoke
    from repro.distributed import restore_checkpoint as j_restore
    from repro.distributed.checkpoint import _flatten as j_flatten
    from repro.models.common import MoECfg as JMoECfg
    from repro.models.model import init_params
    from repro.optim import Muon as JMuon
    del launches                    # the (2, 2) run wrote ckpt_dir
    _, whole, _ = _one_device_restore(ckpt_dir)
    cj = j_smoke(V3)
    cj = dataclasses.replace(cj, fsdp_params=True, moe=JMoECfg(
        cj.moe.n_experts, cj.moe.n_experts, cj.moe.n_shared,
        cj.moe.d_ff_expert))
    like = jax.eval_shape(lambda: init_params(cj, jax.random.key(0)))
    jstep, back = j_restore(ckpt_dir, {"params": like, "opt": jax.eval_shape(
        JMuon().init, like)})
    assert jstep == STEPS
    ref = dict(j_flatten(back))
    assert ref.keys() == whole.keys()
    for k, v in whole.items():
        a = np.asarray(ref[k], np.float32) if isinstance(v, np.ndarray) \
            else int(ref[k])
        assert np.array_equal(a, v) if isinstance(v, np.ndarray) \
            else a == v, k


# ---------------------------------------------------------------------------
# the split rule
# ---------------------------------------------------------------------------
def test_a_latent_that_does_not_split_raises_before_any_rank_starts(
        monkeypatch):
    """A model axis that divides the heads but not a latent (a rope key
    2 wide on 4 ranks) would split MLA's weights only in part: the
    trainer raises ``ValueError`` naming the mixer and its leaves before
    any weight is drawn or any rank starts, and so does
    ``check_head_split``."""
    from repro_torch.distributed.mesh import planning_mesh
    from repro_torch.models.model import Model, check_head_split
    from repro_torch.models.sharding import param_specs
    cfg = _train_cfg(V3, 1, layers=1)
    cfg = dataclasses.replace(cfg, mla=MLACfg(**{
        **dataclasses.asdict(cfg.mla), "rope_head_dim": 2}))

    def no_init(*a, **kw):
        raise AssertionError("weights drawn before the refusal")
    monkeypatch.setattr(ttrain, "init_model", no_init)
    monkeypatch.setattr(ttrain, "run_ranks", no_init)
    monkeypatch.setattr(ttrain, "build_config", lambda args: cfg)
    with pytest.raises(ValueError, match="mixer split only in part") as e:
        ttrain.train(_args(devices=4, max_model=4))
    assert "w_kr" in str(e.value) and "w_dkv" in str(e.value)
    shapes = Model(cfg, torch.Generator(),
                   torch.device("meta")).stacked_shapes()
    with pytest.raises(ValueError, match="prefix/b0/mixer split only"):
        check_head_split(cfg, param_specs(cfg, shapes, planning_mesh(
            {"data": 1, "model": 4})), 4)
    split = check_head_split(cfg, param_specs(cfg, shapes, planning_mesh(
        {"data": 1, "model": 2})), 2)
    assert split == {("prefix", "b0", "mixer"): True,
                     ("prefix", "b0", "mlp"): True,
                     ("mtp", "mixer"): True, ("mtp", "mlp"): True}
