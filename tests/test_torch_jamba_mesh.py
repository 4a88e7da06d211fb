"""jamba on a (data, model) mesh of gloo CPU ranks: the tensor-parallel
Mamba mixer and routed MoE, ``fsdp_params`` over their weights, Muon on
the split expert stacks, and a mesh checkpoint.

Two launches, 4 ranks on (2, 2) first and 2 ranks on (1, 2) after it,
each running every case of its mesh in turn:

* the MoE layer (``models.moe.MoE``, the reference's
  ``tests/test_moe_impls._cfg(shared=1)``: 8 experts, top-2, one shared
  expert) tensor-parallel over f, each data rank on its rows:
  - in f32 against the reference's ``moe_apply`` under its own (2, 2)
    ``shard_map`` (a subprocess of 4 fake CPU devices, as
    ``tests/test_moe_impls.py`` runs it), gather and capacity forms, at
    that test's 2e-3 (the port's (1, 2) capacity form against the
    reference's one-device form: the capacity is a data rank's);
  - in bf16 against the port's one-device layer on the same rows, with
    the gradients of x, the router, ``wi`` / ``wg`` / ``wo`` and the
    shared expert's, in the gather form and in the capacity form with a
    router skewed so that expert 0's window overflows; on (2, 2) the
    stacks are also split over 'data' (gathered where used, their
    gradients reduce-scattered: the sum over the data rows'); every
    rank of a data row reads the same group sizes, the one-device
    layer's;
* the Mamba mixer on (1, 2), at s = 32 (the sequential scan) and 128
  (the chunked one): the output and gradients against one device, the
  ``conv_b`` / ``dt_bias`` / ``d_skip`` gradients whole and equal on
  every rank;
* the in_proj rule (``sharding.Parts``): ``shard_leaf`` then
  ``gather_leaf`` gives the whole matrix back, a rank's block is its u
  and z channels, and the NS of the permuted matrix the ranks hold,
  re-split, is the rank's block of the NS of the whole, through Muon's
  1D and gathered routes;
* the trainer (``launch.train._run``) on jamba's smoke width, cut as the
  card's phase 22 cuts it (layers 2-3 of the period: Mamba + dense MLP,
  attention + MoE), every expert routed (top_k = n_experts: no routing
  discontinuity), ``fsdp_params`` where 'data' > 1, AdamW and
  ``muon-syrk``, 3 steps from the port's seed-0 init, against the port's
  one-device run: every rank's losses identical, within ``LOSS_RTOL``
  a step, the gathered parameters within ``PARAM_TOL`` in relative
  Frobenius norm (``test_torch_dense_train_mesh.py``'s bounds); each
  rank's loss + backward words a step the closed forms of the
  tensor-parallel all-reduces and, on (2, 2), of ZeRO-3's all-gathers
  and reduce-scatters; Muon's route for every matrix leaf;
* the (2, 2) ``muon-syrk`` run's checkpoint restored onto (1, 2) (and
  verified there), onto one device and by ``repro``: every leaf,
  parameters and Muon's momentum, bit-equal to the one-device restore
  and to the (2, 2) run's gathered parameters.

A published top-2 routing is held once, beside: step 0's loss on (1, 2)
against one device, whose gap (routing flips at near-ties) is printed
under ``-s`` and bounded by ``TOP2_STEP0_RTOL``.
"""
import dataclasses
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.distributed.launch import run_ranks
from repro_torch.launch import train as ttrain
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models.common import ArchConfig, BlockSpec, MoECfg
from test_torch_hygiene import limit_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")
ARCH = "jamba-v0.1-52b"
STEPS = 3
LOSS_RTOL = 5e-4
PARAM_TOL = 2e-3            # the whole model, relative Frobenius norm
#: the reference's tensor-parallel MoE test's bound (rtol and atol)
REF_TOL = 2e-3
#: bf16 ulps of the largest entry (tests/test_torch_jamba.py's bound)
ULPS = 4
#: a bf16 gradient leaf against one device, of its largest entry
#: (tests/test_torch_jamba_train.py's LEAF_RTOL)
LEAF_RTOL = 3e-2
#: f32 against f32 through another summation order, of the largest entry
F32_RTOL = 2e-4
#: step 0 with the published top-2 routing, (1, 2) against one device:
#: the bound chip_smoke.py's phase 22 holds its mesh part to
TOP2_STEP0_RTOL = 1e-4
#: (data, model, optimizer); the (2, 2) muon-syrk run writes the
#: checkpoint
TRAIN_CASES = [(2, 2, "adamw"), (2, 2, "muon-syrk"), (1, 2, "adamw"),
               (1, 2, "muon-syrk")]
#: the layer cases: (form, rows a data rank); the capacity case's router
#: sends every token's first choice to expert 0, whose window overflows
MOE_FORMS = ("gather", "capacity")


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
def _moe_cfg():
    """The port's twin of the reference's ``test_moe_impls._cfg(e=8, k=2,
    f=32, d=16, shared=1)``."""
    return ArchConfig(
        name="moe-test", n_layers=2, d_model=16, n_heads=2, n_kv_heads=2,
        d_ff=32, vocab=64, act="silu",
        pattern=(BlockSpec(mixer="attn", mlp="moe"),),
        moe=MoECfg(n_experts=8, top_k=2, n_shared=1, d_ff_expert=32))


def _train_cfg(data, top2=False):
    """jamba's smoke width at layers 2-3 of its period (the card's cut),
    every expert routed unless ``top2``; ``fsdp_params`` where
    ``data`` > 1."""
    cfg = get_smoke_config(ARCH)
    pattern = cfg.pattern[2:4]
    moe = cfg.moe if top2 else dataclasses.replace(
        cfg.moe, top_k=cfg.moe.n_experts)
    return dataclasses.replace(cfg, n_layers=len(pattern), pattern=pattern,
                               moe=moe, fsdp_params=data > 1)


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


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------
def _moe_layer(params, dtype, skew=False):
    """A one-device MoE of ``_moe_cfg`` holding ``params`` (the
    reference's init, as numpy) in ``dtype``; with ``skew`` the router's
    expert-0 column raised so that every token picks it first."""
    cfg = _moe_cfg()
    layer = tmoe.MoE(cfg, torch.Generator(), torch.device("cpu"))
    with torch.no_grad():
        for name, p in layer.named_parameters():
            w = torch.tensor(params["p/" + name.replace(".", "/")])
            p.data = w.to(torch.float32 if name == "router" else dtype)
        if skew:
            layer.router[:, 0] += 20.0 / cfg.d_model
    return layer


def _record_sizes(sizes):
    """Spy on ``moe._sort_by_expert``: each call's group sizes appended
    to ``sizes``; returns the undo."""
    real = tmoe._sort_by_expert

    def spy(tope, n_experts):
        out = real(tope, n_experts)
        sizes.append(out[3].tolist())
        return out
    tmoe._sort_by_expert = spy
    return lambda: setattr(tmoe, "_sort_by_expert", real)


def _moe_run(layer, x, form, g=None):
    """(out, {grad name: grad}, group sizes) of ``layer`` on x (T, d);
    with a cotangent ``g`` the gradients of x and every parameter."""
    sizes = []
    undo = _record_sizes(sizes)
    try:
        xi = x.clone().requires_grad_(g is not None)
        out = tmoe.moe_local(_moe_cfg(), layer, xi, impl=form)
        grads = {}
        if g is not None:
            (out.float() * g).sum().backward()
            grads = {"x": xi.grad}
            grads.update({n: p.grad for n, p in layer.named_parameters()})
    finally:
        undo()
    return out.detach(), grads, sizes


def _shard_moe(layer, mesh):
    """``layer`` cut to this rank's blocks under the MoE's specs, as
    ``Model.shard_`` cuts a block's: ``tp`` on 'model', the stacks (and
    the shared expert's weights) split over 'data' too where it is > 1
    (``fsdp_params``).  Returns the specs by parameter name."""
    from repro_torch.models.sharding import leaf_spec, shard_leaf
    cfg = dataclasses.replace(_moe_cfg(),
                              fsdp_params=mesh.shape["data"] > 1)
    specs = {}
    with torch.no_grad():
        for name, p in layer.named_parameters():
            owner = layer.shared if name.startswith("shared.") else layer
            leaf = name.split(".")[-1]
            spec = leaf_spec(cfg, leaf, tuple(p.shape), mesh)
            specs[name] = spec
            p.data = shard_leaf(p.data, spec, mesh).clone()
            if "data" in spec and mesh.shape["data"] > 1:
                owner.fsdp[leaf] = (mesh.comm("data"), spec.index("data"))
    layer.tp = layer.shared.tp = mesh.comm("model")
    return specs


def _moe_cases(mesh, params):
    """Every MoE case of this rank: the f32 outputs (for the reference)
    and the bf16 outputs, gradients and group sizes (for one device),
    each on this data rank's rows."""
    from repro_torch.models.sharding import gather_leaf
    r, d = mesh.index("data"), mesh.shape["data"]
    x = torch.from_numpy(params["x"])                     # (4, 64, 16)
    rows = x[r * 4 // d:(r + 1) * 4 // d].reshape(-1, x.shape[-1])
    out = {"f32": {}, "bf16": {}}
    for form in MOE_FORMS:
        layer = _moe_layer(params, torch.float32)
        _shard_moe(layer, mesh)
        with torch.no_grad():
            out["f32"][form] = _moe_run(layer, rows, form)[0].numpy()
    xb, g = _bf16_rows(params, r, d)
    for form in MOE_FORMS:
        layer = _moe_layer(params, torch.bfloat16, skew=form == "capacity")
        specs = _shard_moe(layer, mesh)
        y, grads, sizes = _moe_run(layer, xb, form, g)
        whole = {n: gather_leaf(v, specs[n], mesh).float().numpy()
                 if n in specs else v.float().numpy()
                 for n, v in grads.items()}
        out["bf16"][form] = {"out": y.float().numpy(), "grads": whole,
                             "sizes": sizes}
    return out


def _bf16_rows(params, r, d):
    """Data rank ``r`` of ``d``'s bf16 rows of the layer cases' input
    (2 × 64 tokens in all, +0.5 so that the skewed router's expert 0
    wins every token) and cotangent."""
    gen = np.random.default_rng(11)
    x = gen.standard_normal((2, 64, 16)).astype(np.float32) + 0.5
    g = gen.standard_normal((2, 64, 16)).astype(np.float32)
    sl = slice(r * 2 // d, (r + 1) * 2 // d)
    return (torch.from_numpy(x[sl].reshape(-1, 16)).to(torch.bfloat16),
            torch.from_numpy(g[sl].reshape(-1, 16)))


_REF_CHILD = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, %(src)r)
from repro.models import moe
from tests.test_moe_impls import _cfg, _params

cfg = _cfg(e=8, k=2, f=32, d=16, shared=1)
p = _params(cfg, jax.random.key(0))
x = jax.random.normal(jax.random.key(1), (4, 64, cfg.d_model), jnp.float32)
out = {"x": np.asarray(x),
       "local_capacity": np.asarray(moe.moe_apply(cfg, p, x,
                                                  impl="capacity"))}
for path, leaf in jax.tree_util.tree_flatten_with_path(p)[0]:
    out["p/" + "/".join(k.key for k in path)] = np.asarray(leaf, np.float32)

from repro.compat import make_mesh, use_mesh
mesh = make_mesh((2, 2), ("data", "model"), axis_types="auto")
with use_mesh(mesh):
    for impl in ("gather", "capacity"):
        out["tp_" + impl] = np.asarray(jax.jit(
            lambda pp, xx, impl=impl: moe.moe_apply(cfg, pp, xx,
                                                    impl=impl))(p, x))
np.savez(%(path)r, **out)
print("REF-TP-MOE-OK")
"""


@pytest.fixture(scope="module")
def reference_moe(tmp_path_factory):
    """The reference's MoE under its (2, 2) ``shard_map`` on 4 fake CPU
    devices (a subprocess: the XLA flag is the process's), with its
    params, input and one-device capacity output, as numpy."""
    path = str(tmp_path_factory.mktemp("ref_moe") / "ref.npz")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + ROOT
    res = subprocess.run(
        [sys.executable, "-c", _REF_CHILD % {
            "src": os.path.join(ROOT, "src"), "path": path}],
        capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
    assert "REF-TP-MOE-OK" in res.stdout, res.stderr[-3000:]
    with np.load(path) as f:
        return dict(f)


# ---------------------------------------------------------------------------
# the Mamba mixer and the in_proj rule (on (1, 2))
# ---------------------------------------------------------------------------
MAMBA_SEQS = (32, 128)


def _mamba_inputs(s):
    cfg = get_smoke_config(ARCH)
    gen = np.random.default_rng(s)
    x = gen.standard_normal((2 if s == 32 else 1, s, cfg.d_model))
    g = gen.standard_normal(x.shape)
    mixer = tssm.Mamba(cfg, torch.Generator().manual_seed(s),
                       torch.device("cpu"))
    with torch.no_grad():      # non-trivial per-channel vectors
        for name in ("conv_b", "dt_bias", "d_skip"):
            p = getattr(mixer, name)
            p.add_(torch.from_numpy(gen.standard_normal(p.shape) * 0.1)
                   .float())
    return cfg, mixer, torch.from_numpy(x).to(torch.bfloat16), \
        torch.from_numpy(g).float()


def _mamba_run(cfg, mixer, x, g):
    xi = x.clone().requires_grad_()
    out, _ = tssm.mamba_mixer(cfg, mixer, xi)
    (out.float() * g).sum().backward()
    grads = {"x": xi.grad}
    grads.update({n: p.grad for n, p in mixer.named_parameters()})
    return out.detach(), grads


def _mamba_cases(mesh):
    from repro_torch.models.sharding import (gather_leaf, leaf_spec,
                                             shard_leaf)
    out = {}
    for s in MAMBA_SEQS:
        cfg, mixer, x, g = _mamba_inputs(s)
        specs = {}
        with torch.no_grad():
            for name, p in mixer.named_parameters():
                specs[name] = leaf_spec(cfg, name, tuple(p.shape), mesh)
                p.data = shard_leaf(p.data, specs[name], mesh).clone()
        mixer.tp = mesh.comm("model")
        y, grads = _mamba_run(cfg, mixer, x, g)
        out[s] = {"out": y.float().numpy(),
                  "local": {n: v.float().numpy() for n, v in grads.items()},
                  "grads": {n: gather_leaf(v, specs[n], mesh).float().numpy()
                            if n in specs else v.float().numpy()
                            for n, v in grads.items()}}
    return out


def _in_proj_case(mesh):
    """The in_proj rule on this rank: the blocks, the round trip and the
    NS of the permuted matrix through Muon's routes."""
    from repro_torch.distributed import collectives
    from repro_torch.models.sharding import (Parts, gather_leaf, leaf_spec,
                                             shard_leaf)
    from repro_torch.optim.muon import Muon, orthogonalize_reference
    cfg = get_smoke_config(ARCH)
    d, di = cfg.d_model, cfg.mamba_expand * cfg.d_model
    w = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (d, 2 * di)).astype(np.float32))
    spec = leaf_spec(cfg, "in_proj", tuple(w.shape), mesh)
    fs_spec = leaf_spec(dataclasses.replace(cfg, fsdp_params=True),
                        "in_proj", tuple(w.shape), mesh)
    blk = shard_leaf(w, spec, mesh)
    held = collectives.all_gather(blk.T.contiguous(), mesh.comm("model"))
    ns = orthogonalize_reference(w, 5)
    routes = {}
    for sp in (spec, fs_spec):
        opt = Muon(mode="syrk-1d", mesh=mesh, specs={"w": sp})
        routes[opt.shard_route(blk.shape, sp)] = \
            opt._orthogonalize_shard(blk, sp).numpy()
    return {"spec": spec, "parts": isinstance(spec[1], Parts),
            "block": blk.numpy(),
            "back": gather_leaf(blk, spec, mesh).numpy(),
            "ns_of_held": shard_leaf(
                orthogonalize_reference(held.T.contiguous(), 5),
                (None, "model"), mesh).numpy(),
            "ns_block": shard_leaf(ns, spec, mesh).numpy(),
            "routes": routes}


# ---------------------------------------------------------------------------
# the trainer on the ranks
# ---------------------------------------------------------------------------
def _train_case(mesh, optimizer, ckpt_dir=None):
    """``train._run`` on this mesh from the port's seed-0 init: losses,
    words, Muon's routes, group sizes and the gathered parameters."""
    from repro_torch.models.sharding import gather_leaf
    data, model_ax = mesh.shape["data"], mesh.shape["model"]
    made, init = [], ttrain.init_model

    def keep(cfg, seed, device, **kw):
        made.append(init(cfg, seed=seed, device=device, **kw))
        return made[-1]

    sizes = []
    undo = _record_sizes(sizes)
    ttrain.init_model = keep
    try:
        out = ttrain._run(_args(optimizer=optimizer,
                                devices=data * model_ax, max_model=model_ax,
                                ckpt_dir=ckpt_dir),
                          _train_cfg(data), mesh.device, mesh=mesh,
                          say=lambda line: None)
    finally:
        ttrain.init_model = init
        undo()
    model = made[-1]
    return {"coords": (mesh.index("data"), mesh.index("model")),
            "losses": out["losses"], "words": out["words"],
            "leaf_routes": out["leaf_routes"], "sizes": sizes,
            "params": {k: gather_leaf(v, model.specs[k], mesh).float()
                       .numpy() for k, v in model.stacked().items()}}


def _top2_step0(mesh):
    """Step 0's loss of the published top-2 routing on this mesh."""
    out = ttrain._run(_args(optimizer="adamw", steps=1,
                            devices=mesh.shape["model"], max_model=2),
                      _train_cfg(1, top2=True), mesh.device, mesh=mesh,
                      say=lambda line: None)
    return out["losses"][0]


def _restore_case(mesh, ckpt_dir):
    """The (2, 2) checkpoint restored onto this mesh's blocks and
    verified; every leaf gathered back whole."""
    from repro_torch.distributed import restore_checkpoint, verify_restored
    from repro_torch.launch.steps import make_optimizer
    from repro_torch.models.model import init_model
    from repro_torch.models.sharding import gather_leaf
    cfg = _train_cfg(mesh.shape["data"])
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


def rank_main(mesh_x, world, params, ckpt_dir):
    from repro_torch.distributed.mesh import make_mesh
    data = world // 2
    mesh = make_mesh({"data": data, "model": 2}, device="cpu")
    res = {"rank": mesh.rank, "moe": _moe_cases(mesh, params),
           "train": {}}
    for d, m, optimizer in TRAIN_CASES:
        if d == data:
            res["train"][optimizer] = _train_case(
                mesh, optimizer,
                ckpt_dir if (data, optimizer) == (2, "muon-syrk") else None)
    if data == 1:
        res["mamba"] = _mamba_cases(mesh)
        res["in_proj"] = _in_proj_case(mesh)
        res["restore"] = _restore_case(mesh, ckpt_dir)
        res["top2_step0"] = _top2_step0(mesh)
    return res


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("jamba_mesh_ckpt"))


@pytest.fixture(scope="module")
def launch22(reference_moe, ckpt_dir):
    return run_ranks("test_torch_jamba_mesh:rank_main", 4, device="cpu",
                     paths=[TESTS], timeout=900,
                     kwargs={"world": 4, "params": reference_moe,
                             "ckpt_dir": ckpt_dir})


@pytest.fixture(scope="module")
def launch12(launch22, reference_moe, ckpt_dir):
    return run_ranks("test_torch_jamba_mesh:rank_main", 2, device="cpu",
                     paths=[TESTS], timeout=900,
                     kwargs={"world": 2, "params": reference_moe,
                             "ckpt_dir": ckpt_dir})


@pytest.fixture(scope="module")
def launches(launch12, launch22):
    return {1: launch12, 2: launch22}


# ---------------------------------------------------------------------------
# the one-device oracles (this process)
# ---------------------------------------------------------------------------
_SINGLE = {}


def _single(optimizer):
    """The port's one-device trainer run: (losses, whole params)."""
    if optimizer not in _SINGLE:
        made, init = [], ttrain.init_model

        def keep(cfg, seed, device, **kw):
            made.append(init(cfg, seed=seed, device=device, **kw))
            return made[-1]
        ttrain.init_model = keep
        try:
            out = ttrain._run(_args(optimizer=optimizer), _train_cfg(1),
                              torch.device("cpu"), say=lambda line: None)
        finally:
            ttrain.init_model = init
        _SINGLE[optimizer] = (out["losses"], {
            k: v.float().numpy() for k, v in made[-1].stacked().items()})
    return _SINGLE[optimizer]


def _moe_one_device(params, form, r, d):
    """The one-device bf16 layer on data rank ``r`` of ``d``'s rows."""
    xb, g = _bf16_rows(params, r, d)
    layer = _moe_layer(params, torch.bfloat16, skew=form == "capacity")
    y, grads, sizes = _moe_run(layer, xb, form, g)
    return y.float().numpy(), {n: v.float().numpy()
                               for n, v in grads.items()}, sizes


# ---------------------------------------------------------------------------
# the closed forms
# ---------------------------------------------------------------------------
def _ar(n, P):
    """The words of one all-reduce of n elements over P ranks, as
    ``collectives.all_reduce`` counts them."""
    return 2 * n * (P - 1) // P


def _tp_words(cfg, tokens, P):
    """A rank's loss + backward all-reduce words a step on a (data, P)
    mesh, its data rank's ``tokens`` a step: the vocab-parallel embed
    rows; in each block the mixer's and the MLP's exit sums forward
    (Mamba also its ``x_proj`` sum), their ``copy_to_group`` gradients
    backward (the block's input, Mamba's B/C/dt projection and its
    three per-channel vectors, the MoE's router); each forward sum again
    in the per-period recompute, but for the period's last exit (the
    non-reentrant checkpoint stops its recompute at the last tensor the
    backward needs).  The loss's are :func:`_loss_words`."""
    d = cfg.d_model
    di = cfg.mamba_expand * d
    R = max(d // 16, 1) + 2 * cfg.mamba_d_state
    T = tokens
    words = _ar(T * d, P)
    for _ in range(cfg.n_periods):
        fwd, bwd = [], []
        for spec in cfg.pattern:
            if spec.mixer == "mamba":
                fwd += [_ar(T * R, P), _ar(T * d, P)]
                bwd += [_ar(T * d, P), _ar(T * R, P)] + [_ar(di, P)] * 3
            else:
                fwd += [_ar(T * d, P)]
                bwd += [_ar(T * d, P)]
            fwd += [_ar(T * d, P)]
            bwd += [_ar(T * d, P)]
            if spec.mlp == "moe":
                bwd += [_ar(d * cfg.moe.n_experts, P)]
        words += 2 * sum(fwd) - fwd[-1] + sum(bwd)
    return words


def _loss_words(T_rows, seq, chunk, d, P):
    """The vocab-parallel loss's all-reduce words: per chunk of c
    positions over the data rank's rows, the max, the sum of
    exponentials and the label's logit (forward and recompute) and the
    chunk input's gradient."""
    n = max(seq // chunk, 1)
    c = seq // n
    per = T_rows * c
    return n * (2 * 3 * _ar(per, P) + _ar(per * d, P))


def _fsdp_words(cfg, data, model):
    """A rank's loss + backward words a step over 'data', from the shapes
    and specs alone (``test_torch_dense_train_mesh.py``'s rule): each
    block split over 'data' all-gathered (D − 1) times its size, twice
    for a layer's weights (the forward and the per-period recompute),
    once for embed and unembed, and its gradient reduce-scattered
    once."""
    from repro_torch.models.model import Model
    from repro_torch.models.sharding import axis_size, param_specs
    shapes = Model(cfg, torch.Generator(),
                   torch.device("meta")).stacked_shapes()
    specs = param_specs(cfg, shapes, {"data": data, "model": model})
    sizes = {"data": data, "model": model}
    gathers = scatters = 0
    for k, shape in shapes.items():
        if data == 1 or "data" not in specs[k]:
            continue
        block = math.prod(shape) // math.prod(
            axis_size(sizes, a) for a in specs[k] if a is not None)
        gathers += (data - 1) * block * (2 if k[0] == "periods" else 1)
        scatters += (data - 1) * block
    return {"all_gather": gathers, "reduce_scatter": scatters}


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("data", [1, 2])
@pytest.mark.parametrize("form", MOE_FORMS)
def test_moe_layer_matches_the_reference_shard_map(launches, reference_moe,
                                                   data, form):
    """f32, each data rank's rows: against the reference's (2, 2)
    ``shard_map`` output (the (1, 2) capacity form against its
    one-device form, whose capacity is the whole batch's)."""
    want = reference_moe["tp_" + form]
    if (data, form) == (1, "capacity"):
        want = reference_moe["local_capacity"]
    for rk in launches[data]:
        r = rk["rank"] // 2
        rows = want[r * 4 // data:(r + 1) * 4 // data].reshape(-1, 16)
        np.testing.assert_allclose(rk["moe"]["f32"][form], rows,
                                   rtol=REF_TOL, atol=REF_TOL)


@pytest.mark.parametrize("data", [1, 2])
@pytest.mark.parametrize("form", MOE_FORMS)
def test_moe_layer_matches_one_device_with_gradients(launches,
                                                     reference_moe, data,
                                                     form):
    """bf16, each data rank's rows: the output within ``ULPS`` of the
    one-device layer's largest entry, each gradient within
    ``LEAF_RTOL`` (the stacks and the shared expert's, split over 'data'
    on (2, 2), against the sum over the data rows; x and the router, a
    data rank's own, against its rows'); every rank of a data row reads
    the one-device group sizes, and the capacity case drops rows."""
    one = [_moe_one_device(reference_moe, form, r, data)
           for r in range(data)]
    for rk in launches[data]:
        r = rk["rank"] // 2
        got = rk["moe"]["bf16"][form]
        y, grads, sizes = one[r]
        assert got["sizes"] == sizes, (rk["rank"], got["sizes"], sizes)
        if form == "capacity":
            cap = tmoe._capacity(y.shape[0] * 2, 8)
            assert max(sizes[0]) > cap, (sizes, cap)
        _close(got["out"], y, f"{form} out rank {rk['rank']}",
               ULPS * 2.0 ** -8)
        for name, g in got["grads"].items():
            want = grads[name] if name in ("x", "router") else \
                sum(o[1][name] for o in one)
            _close(g, want, f"{form} d{name} rank {rk['rank']}", LEAF_RTOL)


# ---------------------------------------------------------------------------
# Mamba and the in_proj rule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s", MAMBA_SEQS)
def test_mamba_mixer_matches_one_device(launch12, s):
    """(1, 2): the output within ``ULPS`` of one device's largest entry,
    every gradient within ``LEAF_RTOL``; the replicated per-channel
    vectors' gradients whole (not one rank's slice) and the same on
    both ranks."""
    cfg, mixer, x, g = _mamba_inputs(s)
    y, grads = _mamba_run(cfg, mixer, x, g)
    for rk in launch12:
        got = rk["mamba"][s]
        _close(got["out"], y.float(), f"s {s} out", ULPS * 2.0 ** -8)
        for name, want in grads.items():
            _close(got["grads"][name], want.float(), f"s {s} d{name}",
                   LEAF_RTOL)
    for name in ("conv_b", "dt_bias", "d_skip"):
        a, b = (rk["mamba"][s]["local"][name] for rk in launch12)
        assert a.shape == tuple(getattr(mixer, name).shape)
        assert np.array_equal(a, b), name


def test_in_proj_rule(launch12):
    """Each rank holds the u and z of its channels; the round trip gives
    the whole matrix back; NS of the matrix the ranks hold (its columns
    permuted), re-split, is each rank's block of NS of the whole, on
    Muon's 1D route and on its gathered one (the spec with 'data')."""
    cfg = get_smoke_config(ARCH)
    d, di = cfg.d_model, cfg.mamba_expand * cfg.d_model
    w = np.random.default_rng(5).standard_normal((d, 2 * di)) \
        .astype(np.float32)
    for rk in launch12:
        got, r = rk["in_proj"], rk["rank"]
        assert got["parts"] and got["spec"] == (None, "model")
        h = di // 2
        want = np.concatenate([w[:, r * h:(r + 1) * h],
                               w[:, di + r * h:di + (r + 1) * h]], axis=1)
        assert np.array_equal(got["block"], want)
        assert np.array_equal(got["back"], w)
        _close(got["ns_of_held"], got["ns_block"], f"rank {r} NS",
               F32_RTOL)
        assert set(got["routes"]) == {"1d", "gathered"}, got["routes"]
        for route, blk in got["routes"].items():
            _close(blk, got["ns_block"], f"rank {r} Muon {route}", F32_RTOL)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------
def _train(launches, data, optimizer):
    return [rk["train"][optimizer] for rk in launches[data]]


@pytest.mark.parametrize("data,model,optimizer", TRAIN_CASES)
def test_trainer_ranks_agree_and_follow_one_device(launches, data, model,
                                                   optimizer):
    ranks = _train(launches, data, optimizer)
    losses = ranks[0]["losses"]
    assert len(losses) == STEPS and all(np.isfinite(losses))
    for r in ranks[1:]:
        assert r["losses"] == losses, "ranks disagree"
    want, params = _single(optimizer)
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL)
    got = ranks[0]["params"]
    assert got.keys() == params.keys()
    diff = sum(float(np.sum((got[k] - p) ** 2)) for k, p in params.items())
    norm = sum(float(np.sum(p ** 2)) for p in params.values())
    print(f"({data}, {model}) {optimizer}: losses {losses} vs {want}; "
          f"params rel {(diff / norm) ** 0.5:.3g}")
    assert diff <= PARAM_TOL ** 2 * norm, (diff / norm) ** 0.5
    for r in ranks:          # every expert routed: all T tokens each
        assert r["sizes"] and all(s == r["sizes"][0] for s in r["sizes"])


@pytest.mark.parametrize("data,model,optimizer", TRAIN_CASES)
def test_trainer_words_are_the_closed_form(launches, data, model,
                                           optimizer):
    """Each rank's loss + backward words a step: the tensor-parallel
    all-reduces (and over 'data' the count and the loss) and, on (2, 2),
    ZeRO-3's all-gathers and reduce-scatters of the blocks."""
    cfg = _train_cfg(data)
    args = _args()
    rows = args.global_batch // data
    want = {"all_reduce": _tp_words(cfg, rows * args.seq_len, model)
            + _loss_words(rows, args.seq_len, args.loss_chunk,
                          cfg.d_model, model)
            + (2 * _ar(1, data) if data > 1 else 0)}
    want.update({k: v for k, v in _fsdp_words(cfg, data, model).items()
                 if v})
    if data > 1:
        assert want["all_gather"] > 0
    for r in _train(launches, data, optimizer):
        for step in r["words"]:
            assert step["loss_backward"] == want, (r["coords"],
                                                   step["loss_backward"],
                                                   want)


@pytest.mark.parametrize("data", [1, 2])
def test_muon_routes_every_matrix_leaf(launches, data):
    """Muon's route for each matrix leaf, as ``Muon.shard_route`` names
    it and the trainer reports it: on (2, 2) every leaf split over
    'data' is gathered; on (1, 2) the split expert stacks and Mamba
    leaves go as their specs and shapes send them (no route rule
    changed), each with words only where it is split."""
    from repro_torch.distributed.mesh import planning_mesh
    from repro_torch.models.model import Model
    from repro_torch.models.sharding import is_sharded, param_specs
    from repro_torch.optim.muon import Muon
    cfg = _train_cfg(data)
    mesh = planning_mesh({"data": data, "model": 2})
    model = Model(cfg, torch.Generator(), torch.device("meta"))
    shapes = model.stacked_shapes()
    specs = param_specs(cfg, shapes, mesh)
    opt = Muon(mode="syrk-1d", mesh=mesh, specs=specs)
    for r in _train(launches, data, "muon-syrk"):
        routes = r["leaf_routes"]
        matrices = {k for k, s in shapes.items() if len(s) >= 2
                    and min(s[-2:]) >= 8}
        assert set(routes) == {"/".join(k) for k in matrices}
        for k in matrices:
            route, words = routes["/".join(k)]
            local = tuple(n // (2 if a == "model" else data if a == "data"
                                else 1) for n, a in zip(shapes[k], specs[k]))
            assert route == opt.shard_route(local, specs[k]), k
            assert bool(words) == is_sharded(specs[k]), (k, words)
            if data > 1 and "data" in specs[k]:
                assert route == "gathered", k
        stacks = [routes["/".join(k)][0] for k in matrices
                  if k[-2:] in (("mlp", "wi"), ("mlp", "wo"))
                  and len(shapes[k]) == 4]
        assert stacks, routes
        print(f"({data}, 2) routes: {routes}")


def test_top2_step0_within_its_bound(launch12):
    """The published top-2 routing: step 0's loss on (1, 2) against one
    device; a near-tie routing flip moves it, so the gap is printed and
    held to ``TOP2_STEP0_RTOL``."""
    want = ttrain._run(_args(optimizer="adamw", steps=1),
                       _train_cfg(1, top2=True), torch.device("cpu"),
                       say=lambda line: None)["losses"][0]
    for rk in launch12:
        rel = abs(rk["top2_step0"] - want) / abs(want)
        print(f"top-2 step 0: {rk['top2_step0']} vs one device {want}: "
              f"rel {rel:.3g}")
        assert rel <= TOP2_STEP0_RTOL


# ---------------------------------------------------------------------------
# the checkpoint
# ---------------------------------------------------------------------------
def _one_device_restore(ckpt_dir):
    """The checkpoint on one device: (step, its leaves by key, the
    params by path)."""
    from repro_torch.distributed import restore_checkpoint
    from repro_torch.launch.steps import make_optimizer
    from repro_torch.models.model import init_model
    cfg = _train_cfg(2)
    model = init_model(cfg, seed=1, device="cpu")
    opt = make_optimizer(cfg, "muon-syrk")
    like = {"params": model.stacked(), "opt": opt.init(model.stacked())}
    step, state = restore_checkpoint(ckpt_dir, like)
    return step, _leaves(state), state["params"]


def test_checkpoint_restores_on_one_device_and_on_1x2(launches, ckpt_dir):
    """The (2, 2) ``muon-syrk`` run's checkpoint: restored on one device
    its parameters are the run's gathered ones bit for bit; restored
    onto (1, 2) and verified there (0 mismatches), every leaf gathered
    back (parameters, Muon's step and momentum, in_proj under its rule)
    is the one-device restore's bit for bit."""
    step, whole, params = _one_device_restore(ckpt_dir)
    assert step == STEPS
    gathered = _train(launches, 2, "muon-syrk")[0]["params"]
    assert gathered.keys() == params.keys()
    for k, v in gathered.items():
        assert np.array_equal(params[k].float().numpy(), v), k
    assert sum("momentum" in k for k in whole) == len(params)
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

    from repro.distributed import restore_checkpoint as j_restore
    from repro.distributed.checkpoint import _flatten as j_flatten
    from repro.optim import Muon as JMuon
    del launches                    # the (2, 2) run wrote ckpt_dir
    _, whole, _ = _one_device_restore(ckpt_dir)
    params_like = _jax_like()
    jstep, back = j_restore(ckpt_dir, {"params": params_like,
                                       "opt": jax.eval_shape(
                                           JMuon().init, params_like)})
    assert jstep == STEPS
    ref = dict(j_flatten(back))
    assert ref.keys() == whole.keys()
    for k, v in whole.items():
        a = np.asarray(ref[k], np.float32) if isinstance(v, np.ndarray) \
            else int(ref[k])
        assert np.array_equal(a, v) if isinstance(v, np.ndarray) \
            else a == v, k


def _jax_like():
    """The reference's smoke init as a ``jax.eval_shape`` tree, cut and
    routed as :func:`_train_cfg`."""
    import jax

    from repro.configs import get_smoke_config as jcfg
    from repro.models.common import MoECfg as JMoECfg
    from repro.models.model import init_params
    cfg = _train_cfg(2)
    cj = jcfg(ARCH)
    cj = dataclasses.replace(
        cj, n_layers=cfg.n_layers, pattern=cj.pattern[2:4],
        moe=JMoECfg(cj.moe.n_experts, cj.moe.n_experts, cj.moe.n_shared,
                    cj.moe.d_ff_expert))
    return jax.eval_shape(lambda: init_params(cj, jax.random.key(0)))
