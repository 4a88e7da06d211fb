"""The deepseek slice on the CPU: repro_torch's multi-head latent
attention (MLA) with its latent KV cache, the unscanned prefix blocks,
the MoE's shared experts, the multi-token-prediction (MTP) block and its
loss term, on the deepseek-v2-236b and deepseek-v3-671b smoke configs
(d_model 64, 4 heads, kv_lora 32, q_lora 48; 8 experts top-2, 1 shared;
v2: 1 dense prefix block and 2 MoE layers; v3: 1 prefix block, 3 MoE
layers and the MTP block), loaded with the reference's weights through
``from_jax_params``, against repro.

Bounds are tests/test_torch_jamba.py's, whose helpers this file imports.
- MLA and the MoE on the reference's bf16 input: ``ULPS`` bf16 ulps at
  the output's scale; the latent cache's rows the same.
- SiLU: XLA rounds each op of x / (1 + exp(-x)) to bf16, torch's fused
  SiLU rounds once (as the reference's f32 SiLU rounded to bf16 does, bit
  for bit), so a third of the activations differ by an ulp or two
  (``test_silu_rounding``), and the experts' fan-in-E weights (std
  E^-1/2) carry that to ~5 ulps of a block's output and ~0.16 of the
  hidden end to end.  The reference run with its SiLU rounded once
  (``_silu_once``: ``repro.models.moe.act_fn`` swapped while the
  reference traces; no reference file changes) is the oracle's second
  reading: the reference against itself.
- Routing is discontinuous (a one-ulp difference in the router's input
  flips a near-tie expert), so the published top-2 config is held
  teacher-forced, block by block on the input and cache of the reference
  with its SiLU rounded once, a routing difference allowed only at a
  reference gate margin below ``TIE_MARGIN``.
- End to end (prefill, decode, the server, ``lm_loss``) the smoke
  configs with every expert routed (top_k = n_experts), the port
  within ``GAP_FACTOR`` times the reference's own gap (its SiLU rounded
  once against it, or for the loss its op-by-op run against the jitted
  one), never held looser than HIDDEN_TOL / LOGIT_TOL / the loss's 2e-4
  relative (tests/test_torch_train.py).  The readings (``pytest -s``):
  port 0.0625-0.156 in the hidden against the reference's own
  0.0547-0.109; 0.047-0.089 in the logits against 0.042-0.067.
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
from repro.models import attention as jattn
from repro.models import model as jm
from repro.models import moe as jmoe
from repro.models.common import MLACfg as JMLACfg
from repro.models.common import MoECfg as JMoECfg
from repro.models.common import apply_norm as j_norm
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import counts
from repro_torch.launch import serve as tserve
from repro_torch.launch.serving_cache import ServingGramCache
from repro_torch.models import moe as tmoe
from repro_torch.models.attention import MLA, mla_cache_init
from repro_torch.models.common import BlockSpec, MLACfg, MoECfg
from repro_torch.models.model import from_jax_params, init_model, lm_loss
from test_torch_jamba import (HIDDEN_TOL, LOGIT_TOL, MAX_NEW, N_REQ, S_MAX,
                              SLOTS, TIE_MARGIN, _all_experts, _gate_margin,
                              _load, _margin, _np, _recorded, _ref_logits, _t,
                              _tokens, _ulps_close, _within_gap)
from test_torch_hygiene import limit_torch_threads  # noqa: F401

ARCHS = ["deepseek-v2-236b", "deepseek-v3-671b"]
#: the published widths: (layers, d_model, vocab, experts, top-k, shared)
PUBLISHED = {"deepseek-v2-236b": (60, 5120, 102400, 160, 6, 2),
             "deepseek-v3-671b": (61, 7168, 129280, 256, 8, 1)}
LOSS_RTOL = 2e-4      # tests/test_torch_train.py
CPU = torch.device("cpu")


def _build_pair(arch, every_expert=False):
    """(reference config, its ``init_params``, the port's config, the
    port's model on those weights)."""
    jcfg, cfg = j_smoke(arch), get_smoke_config(arch)
    if every_expert:
        jcfg, cfg = _all_experts(jcfg, JMoECfg), _all_experts(cfg, MoECfg)
    params = jm.init_params(jcfg, jax.random.key(0))
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    return jcfg, params, cfg, model


@pytest.fixture(scope="module")
def pair():
    """``_build_pair(arch, every_expert=False)``, each built once per
    module."""
    return functools.lru_cache(maxsize=None)(_build_pair)


def _silu_once(x):
    """SiLU in f32, rounded once to x's dtype: torch's bf16 SiLU."""
    return jax.nn.silu(x.astype(jnp.float32)).astype(x.dtype)


def _traced(fn, once):
    """``fn``, with ``once`` the reference's ``act_fn`` giving
    :func:`_silu_once` while it runs (so while jit traces it)."""
    if not once:
        return fn

    def run(*args, **kw):
        act = jmoe.act_fn
        jmoe.act_fn = lambda name: _silu_once if name == "silu" else \
            act(name)
        try:
            return fn(*args, **kw)
        finally:
            jmoe.act_fn = act
    return run


@functools.lru_cache(maxsize=None)
def _jitted(jcfg, once=False):
    """The reference's prefill and decode step, jitted whole; ``once``:
    with its SiLU rounded once."""
    return (jax.jit(_traced(functools.partial(jm.prefill, jcfg), once),
                    static_argnames=("s_max", "return_hidden")),
            jax.jit(_traced(functools.partial(jm.decode_step, jcfg), once)))


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch, which):
    """Field by field."""
    get_t, get_j = (get_smoke_config, j_smoke) if which == "smoke" else \
        (get_config, j_full)
    cfg, jcfg = get_t(arch), get_j(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.n_periods == jcfg.n_periods
    if which == "full":
        assert (cfg.n_layers, cfg.d_model, cfg.vocab, cfg.moe.n_experts,
                cfg.moe.top_k, cfg.moe.n_shared) == PUBLISHED[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_parameters_follow_the_reference_tree(pair, arch):
    """Every leaf in the reference's order and shape (``mtp``,
    ``mtp_norm``, ``periods``, ``prefix`` where the reference sorts
    them), the f32 leaves f32, the values the reference's."""
    jcfg, params, cfg, model = pair(arch)
    ref = {tuple(getattr(k, "key", k) for k in path): leaf for path, leaf
           in jax.tree_util.tree_flatten_with_path(params)[0]}
    shapes = model.stacked_shapes()
    assert list(shapes) == list(ref)
    assert shapes == {k: tuple(v.shape) for k, v in ref.items()}
    tops = list(dict.fromkeys(k[0] for k in ref))
    assert tops == sorted(params)
    assert ("mtp" in tops) == ("mtp_norm" in tops) == cfg.mtp
    tree, stacked = model.param_tree(), model.stacked()
    for k, v in ref.items():
        assert tree[k][0].dtype == (torch.float32 if v.dtype == jnp.float32
                                    else torch.bfloat16), k
        np.testing.assert_array_equal(stacked[k].float().numpy(), _np(v))
    assert [type(b.mixer).__name__ for b in model.blocks] == \
        ["MLA"] * cfg.n_layers
    assert [type(b.mlp).__name__ for b in model.blocks] == \
        ["MLP"] * len(cfg.prefix) + ["MoE"] * (cfg.n_layers - 1)
    assert ("prefix", "b0", "mixer", "w_uq") in tree
    assert ("periods", "b0", "mlp", "shared", "wg") in tree


def test_from_jax_params_raises_on_leaves_it_cannot_place(pair):
    jcfg, params, cfg, _ = pair("deepseek-v3-671b")
    tree = jax.tree.map(np.asarray, params)
    extra = {**tree, "prefix": {**tree["prefix"],
                                "b1": tree["prefix"]["b0"]}}
    with pytest.raises(ValueError, match="prefix/b1"):
        from_jax_params(extra, cfg, device="cpu")
    no_mtp = {k: v for k, v in tree.items() if k != "mtp"}
    with pytest.raises(ValueError, match="no leaf"):
        from_jax_params(no_mtp, cfg, device="cpu")
    with pytest.raises(ValueError, match="mtp"):
        from_jax_params(tree, dataclasses.replace(cfg, mtp=False),
                        device="cpu")
    bad = {**tree, "prefix": {"b0": {**tree["prefix"]["b0"], "mixer": {
        **tree["prefix"]["b0"]["mixer"],
        "w_kr": tree["prefix"]["b0"]["mixer"]["w_kr"][:, :4]}}}}
    with pytest.raises(ValueError, match="prefix/b0/mixer/w_kr: shape"):
        from_jax_params(bad, cfg, device="cpu")


def test_init_model_deepseek_is_seeded_and_typed():
    cfg = get_smoke_config("deepseek-v3-671b")
    a = init_model(cfg, seed=3, device="cpu")
    b = init_model(cfg, seed=3, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                  b.parameters()))
    c = init_model(cfg, seed=4, device="cpu")
    assert not torch.equal(c.mtp.mixer.wo, a.mtp.mixer.wo)
    c.load_stacked(a.stacked())
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                  c.parameters()))
    assert a.mtp.mixer.w_uq.shape == (48, 4 * 24)
    assert not hasattr(init_model(get_smoke_config("deepseek-v2-236b"),
                                  device="cpu"), "mtp")
    cache = a.init_cache(3, 32)
    assert len(cache) == cfg.n_layers
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache[0].items()} == {
        "ckv": ((3, 32, 32), torch.bfloat16),
        "kr": ((3, 32, 8), torch.bfloat16)}


# ---------------------------------------------------------------------------
# MLA and the shared experts, module by module
# ---------------------------------------------------------------------------
def _mla_cfgs(q_lora):
    jcfg, cfg = j_smoke("deepseek-v3-671b"), get_smoke_config(
        "deepseek-v3-671b")
    if q_lora:
        return jcfg, cfg
    return (dataclasses.replace(jcfg, mla=dataclasses.replace(jcfg.mla,
                                                              q_lora=0)),
            dataclasses.replace(cfg, mla=MLACfg(**{
                **dataclasses.asdict(cfg.mla), "q_lora": 0})))


@torch.no_grad()
@pytest.mark.parametrize("q_lora", [48, 0])
def test_mla_matches_reference(q_lora):
    """``MLA`` against ``mla_attention`` on the reference's bf16 input
    and cache: a 20-token prefill of 2 rows into an empty cache, then 2
    decode steps with the rows at different positions (row 1 three
    behind, overwriting its own cache rows), and the cache-free form;
    outputs and latent cache rows within ULPS ulps."""
    jcfg, cfg = _mla_cfgs(q_lora)
    assert isinstance(jcfg.mla, JMLACfg)
    spec = BlockSpec()
    jp = jattn.mla_params(jcfg, jax.random.key(4))
    m = MLA(cfg, torch.Generator(), CPU)
    _load(m, jp)
    assert hasattr(m, "w_uq" if q_lora else "wq")
    rng = np.random.default_rng(q_lora)
    fn = jax.jit(functools.partial(jattn.mla_attention, jcfg, spec))
    jc = jattn.mla_cache_init(jcfg, 2, 32)
    tc = mla_cache_init(cfg, 2, 32, CPU)
    steps = [np.broadcast_to(np.arange(20)[None], (2, 20)).copy(),
             np.array([[20], [17]]), np.array([[21], [18]])]
    for i, pos in enumerate(steps):
        x = jnp.asarray(rng.standard_normal((2, pos.shape[1], 64)),
                        jnp.bfloat16)
        jy, jc = fn(jp, x, jnp.asarray(pos), jc)
        ty, tc = m(spec, _t(x), torch.as_tensor(pos).long(), tc)
        assert ty.shape == jy.shape and ty.dtype == torch.bfloat16
        _ulps_close(ty.float(), jy, f"mla y, step {i}")
        for k in ("ckv", "kr"):
            assert tc[k].dtype == torch.bfloat16
            _ulps_close(tc[k].float(), jc[k], f"mla cache {k}, step {i}")
    jy, none = fn(jp, x, jnp.asarray(steps[0][:, :1]))
    ty, tnone = m(spec, _t(x), torch.zeros((2, 1), dtype=torch.long))
    assert none is None and tnone is None
    _ulps_close(ty.float(), jy, "mla y without a cache")


@torch.no_grad()
@pytest.mark.parametrize("n_shared", [1, 2])
@pytest.mark.parametrize("impl", ["gather", "capacity", "auto"])
def test_shared_experts_match_reference(impl, n_shared):
    """The MoE with n_shared·d_ff_expert shared experts (the smoke
    configs' 1; v2's published 2) in each form, T = 64 and 384
    (``auto``: gather, then capacity), and the shared MLP alone."""
    jcfg = j_smoke("deepseek-v2-236b")
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, n_shared=n_shared))
    cfg = get_smoke_config("deepseek-v2-236b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_shared=n_shared))
    jp = jmoe.moe_params(jcfg, jax.random.key(5 + n_shared))
    m = tmoe.MoE(cfg, torch.Generator(), CPU)
    _load(m, {k: v for k, v in jp.items() if k != "shared"})
    _load(m.shared, jp["shared"])
    assert m.shared.wi.shape == (64, 32 * n_shared)
    for bs in ((2, 32), (3, 128)):
        x = jnp.asarray(np.random.default_rng(bs[1] + n_shared)
                        .standard_normal(bs + (64,)), jnp.bfloat16)
        jy = jax.jit(functools.partial(jmoe.moe_apply, jcfg, impl=impl))(
            jp, x)
        ty = m(_t(x), impl=impl)
        assert ty.shape == jy.shape and ty.dtype == torch.bfloat16
        _ulps_close(ty.float(), jy, f"moe {impl}, {n_shared} shared, {bs}")
    js = jmoe.mlp_apply(jcfg, jp["shared"], x)
    _ulps_close(m.shared(_t(x)).float(), js, "the shared MLP")


# ---------------------------------------------------------------------------
# the model, teacher-forced with the published top-k
# ---------------------------------------------------------------------------
def _layers(jcfg):
    """(subtree, period or None, spec) of every layer in order: the
    prefix's blocks, then the scanned periods'."""
    return ([(("prefix", f"b{i}"), None, s)
             for i, s in enumerate(jcfg.prefix)]
            + [(("periods", f"b{i}"), p, s) for p in range(jcfg.n_periods)
               for i, s in enumerate(jcfg.pattern)])


def _at(tree, path, p):
    sub = tree[path[0]][path[1]]
    return sub if p is None else jax.tree.map(lambda a: a[p], sub)


@functools.partial(jax.jit, static_argnums=(0, 1))
@functools.partial(_traced, once=True)
def _ref_block(jcfg, spec, p, x, positions, cache):
    """The reference's ``block_apply`` (no post-block norms) with its
    SiLU rounded once, jitted alone, returning the MLP's input too."""
    y, new_cache = jattn.attention(jcfg, spec, p["mixer"],
                                   j_norm(jcfg, p["norm1"], x), positions,
                                   cache)
    x = x + y
    h2 = j_norm(jcfg, p["norm2"], x)
    y = jmoe.moe_apply(jcfg, p["mlp"], h2) if spec.mlp == "moe" else \
        jmoe.mlp_apply(jcfg, p["mlp"], h2)
    return x + y, new_cache, h2


def _ref_blocks(jcfg, params, toks, positions, jcache):
    """The reference's model with its SiLU rounded once, jitted block
    by block: per layer its index, spec, parameters, input, cache,
    output, new cache and MLP input."""
    x = params["embed"][jnp.asarray(toks)]
    pos = jnp.asarray(positions)
    for li, (path, p, spec) in enumerate(_layers(jcfg)):
        lp, jc = _at(params, path, p), _at(jcache, path, p)
        jy, jnc, h2 = _ref_block(jcfg, spec, lp, x, pos, jc)
        yield li, spec, lp, x, jc, jy, jnc, h2
        x = jy


def _stack(jcfg, by_layer):
    """Per-layer reference caches back into ``init_cache``'s tree."""
    tree = {"periods": {}}
    if jcfg.prefix:
        tree["prefix"] = {f"b{i}": by_layer[i]
                          for i in range(len(jcfg.prefix))}
    first = len(jcfg.prefix)
    for i in range(jcfg.period):
        tree["periods"][f"b{i}"] = jax.tree.map(
            lambda *a: jnp.stack(a), *[by_layer[li] for li in range(
                first + i, jcfg.n_layers, jcfg.period)])
    return tree


def test_silu_rounding():
    """The port's bf16 SiLU is :func:`_silu_once` bit for bit; the
    reference's differs from it in over a fifth of the elements (36 %
    here), by at most two bf16 ulps of the larger (two in 17 of 4096)."""
    x = jnp.asarray(np.random.default_rng(0).standard_normal(4096) * 4,
                    jnp.bfloat16)
    got = tmoe.act_fn("silu")(_t(x)).float().numpy()
    np.testing.assert_array_equal(got, _np(jax.jit(_silu_once)(x)))
    want = _np(jax.jit(jax.nn.silu)(x))
    top = np.maximum(np.maximum(np.abs(got), np.abs(want)), 1e-30)
    assert (np.abs(got - want) <= 2 * 2.0 ** (np.floor(np.log2(top)) - 7)
            ).all()
    assert (got != want).mean() > 0.2


@torch.no_grad()
def _teacher_forced(pair, toks, positions, jcache, tcache):
    """Every port block on the reference's input and cache to that
    block: output, latent cache and routing as the module docstring
    says; returns the reference's final hidden and new cache tree."""
    jcfg, params, cfg, model = pair
    seen = {}
    hooks = [blk.mlp.register_forward_pre_hook(
        lambda mod, args: seen.__setitem__("h2", args[0]))
        for blk in model.blocks]
    by_layer = {}
    try:
        tpos = torch.from_numpy(np.array(positions)).long()
        for li, spec, p, x, jc, jy, jnc, h2 in _ref_blocks(
                jcfg, params, toks, positions, jcache):
            blk = model.blocks[li]
            tc = {k: _t(v) for k, v in jc.items()}
            ty, tnc = blk(_t(x), tpos, tc)
            keep = np.ones(jy.shape[:2], bool)
            if spec.mlp == "moe":
                margin, je = _gate_margin(jcfg, p["mlp"], h2)
                th2 = seen["h2"]
                _, te = tmoe._route(blk.mlp.router, th2.reshape(
                    -1, th2.shape[-1]), jcfg.moe.top_k)
                flip = (np.sort(te.numpy(), axis=-1) != je).any(-1)
                assert (margin[flip] < TIE_MARGIN).all(), \
                    (li, margin[flip])
                keep = ~flip.reshape(jy.shape[:2])
            _ulps_close(ty.float().numpy()[keep], _np(jy)[keep],
                        f"block {li} (attn, {spec.mlp})")
            for k in jnc:
                _ulps_close(tnc[k].float(), jnc[k], f"block {li} {k}")
            by_layer[li] = jnc
        hidden = j_norm(jcfg, params["final_norm"], jy)
    finally:
        for h in hooks:
            h.remove()
    np.testing.assert_allclose(model._logits(_t(hidden)).numpy(),
                               _np(_ref_logits(params, hidden)),
                               atol=LOGIT_TOL, rtol=0)
    return hidden, _stack(jcfg, by_layer)


def test_prefill_and_decode_teacher_forced(pair):
    """deepseek-v3's smoke config at its top-2: a prefill of 3 x 96
    (T = 288, the capacity form), then 2 decode steps (T = 3, gather) on
    the reference's caches."""
    pair = pair("deepseek-v3-671b")
    jcfg, params, cfg, model = pair
    b, s = 3, 96
    toks = _tokens(b, s, cfg.vocab, seed=7)
    positions = np.broadcast_to(np.arange(s)[None], (b, s))
    jcache = jm.init_cache(jcfg, b, s + 4)
    tcache = model.init_cache(b, s + 4)
    hidden, jcache = _teacher_forced(pair, toks, positions, jcache, tcache)
    nxt = np.asarray(jnp.argmax(hidden[:, -1:] @ params["unembed"], -1),
                     np.int32)
    for k in range(2):
        pos = np.full((b, 1), s + k, np.int32)
        hidden, jcache = _teacher_forced(pair, nxt, pos, jcache, tcache)
        nxt = np.asarray(jnp.argmax(hidden @ params["unembed"], -1),
                         np.int32)


# ---------------------------------------------------------------------------
# end to end, every expert routed
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bs", [(2, 20), (3, 128)])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_end_to_end(pair, arch, bs):
    """Prefill and 3 decode steps (each fed the reference's greedy token)
    through the port, the jitted reference and the jitted reference
    with its SiLU rounded once, each from its own cache."""
    jcfg, params, _, model = pair(arch, every_expert=True)
    b, s = bs
    toks = {"tokens": jnp.asarray(_tokens(b, s, jcfg.vocab, seed=s))}
    (prefill, decode), (prefill1, decode1) = _jitted(jcfg), _jitted(
        jcfg, once=True)
    jl, jcache, jh = prefill(params, toks, s_max=s + 4, return_hidden=True)
    ol, ocache, oh = prefill1(params, toks, s_max=s + 4, return_hidden=True)
    tl, tcache, th = model.prefill(torch.as_tensor(_np(toks["tokens"])).long(),
                                   s + 4, return_hidden=True)
    assert tl.shape == jl.shape and th.shape == jh.shape
    _within_gap([(th.float(), jh)], [(oh, jh)], HIDDEN_TOL, "prefill hidden")
    port, chain = [(tl, jl)], [(ol, jl)]
    nxt = np.argmax(_np(jl[:, -1]), -1)[:, None].astype(np.int32)
    for k in range(3):
        pos = jnp.asarray(np.full((b, 1), s + k, np.int32))
        jl, jcache = decode(params, jnp.asarray(nxt), pos, jcache)
        ol, ocache = decode1(params, jnp.asarray(nxt), pos, ocache)
        tl, tcache = model.decode_step(torch.as_tensor(nxt).long(),
                                       torch.as_tensor(_np(pos)).long(),
                                       tcache)
        port.append((tl, jl))
        chain.append((ol, jl))
        nxt = np.argmax(_np(jl[:, -1]), -1)[:, None].astype(np.int32)
    _within_gap(port, chain, LOGIT_TOL, "prefill and decode logits")


@torch.no_grad()
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_with_mtp_matches_reference(pair, arch):
    """``lm_loss`` against ``repro.models.model.lm_loss`` at
    ``remat=False`` (2 x 64 tokens, chunk 32, labels with ignored
    positions), within twice the reference's op-by-op vs jitted gap
    and never below 2e-4 relative; with the MTP block (v3) its t+2 term
    alone, the loss less the loss of the same weights without ``mtp``,
    held the same way."""
    jcfg, params, cfg, model = pair(arch, every_expert=True)
    toks = _tokens(2, 64, cfg.vocab, seed=11)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1], labels[0, 5:9] = -1, -1
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.as_tensor(toks).long(),
          "labels": torch.as_tensor(labels).long()}

    def losses(jc, tm, p):
        jit = float(jax.jit(functools.partial(jm.lm_loss, jc, chunk=32,
                                              remat=False))(p, jb))
        eager = float(jm.lm_loss(jc, p, jb, chunk=32, remat=False))
        return float(lm_loss(tm, tb, chunk=32, remat=False)), jit, eager

    got, jit, eager = losses(jcfg, model, params)
    _within_gap([(got, jit)], [(eager, jit)], LOSS_RTOL * abs(jit),
                f"{arch} lm_loss")
    if not cfg.mtp:
        return
    trunk = {k: v for k, v in params.items()
             if k not in ("mtp", "mtp_norm")}
    no_mtp = dataclasses.replace(cfg, mtp=False)
    base = losses(dataclasses.replace(jcfg, mtp=False), from_jax_params(
        jax.tree.map(np.asarray, trunk), no_mtp, device="cpu"), trunk)
    term = [a - b for a, b in zip((got, jit, eager), base)]
    assert term[1] > 0.1, term             # the 0.3-weighted t+2 term
    _within_gap([(term[0], term[1])], [(term[2], term[1])],
                LOSS_RTOL * abs(jit), f"{arch} lm_loss's MTP term")


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------
def _oracle(jcfg, params, req):
    """One request alone through the jitted reference and through it
    with its SiLU rounded once, at the server's padded bucket, each
    decode step fed the server's token: the last position's logits of
    the prefill and of every decode step, from each."""
    L = len(req.prompt)
    bucket = min(max(16, 1 << (L - 1).bit_length()), S_MAX)
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :L] = req.prompt
    out = []
    for prefill, decode in (_jitted(jcfg), _jitted(jcfg, once=True)):
        logits, cache = prefill(params, {"tokens": jnp.asarray(toks)},
                                s_max=S_MAX)
        seen = [logits[0, -1]]
        for k in range(1, MAX_NEW):
            tok = np.array([[req.generated[k - 1]]], np.int32)
            pos = np.array([[L + k - 1]], np.int32)
            logits, cache = decode(params, jnp.asarray(tok),
                                   jnp.asarray(pos), cache)
            seen.append(logits[0, -1])
        out.append(seen)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_server_tokens_match_replay(pair, arch):
    """The server (2 slots, continuous batching, the whitening cache on):
    each request's logits, from its admit and from every decode step the
    batch ran with it in a slot, against the request replayed alone
    through the reference, each step fed the server's token: within
    ``_within_gap``'s bound; the server's token the reference's wherever
    the reference's top-2 margin exceeds twice that bound.  The MTP
    block never runs in a serve."""
    jcfg, params, cfg, model = pair(arch, every_expert=True)
    reqs = tserve.synthetic_requests(N_REQ, cfg.vocab, seed=0, lo=4, hi=40)
    srv = tserve.Server(cfg, model, slots=SLOTS, s_max=S_MAX,
                        max_new=MAX_NEW, eos_id=-1, whiten="cache",
                        gram_cache=ServingGramCache(refresh_stride=1,
                                                    synchronous=True),
                        device="cpu")
    ran = []
    if cfg.mtp:
        hook = model.mtp.register_forward_pre_hook(
            lambda *a: ran.append(1))
    try:
        srv.warm_up()
        got = _recorded(srv, reqs)
        steps = tserve.run(srv, reqs, max_steps=N_REQ * MAX_NEW)
    finally:
        if cfg.mtp:
            hook.remove()
    assert not ran and len({srv._bucket(len(r.prompt)) for r in reqs}) >= 2
    assert srv.forwards == len(srv.bucket_ladder()) + 1 + len(reqs) + steps
    port, chain, gated = [], [], []
    for r in reqs:
        assert r.done_t is not None and len(r.generated) == MAX_NEW
        assert np.isfinite(r.embedding).all()
        want, ref_chain = _oracle(jcfg, params, r)
        assert len(got[r.rid]) == MAX_NEW
        port += list(zip(got[r.rid], want))
        chain += list(zip(ref_chain, want))
        gated += [(r.rid, k, tt, _np(w)) for k, (tt, w)
                  in enumerate(zip(r.generated, want))]
    tol = _within_gap(port, chain, LOGIT_TOL, f"{arch} server logits")
    compared = 0
    for rid, k, tt, w in gated:
        if _margin(w) > 2 * tol:
            assert tt == int(np.argmax(w)), (rid, k)
            compared += 1
    assert compared >= N_REQ


def test_admit_copies_the_latent_cache_prefix_first(pair):
    """The slot's ``ckv`` / ``kr`` rows of every layer, the prefix
    block's first, are the padded prefill's bit for bit, the other slot
    untouched."""
    _, _, cfg, model = pair("deepseek-v2-236b")
    srv = tserve.Server(cfg, model, slots=2, s_max=32, max_new=3,
                        device="cpu")
    before = [{k: v.clone() for k, v in layer.items()}
              for layer in srv.cache]
    req = tserve.synthetic_requests(1, cfg.vocab, seed=3, lo=5, hi=9)[0]
    srv.admit(req, 1)
    toks = np.zeros((1, 16), np.int64)
    toks[0, :len(req.prompt)] = req.prompt
    _, fresh = model.prefill(torch.as_tensor(toks), 32)
    assert len(srv.cache) == cfg.n_layers
    for layer, old, new in zip(srv.cache, before, fresh):
        assert set(layer) == {"ckv", "kr"}
        for k in layer:
            assert torch.equal(layer[k][0], old[k][0])
            assert torch.equal(layer[k][1], new[k][0])
    assert model.blocks[0].spec.mlp == "dense"
    assert srv.cache[0]["ckv"][1, len(req.prompt) - 1].abs().sum() > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_cpu_serve_launches_no_kernel(arch):
    """The smoke serve through the CLI's entry point, and through
    ``serve(cfg=)`` cut to the prefix and one MoE layer: on the CPU
    nothing is launched."""
    args = tserve.build_argparser().parse_args(
        ["--arch", arch, "--device", "cpu", "--requests", "3",
         "--max-new", "3", "--whiten", "cache", "--s-max", "64"])
    counts.reset_launch_counts()
    out = tserve.serve(args)
    cfg = get_smoke_config(arch)
    assert out["completed"] == 3 and out["layers"] == cfg.n_layers
    assert out["embeddings_finite"]
    out = tserve.serve(args, cfg=dataclasses.replace(
        cfg, n_layers=len(cfg.prefix) + 1))
    assert out["completed"] == 3 and out["layers"] == len(cfg.prefix) + 1
    assert set(counts.launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,layers", [(a, 0) for a in ARCHS]
                         + [("deepseek-v3-671b", 1)])
def test_mesh_refuses_a_head_split_before_drawing_weights(arch, layers,
                                                          monkeypatch):
    """deepseek trains on a mesh whose model axis divides its heads
    (tests/test_torch_deepseek_mesh.py); a model axis of 8 would cut the
    smoke configs' 4 heads: ``train --devices 8 --max-model 8`` raises
    ``ValueError`` naming an MLA leaf that carries heads before any
    weight is drawn or any rank starts, and so do ``shard_`` and
    ``check_head_split``.  v3's ``--layers 1`` cut has no periods: the
    leaf named is its prefix block's or its MTP block's."""
    from repro_torch.distributed.mesh import planning_mesh
    from repro_torch.launch import train as ttrain
    from repro_torch.models.model import HEADS, Model, check_head_split
    from repro_torch.models.sharding import param_specs

    def no_init(*a, **kw):
        raise AssertionError("weights drawn before the refusal")
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "1",
            "--devices", "8", "--max-model", "8"]
    if layers:
        argv += ["--layers", str(layers)]
    args = ttrain.build_argparser().parse_args(argv)
    cfg = ttrain.build_config(args)
    assert cfg.n_heads == 4 and (cfg.n_periods == 0) == bool(layers)
    with monkeypatch.context() as m:
        m.setattr(ttrain, "init_model", no_init)
        m.setattr(ttrain, "run_ranks", no_init)
        with pytest.raises(ValueError, match="n_heads=4") as e:
            ttrain.train(args)
    leaf = str(e.value).split(":")[0].split("/")
    assert leaf[-2] == "mixer" and leaf[-1] in HEADS["mla"], leaf
    assert leaf[0] in (("prefix", "mtp") if layers
                       else ("prefix", "periods", "mtp")), leaf
    mesh = planning_mesh({"data": 1, "model": 8})
    model = Model(cfg, torch.Generator(), torch.device("meta"))
    with pytest.raises(ValueError, match="n_heads=4"):
        check_head_split(cfg, param_specs(cfg, model.stacked_shapes(),
                                          mesh), 8)
    with pytest.raises(ValueError, match="n_heads=4"):
        init_model(cfg, device="cpu").shard_(mesh)
