"""The jamba slice on the CPU: repro_torch's Mamba mixer, routed MoE MLP
and jamba-v0.1-52b smoke model (8 layers: 7 Mamba, 1 attention; 4 dense
MLPs, 4 MoE MLPs of 4 experts, top-2; d_model 64), loaded with the
reference's weights through ``from_jax_params``, against repro.

Bounds.
- The selective scans, f32 in and out: the reference's own chunked-vs-
  sequential bounds (tests/test_ssm_chunkwise.py): 2e-4 on y, 2e-3 on h.
- A bf16 block (the Mamba mixer, the MoE, a whole block) on the same
  input as the reference's: ``ULPS`` bf16 ulps at the output's scale,
  ``ULPS · 2^-8 · max|ref|`` (measured: 1-3 ulps).  The f32 Mamba state
  that such a block leaves derives from bf16 projections, so it is held
  to the same bound.
- Routing is discontinuous.  A one-ulp difference in the router's input
  (the two frameworks round bf16 products in different orders) flips
  the k-th expert wherever the reference's k-th and (k+1)-th gates tie
  within ~1e-3, and the token's MoE output then moves by O(an expert's
  output).  So the published top-2 config is held teacher-forced: each
  port block runs on the reference's input to that block and the
  reference's cache (the reference's block jitted alone, returning the
  MoE input it routed on), its output and new cache within ``ULPS``
  ulps, a routing difference allowed only at a reference near-tie (gate
  margin < ``TIE_MARGIN``; those tokens are left out of that block's
  comparison), the logits from the reference's final hidden within
  LOGIT_TOL.
- End to end, the smoke config with every expert routed (top_k =
  n_experts: no discontinuity; the same gather / capacity code paths).
  jamba's init draws the experts with fan-in E (the reference's
  ``dense_init`` on (E, d, f)), so the residual stream grows far past the
  final norm's output and its rounding reaches the hidden and logits.
  The reference compiled block by block (``_ref_chain``: the same
  function, rounded where XLA's fusions of the whole forward do not)
  differs from the jitted reference on these inputs by 0.070 / 0.125 in
  the prefill hidden at (2, 20) / (3, 128), and by 0.054-0.100 in the
  logits: beyond test_torch_model.py's HIDDEN_TOL and LOGIT_TOL.  So the
  port is held to the jitted reference within ``GAP_FACTOR`` times that
  gap, measured in each test on its own inputs (``_within_gap``, which
  prints each reading), never below HIDDEN_TOL / LOGIT_TOL (port
  1.30-1.47 times the gap in the hidden, 0.88-1.46 in the logits).
- ``lax.top_k`` breaks ties toward the lower index and ``torch.topk``
  promises no order: the gates here come from continuous random inputs
  and have no exact ties.

Server oracle (as tests/test_torch_xlstm.py): the reference server's
slot copy indexes the stacked period axis (ROADMAP queue C), so each
request is replayed alone through the jitted reference at its padded
bucket (the pads enter the Mamba state, as in the reference), each
decode step fed the server's token: the server's logits at every step
(prefill through the slot copy, decode in the continuous batch) within
``_within_gap``'s bound, its token the reference's wherever the
reference's top-2 margin exceeds twice that bound.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro.configs import get_config as j_full
from repro.configs import get_smoke_config as j_smoke
from repro.models import model as jm
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models.attention import attention
from repro.models.common import MoECfg as JMoECfg
from repro.models.common import apply_norm as j_norm
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import counts
from repro_torch.launch import serve as tserve
from repro_torch.launch.serving_cache import ServingGramCache
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models.common import MoECfg
from repro_torch.models.model import from_jax_params, init_model
from test_torch_hygiene import limit_torch_threads  # noqa: F401

ARCH = "jamba-v0.1-52b"
ULPS = 4
LOGIT_TOL = 4e-2      # tests/test_torch_model.py
HIDDEN_TOL = 6.25e-2  # tests/test_torch_model.py
GAP_FACTOR = 2        # end to end: the reference's own gap, twice over
TIE_MARGIN = 1e-2     # a routing difference only below this gate margin
SLOTS, S_MAX, MAX_NEW, N_REQ = 2, 64, 5, 4
CPU = torch.device("cpu")


def _np(a):
    return np.array(a, np.float32)          # a writable copy


def _t(a):
    """A reference bf16 array as a torch bf16 tensor, bit for bit."""
    return torch.from_numpy(_np(a)).to(torch.bfloat16)


def _ulps_close(got, want, what, ulps=ULPS):
    got, want = _np(got), _np(want)
    tol = ulps * 2.0 ** -8 * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max_abs_err {err:.4g} > {tol:.4g}"


def _load(module, tree):
    for k, v in tree.items():
        p = getattr(module, k)
        p.data.copy_(torch.from_numpy(np.array(v, np.float32)).to(p.dtype))


def _all_experts(cfg, moe_cls):
    return dataclasses.replace(cfg, moe=moe_cls(
        cfg.moe.n_experts, cfg.moe.n_experts, cfg.moe.n_shared,
        cfg.moe.d_ff_expert))


@pytest.fixture(scope="module")
def pair():
    jcfg = j_smoke(ARCH)
    params = jm.init_params(jcfg, jax.random.key(0))
    cfg = get_smoke_config(ARCH)
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    return jcfg, params, cfg, model


@pytest.fixture(scope="module")
def dense_pair():
    """The smoke config with every expert routed (no discontinuity)."""
    jcfg = _all_experts(j_smoke(ARCH), JMoECfg)
    params = jm.init_params(jcfg, jax.random.key(0))
    cfg = _all_experts(get_smoke_config(ARCH), MoECfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    return jcfg, params, cfg, model


@functools.lru_cache(maxsize=None)
def _jitted(jcfg):
    """The reference's prefill and decode step, jitted whole."""
    return (jax.jit(functools.partial(jm.prefill, jcfg),
                    static_argnames=("s_max", "return_hidden")),
            jax.jit(functools.partial(jm.decode_step, jcfg)))


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(1, vocab, (b, s)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# config and parameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["smoke", "full"])
def test_config_matches_reference(which):
    get_t, get_j = (get_smoke_config, j_smoke) if which == "smoke" else \
        (get_config, j_full)
    cfg, jcfg = get_t(ARCH), get_j(ARCH)
    for f in ("name", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "head_dim", "d_ff", "vocab", "norm", "act", "remat_policy",
              "fsdp_params", "mamba_d_state",
              "mamba_d_conv", "mamba_expand"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert dataclasses.asdict(cfg.moe) == dataclasses.asdict(jcfg.moe)
    assert [(b.mixer, b.mlp) for b in cfg.pattern] == \
        [(b.mixer, b.mlp) for b in jcfg.pattern]
    if which == "full":
        assert (cfg.d_model, cfg.moe.n_experts, cfg.moe.top_k,
                cfg.vocab) == (4096, 16, 2, 65536)


def test_parameters_follow_the_reference_tree(pair):
    """Every leaf in the reference's order and shape (the (n_periods, E,
    d, f) expert stacks included), the f32 leaves f32."""
    _, params, _, model = pair
    ref = {tuple(getattr(k, "key", k) for k in path): leaf for path, leaf
           in jax.tree_util.tree_flatten_with_path(params)[0]}
    shapes = model.stacked_shapes()
    assert list(shapes) == list(ref)
    assert shapes == {k: tuple(v.shape) for k, v in ref.items()}
    tree = model.param_tree()
    for k, v in ref.items():
        assert tree[k][0].dtype == (torch.float32 if v.dtype == jnp.float32
                                    else torch.bfloat16), k
    assert tree[("periods", "b1", "mlp", "router")][0].dtype == \
        torch.float32
    assert tree[("periods", "b0", "mixer", "a_log")][0].dtype == \
        torch.float32
    kinds = [(type(b.mixer).__name__, type(b.mlp).__name__)
             for b in model.blocks]
    assert kinds == [("Mamba", "MLP"), ("Mamba", "MoE"), ("Mamba", "MLP"),
                     ("GQA", "MoE")] + [("Mamba", "MLP"), ("Mamba", "MoE")] * 2
    for k, v in ref.items():
        got = model.stacked()[k]
        np.testing.assert_array_equal(got.float().numpy(), _np(v))


def test_from_jax_params_raises_on_leaves_it_cannot_place(pair):
    jcfg, params, cfg, _ = pair
    tree = jax.tree.map(np.asarray, params)
    shared = jmoe.mlp_params(jcfg, jax.random.key(3), d_ff=128)
    bad = {**tree, "periods": {**tree["periods"], "b1": {
        **tree["periods"]["b1"], "mlp": {
            **tree["periods"]["b1"]["mlp"],
            "shared": jax.tree.map(lambda a: np.asarray(a)[None], shared)}}}}
    with pytest.raises(ValueError, match="periods/b1/mlp/shared"):
        from_jax_params(bad, cfg, device="cpu")
    missing = {**tree, "periods": {**tree["periods"], "b3": {
        k: v for k, v in tree["periods"]["b3"].items() if k != "mlp"}}}
    with pytest.raises(ValueError, match="no leaf"):
        from_jax_params(missing, cfg, device="cpu")


def test_init_model_jamba_is_seeded_and_typed():
    cfg = get_smoke_config(ARCH)
    a = init_model(cfg, seed=3, device="cpu")
    b = init_model(cfg, seed=3, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                  b.parameters()))
    assert a.blocks[1].mlp.wi.shape == (4, 64, 128)
    assert a.blocks[1].mlp.wi.dtype == torch.bfloat16
    assert a.blocks[1].mlp.router.dtype == torch.float32
    cache = a.init_cache(3, 32)
    assert cache[0]["conv"].shape == (3, 3, 128)
    assert cache[0]["conv"].dtype == torch.bfloat16
    assert cache[0]["ssm"].shape == (3, 128, 16)
    assert cache[3]["k"].shape == (3, 32, 2, 16)


# ---------------------------------------------------------------------------
# the selective scans and the Mamba mixer
# ---------------------------------------------------------------------------
def _scan_inputs(b, s, di=24, ds=8, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, s, di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, di)))).astype(
        np.float32)
    A = -np.exp(np.log(np.broadcast_to(np.arange(1, ds + 1, dtype=np.float32),
                                       (di, ds))))
    B = rng.standard_normal((b, s, ds)).astype(np.float32)
    C = rng.standard_normal((b, s, ds)).astype(np.float32)
    D = rng.standard_normal(di).astype(np.float32)
    h0 = rng.standard_normal((b, di, ds)).astype(np.float32)
    return u, dt, A, B, C, D, h0


@pytest.mark.parametrize("s", [16, 64, 128, 256])
def test_selective_scans_match_reference(s):
    """s = 16, 64: the sequential scan on both sides (s ≤ 64); 128, 256:
    the chunked one (2 and 4 chunks of 64), also against the port's
    sequential scan."""
    args = _scan_inputs(2, s, seed=s)
    jy, jh = jssm._selective_scan(*map(jnp.asarray, args))
    ty, th = tssm._selective_scan(*map(torch.from_numpy, args))
    np.testing.assert_allclose(ty.numpy(), _np(jy), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(th.numpy(), _np(jh), rtol=2e-3, atol=2e-3)
    sy, sh = tssm._selective_scan_seq(*map(torch.from_numpy, args))
    np.testing.assert_allclose(ty.numpy(), sy.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(th.numpy(), sh.numpy(), rtol=2e-3, atol=2e-3)
    jsy, jsh = jssm._selective_scan_seq(*map(jnp.asarray, args))
    np.testing.assert_allclose(sy.numpy(), _np(jsy), rtol=2e-4, atol=2e-4)


def test_associative_scan_is_the_reference_order():
    """The port's parallel prefix against ``lax.associative_scan`` on a
    non-commutative, non-associative-in-rounding combine, every length
    1 to 17, even and odd: equal to the f32 bit."""
    for n in (1, 2, 5, 8, 17):
        rng = np.random.default_rng(n)
        a = rng.uniform(0.5, 1.5, (n, 3)).astype(np.float32)
        b = rng.standard_normal((n, 3)).astype(np.float32)
        ja, jb = jax.lax.associative_scan(
            lambda x, y: (x[0] * y[0], x[1] * y[0] + y[1]),
            (jnp.asarray(a), jnp.asarray(b)), axis=0)
        ta, tb = tssm._associative_scan(
            tssm._linear_combine, [torch.from_numpy(a), torch.from_numpy(b)])
        np.testing.assert_allclose(ta.numpy(), _np(ja), rtol=1e-6, atol=0)
        np.testing.assert_allclose(tb.numpy(), _np(jb), rtol=1e-6,
                                   atol=1e-6)


@pytest.fixture(scope="module")
def mamba_pair():
    jcfg, cfg = j_smoke(ARCH), get_smoke_config(ARCH)
    jp = jssm.mamba_params(jcfg, jax.random.key(1))
    m = tssm.Mamba(cfg, torch.Generator(), CPU)
    _load(m, jp)
    return jcfg, cfg, jp, m


@torch.no_grad()
@pytest.mark.parametrize("s", [16, 64, 128])
def test_mamba_mixer_prefill_and_decode(mamba_pair, s):
    """A prefill of s tokens (sequential at 16 and 64, chunked at 128)
    from the zero state, then 3 decode steps, each on the reference's
    input and state: outputs and both states within ULPS ulps."""
    jcfg, cfg, jp, m = mamba_pair
    rng = np.random.default_rng(s)
    x = jnp.asarray(rng.standard_normal((2, s, 64)), jnp.bfloat16)
    jst = jssm.mamba_state_init(jcfg, 2)
    mixer = jax.jit(functools.partial(jssm.mamba_mixer, jcfg))
    for step in range(4):
        tst = {k: torch.from_numpy(_np(v)).to(
            torch.bfloat16 if k == "conv" else torch.float32)
            for k, v in jst.items()}
        jy, jst = mixer(jp, x, jst)
        ty, tst = tssm.mamba_mixer(cfg, m, _t(x), tst)
        assert ty.shape == jy.shape and ty.dtype == torch.bfloat16
        _ulps_close(ty.float(), jy, f"mamba y, step {step}")
        _ulps_close(tst["ssm"], jst["ssm"], f"mamba ssm, step {step}")
        assert tst["conv"].dtype == torch.bfloat16
        np.testing.assert_array_equal(tst["conv"].float().numpy(),
                                      _np(jst["conv"]))
        x = jnp.asarray(rng.standard_normal((2, 1, 64)), jnp.bfloat16)
    # no state: the reference returns None, the zero state's output
    jy0, none = mixer(jp, x)
    ty0, tnone = tssm.mamba_mixer(cfg, m, _t(x))
    assert none is None and tnone is None
    _ulps_close(ty0.float(), jy0, "mamba y without a state")


# ---------------------------------------------------------------------------
# the routed experts
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def moe_pair():
    jcfg, cfg = j_smoke(ARCH), get_smoke_config(ARCH)
    jp = jmoe.moe_params(jcfg, jax.random.key(2))
    m = tmoe.MoE(cfg, torch.Generator(), CPU)
    _load(m, jp)
    return jcfg, cfg, jp, m


@torch.no_grad()
@pytest.mark.parametrize("impl", ["gather", "ragged", "capacity", "auto"])
@pytest.mark.parametrize("bs", [(2, 32), (3, 128)])
def test_moe_apply_matches_reference(moe_pair, impl, bs):
    """Each ``impl=`` form on the reference's bf16 input; T = 64 and
    384 (``auto``: gather, then capacity)."""
    jcfg, cfg, jp, m = moe_pair
    x = jnp.asarray(np.random.default_rng(bs[1]).standard_normal(
        bs + (64,)), jnp.bfloat16)
    jy = jax.jit(functools.partial(jmoe.moe_apply, jcfg, impl=impl))(jp, x)
    ty = m(_t(x), impl=impl)
    assert ty.shape == jy.shape and ty.dtype == torch.bfloat16
    _ulps_close(ty.float(), jy, f"moe {impl} {bs}")
    t = bs[0] * bs[1]
    want = "gather" if t <= tmoe.GATHER_MAX_TOKENS else "capacity"
    if impl == "auto":
        assert torch.equal(ty, m(_t(x), impl=want))


@torch.no_grad()
def test_route_matches_reference(moe_pair):
    jcfg, _, jp, m = moe_pair
    x = np.random.default_rng(5).standard_normal((200, 64)).astype(
        np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    jg, je = jmoe._route(jp, xb, 2)
    tg, te = tmoe._route(m.router, _t(xb), 2)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tg.numpy(), _np(jg), rtol=1e-6, atol=1e-7)


@torch.no_grad()
def test_capacity_drops_the_reference_pairs(moe_pair, monkeypatch):
    """A router skewed toward expert 0 (every token's top-1): its group
    of 64 overflows the capacity of 56 (T·k = 128, factor 1.5, E = 4),
    and the capacity form keeps exactly the (token, slot) pairs the
    reference's window index keeps, the overflow of every group dropped
    (read from the window index the port's forward gathers by); the
    outputs agree."""
    jcfg, cfg, jp, m = moe_pair
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal((1, 64, 64)) + 3.0, jnp.bfloat16)
    jp = {**jp, "router": jp["router"].at[:, 0].add(0.2)}
    router = m.router.detach().clone()
    _load(m, {"router": jp["router"]})
    try:
        t, k, e = 64, 2, 4
        cap = jmoe._capacity(t * k, e)
        assert cap == tmoe._capacity(t * k, e) == 56
        xf = x.reshape(t, 64)
        _, je = jmoe._route(jp, xf, k)
        _, te = tmoe._route(m.router, _t(xf), k)
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        flat = je.reshape(-1)
        order = jnp.argsort(flat)
        sizes = jnp.bincount(flat, length=e)
        offsets = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                                   jnp.cumsum(sizes)[:-1].astype(jnp.int32)])
        idx = jmoe._window_index(offsets, t * k, e, cap)
        want = np.asarray(idx[jnp.argsort(order)] < e * cap).reshape(t, k)
        seen = []
        gather = tmoe._capacity_gather

        def spy(ys_flat, idx, inv):
            seen.append((ys_flat.shape[0], idx, inv))
            return gather(ys_flat, idx, inv)
        monkeypatch.setattr(tmoe, "_capacity_gather", spy)
        ty = m(_t(x), impl="capacity")
        monkeypatch.undo()
        (rows, tidx, tinv), = seen
        assert rows == e * cap + 1           # the windows and a zero row
        got = (tidx < e * cap)[tinv].reshape(t, k).numpy()
        np.testing.assert_array_equal(got, want)
        over = sum(max(0, int(n) - cap) for n in np.asarray(sizes))
        assert int((~got).sum()) == over and int(sizes[0]) == t > cap
        jy = jmoe.moe_apply(jcfg, jp, x, impl="capacity")
        _ulps_close(ty.float(), jy, "moe capacity with overflow")
        dropless = m(_t(x), impl="gather")
        assert not torch.equal(ty, dropless)
    finally:
        m.router.data.copy_(router)


def test_moe_aux_loss_matches_reference(moe_pair):
    jcfg, cfg, jp, m = moe_pair
    x = jnp.asarray(np.random.default_rng(9).standard_normal((2, 48, 64)),
                    jnp.bfloat16)
    want = float(jmoe.moe_aux_loss(jcfg, jp, x))
    with torch.no_grad():
        got = float(tmoe.moe_aux_loss(cfg, m, _t(x)))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


class _Largest(TorchDispatchMode):
    """The largest tensor any op returns."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest, t.numel())
        return out


@torch.no_grad()
def test_gather_form_never_materialises_token_expert_weights(moe_pair):
    """The reference's gather form builds (T, k, d, f) weight slices;
    the port's dropless forms never make a tensor larger than one
    expert's weight (d·f) or the (T·k, f) hidden."""
    _, cfg, _, m = moe_pair
    t, k, d, f = 64, 2, 64, 128
    x = torch.randn(1, t, d, generator=torch.Generator().manual_seed(0)) \
        .to(torch.bfloat16)
    with _Largest() as mode:
        m(x, impl="gather")
    assert mode.largest <= max(d * f, t * k * f) < t * k * d * f


# ---------------------------------------------------------------------------
# the model, teacher-forced on the smoke config
# ---------------------------------------------------------------------------
def _layer(tree, li, period):
    p, i = divmod(li, period)
    return jax.tree.map(lambda a: a[p], tree["periods"][f"b{i}"])


@functools.partial(jax.jit, static_argnums=(0, 1))
def _ref_block(jcfg, spec, p, x, positions, cache):
    """The reference's ``block_apply`` line for line (jamba has no
    post-block norms), jitted, returning the MoE / MLP input it
    computed too (so that a routing is read where it was made)."""
    h = j_norm(jcfg, p["norm1"], x)
    if spec.mixer == "mamba":
        y, new_cache = jssm.mamba_mixer(jcfg, p["mixer"], h, cache)
    else:
        y, new_cache = attention(jcfg, spec, p["mixer"], h, positions, cache)
    x = x + y
    h2 = j_norm(jcfg, p["norm2"], x)
    y = jmoe.moe_apply(jcfg, p["mlp"], h2) if spec.mlp == "moe" else \
        jmoe.mlp_apply(jcfg, p["mlp"], h2)
    return x + y, new_cache, h2


def _gate_margin(jcfg, p, h2):
    """The reference's k-th minus (k+1)-th gate per token, and its
    experts (sorted), of MoE input h2 (B, S, d)."""
    xf = h2.reshape(-1, h2.shape[-1])
    gates = np.asarray(jax.nn.softmax(xf.astype(jnp.float32) @ p["router"],
                                      axis=-1))
    srt = np.sort(gates, axis=-1)
    k = jcfg.moe.top_k
    _, je = jmoe._route(p, xf, k)
    return srt[:, -k] - srt[:, -k - 1], np.sort(np.asarray(je), axis=-1)


def _ref_blocks(jcfg, params, toks, positions, jcache):
    """The reference's model jitted block by block (``_ref_block``): per
    layer its index, spec, parameters, input, cache, output, new cache
    and MoE / MLP input."""
    x = params["embed"][jnp.asarray(toks)]
    pos = jnp.asarray(positions)
    for li in range(jcfg.n_layers):
        spec = jcfg.pattern[li % jcfg.period]
        p = _layer(params, li, jcfg.period)
        jc = _layer(jcache, li, jcfg.period)
        jy, jnc, h2 = _ref_block(jcfg, spec, p, x, pos, jc)
        yield li, spec, p, x, jc, jy, jnc, h2
        x = jy


def _ref_logits(params, hidden):
    return hidden.astype(jnp.float32) @ params["unembed"].astype(jnp.float32)


def _ref_chain(jcfg, params, toks, positions, jcache):
    """The reference's prefill / decode step compiled block by block: the
    same function as ``jm.prefill`` / ``jm.decode_step``, rounded where
    XLA's fusions of the whole forward do not round.  Returns the final
    hidden and the new stacked cache."""
    by_layer = {}
    for li, _, _, _, _, x, jnc, _ in _ref_blocks(jcfg, params, toks,
                                                 positions, jcache):
        by_layer[li] = jnc
    return (j_norm(jcfg, params["final_norm"], x),
            _stack(by_layer, jcfg.period))


@torch.no_grad()
def _teacher_forced(pair, toks, positions, jcache, tcache):
    """Run every port block on the reference's input (and cache) to that
    block; returns the reference's final hidden and its new per-layer
    caches."""
    jcfg, params, cfg, model = pair
    seen = {}
    hooks = [blk.mlp.register_forward_pre_hook(
        lambda mod, args: seen.__setitem__("h2", args[0]))
        for blk in model.blocks]
    try:
        tpos = torch.from_numpy(np.array(positions)).long()
        new_cache = {}
        for li, spec, p, x, jc, jy, jnc, h2 in _ref_blocks(
                jcfg, params, toks, positions, jcache):
            blk = model.blocks[li]
            tc = {k: torch.from_numpy(_np(v)).to(tcache[li][k].dtype)
                  for k, v in jc.items()}
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
                        f"block {li} ({spec.mixer}, {spec.mlp})")
            for k in jnc:
                _ulps_close(tnc[k].float(), jnc[k], f"block {li} {k}")
            new_cache[li] = jnc
        hidden = j_norm(jcfg, params["final_norm"], jy)
    finally:
        for h in hooks:
            h.remove()
    np.testing.assert_allclose(model._logits(_t(hidden)).numpy(),
                               _np(_ref_logits(params, hidden)),
                               atol=LOGIT_TOL, rtol=0)
    return hidden, new_cache


def _stack(cache_by_layer, period):
    """Per-layer reference caches back into the stacked layout."""
    n = len(cache_by_layer)
    return {"periods": {f"b{i}": jax.tree.map(
        lambda *a: jnp.stack(a), *[cache_by_layer[li]
                                   for li in range(i, n, period)])
        for i in range(period)}}


@pytest.mark.parametrize("bs", [(2, 20), (3, 128)])
def test_prefill_and_decode_teacher_forced(pair, bs):
    """Prefill: s = 20 (sequential scans; T = 40, the gather form) and
    s = 128 at B = 3 (chunked scans; T = 384, the capacity form); then
    2 decode steps (T = B, gather) on the reference's caches."""
    jcfg, params, cfg, model = pair
    b, s = bs
    s_max = s + 4
    toks = _tokens(b, s, cfg.vocab, seed=s + b)
    positions = np.broadcast_to(np.arange(s)[None], (b, s))
    jcache = jm.init_cache(jcfg, b, s_max)
    tcache = model.init_cache(b, s_max)
    hidden, by_layer = _teacher_forced(pair, toks, positions, jcache, tcache)
    jcache = _stack(by_layer, jcfg.period)
    nxt = np.asarray(jnp.argmax(hidden[:, -1:] @ params["unembed"], -1),
                     np.int32)
    for k in range(2):
        pos = np.full((b, 1), s + k, np.int32)
        hidden, by_layer = _teacher_forced(pair, nxt, pos, jcache, tcache)
        jcache = _stack(by_layer, jcfg.period)
        nxt = np.asarray(jnp.argmax(hidden @ params["unembed"], -1),
                         np.int32)


# ---------------------------------------------------------------------------
# the model end to end, every expert routed
# ---------------------------------------------------------------------------
def _margin(logits):
    top2 = np.sort(_np(logits), axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def _max_err(pairs):
    return max(float(np.abs(_np(a) - _np(b)).max()) for a, b in pairs)


def _within_gap(port, chain, floor, what):
    """``port`` and ``chain`` are (got, reference) pairs of the port and of
    the reference compiled block by block against the jitted reference
    on the same inputs: the port within ``GAP_FACTOR`` times the
    reference's own gap, and never held looser than ``floor``.  Prints
    the reading (``pytest -s``)."""
    gap = _max_err(chain)
    err, tol = _max_err(port), max(floor, GAP_FACTOR * gap)
    reading = f"{what}: port {err:.4g}, the reference against itself " \
        f"{gap:.4g}, bound {tol:.4g}"
    print(reading)
    assert err <= tol, reading
    return tol


@pytest.mark.parametrize("bs", [(2, 20), (3, 128)])
def test_prefill_and_decode_end_to_end(dense_pair, bs):
    """Prefill and 3 decode steps (each fed the reference's greedy token)
    through the port, the jitted reference and the reference compiled
    block by block, each from its own cache."""
    jcfg, params, _, model = dense_pair
    b, s = bs
    toks = _tokens(b, s, jcfg.vocab, seed=s)
    prefill, decode = _jitted(jcfg)
    jl, jcache, jh = prefill(params, {"tokens": jnp.asarray(toks)},
                             s_max=s + 4, return_hidden=True)
    ch, ccache = _ref_chain(jcfg, params, toks,
                            np.broadcast_to(np.arange(s)[None], (b, s)),
                            jm.init_cache(jcfg, b, s + 4))
    tl, tcache, th = model.prefill(torch.as_tensor(toks).long(), s + 4,
                                   return_hidden=True)
    assert tl.shape == jl.shape and th.shape == jh.shape
    _within_gap([(th.float(), jh)], [(ch, jh)], HIDDEN_TOL, "prefill hidden")
    port, chain = [(tl, jl)], [(_ref_logits(params, ch[:, -1:]), jl)]
    nxt = np.argmax(_np(jl[:, -1]), -1)[:, None].astype(np.int32)
    for k in range(3):
        pos = np.full((b, 1), s + k, np.int32)
        jl, jcache = decode(params, jnp.asarray(nxt), jnp.asarray(pos),
                            jcache)
        ch, ccache = _ref_chain(jcfg, params, nxt, pos, ccache)
        tl, tcache = model.decode_step(torch.as_tensor(nxt).long(),
                                       torch.as_tensor(pos).long(), tcache)
        port.append((tl, jl))
        chain.append((_ref_logits(params, ch), jl))
        nxt = np.argmax(_np(jl[:, -1]), -1)[:, None].astype(np.int32)
    _within_gap(port, chain, LOGIT_TOL, "prefill and decode logits")


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------
def _oracle(jcfg, params, req):
    """One request through the jitted reference alone and through the
    reference compiled block by block, at the server's padded bucket,
    each decode step fed the server's token: the last position's logits
    of the prefill and of every decode step, from each."""
    L = len(req.prompt)
    bucket = min(max(16, 1 << (L - 1).bit_length()), S_MAX)
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :L] = req.prompt
    prefill, decode = _jitted(jcfg)
    logits, cache = prefill(params, {"tokens": jnp.asarray(toks)},
                            s_max=S_MAX)
    ch, ccache = _ref_chain(jcfg, params, toks, np.arange(bucket)[None],
                            jm.init_cache(jcfg, 1, S_MAX))
    want, chain = [logits[0, -1]], [_ref_logits(params, ch[0, -1])]
    for k in range(1, MAX_NEW):
        tok = np.array([[req.generated[k - 1]]], np.int32)
        pos = np.array([[L + k - 1]], np.int32)
        logits, cache = decode(params, jnp.asarray(tok), jnp.asarray(pos),
                               cache)
        ch, ccache = _ref_chain(jcfg, params, tok, pos, ccache)
        want.append(logits[0, -1])
        chain.append(_ref_logits(params, ch[0, -1]))
    return want, chain


def _recorded(srv, reqs):
    """Keep each request's last-position logits, slot by slot, from its
    admit's prefill and from every decode step the server runs."""
    got = {r.rid: [] for r in reqs}
    admit, prefill, decode = srv.admit, srv.prefill, srv.decode

    def rec_admit(req, slot):
        def rec_prefill(toks):
            out = prefill(toks)
            got[req.rid].append(out[0][0, -1])
            return out
        srv.prefill = rec_prefill
        try:
            admit(req, slot)
        finally:
            srv.prefill = prefill

    def rec_decode(tok, pos, cache):
        out = decode(tok, pos, cache)
        for s, req in enumerate(srv.live):
            if req is not None:
                got[req.rid].append(out[1][s, -1])
        return out

    srv.admit, srv.decode = rec_admit, rec_decode
    return got


def test_server_tokens_match_replay(dense_pair):
    """The server (2 slots, continuous batching, the whitening cache on):
    each request's logits, from its admit and from every decode step the
    batch ran with it in a slot, against the request replayed alone
    through the reference, each step fed the server's token: within
    ``_within_gap``'s bound; the server's token the reference's wherever
    the reference's top-2 margin exceeds twice that bound."""
    jcfg, params, cfg, model = dense_pair
    reqs = tserve.synthetic_requests(N_REQ, cfg.vocab, seed=0, lo=4, hi=40)
    srv = tserve.Server(cfg, model, slots=SLOTS, s_max=S_MAX,
                        max_new=MAX_NEW, eos_id=-1, whiten="cache",
                        gram_cache=ServingGramCache(refresh_stride=1,
                                                    synchronous=True),
                        device="cpu")
    srv.warm_up()
    warm = srv.forwards
    got = _recorded(srv, reqs)
    steps = tserve.run(srv, reqs, max_steps=N_REQ * MAX_NEW)
    assert len({srv._bucket(len(r.prompt)) for r in reqs}) >= 2
    assert warm == len(srv.bucket_ladder()) + 1
    assert srv.forwards == warm + len(reqs) + steps
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
    tol = _within_gap(port, chain, LOGIT_TOL, "server logits")
    compared = 0
    for rid, k, tt, w in gated:
        if _margin(w) > 2 * tol:
            assert tt == int(np.argmax(w)), (rid, k)
            compared += 1
    assert compared >= N_REQ


def test_admit_carries_the_mamba_state_through_slot_and_decode(pair):
    """The slot's conv buffer, ssm state and KV are the padded prefill's
    bit for bit (the other slot untouched), and a decode step from the
    server's cache leaves the state a decode step from the prefill's
    cache leaves, within ULPS ulps."""
    _, _, cfg, model = pair
    srv = tserve.Server(cfg, model, slots=2, s_max=32, max_new=3,
                        device="cpu")
    before = [{k: v.clone() for k, v in layer.items()}
              for layer in srv.cache]
    req = tserve.synthetic_requests(1, cfg.vocab, seed=3, lo=5, hi=9)[0]
    srv.admit(req, 1)
    toks = np.zeros((1, 16), np.int64)
    toks[0, :len(req.prompt)] = req.prompt
    _, fresh = model.prefill(torch.as_tensor(toks), 32)
    assert set(srv.cache[0]) == {"conv", "ssm"}
    for layer, old, new in zip(srv.cache, before, fresh):
        for k in layer:
            assert torch.equal(layer[k][0], old[k][0])
            assert torch.equal(layer[k][1], new[k][0])
    tok = torch.tensor([[req.generated[0]]])
    pos = torch.tensor([[len(req.prompt)]])
    want, fresh = model.decode_step(tok, pos, fresh)
    srv.step()
    assert srv.live[1] is req and len(req.generated) == 2
    # the batch of 2 rounds its f32 projections apart from a batch of 1
    for layer, new in zip(srv.cache, fresh):
        for k in layer:
            _ulps_close(layer[k][1].float(), new[k][0].float(),
                        f"slot state {k} after a decode step")


def test_cpu_serve_launches_no_kernel():
    """The smoke serve through the CLI's entry point, and through
    ``serve(cfg=)`` at a cut depth: on the CPU nothing is launched."""
    args = tserve.build_argparser().parse_args(
        ["--arch", ARCH, "--device", "cpu", "--requests", "3",
         "--max-new", "3", "--whiten", "off"])
    counts.reset_launch_counts()
    out = tserve.serve(args)
    assert out["completed"] == 3 and out["layers"] == 8
    cut = dataclasses.replace(get_smoke_config(ARCH), n_layers=8,
                              d_model=32, head_dim=8, d_ff=64)
    out = tserve.serve(args, cfg=cut)
    assert out["completed"] == 3 and out["d_model"] == 32
    assert set(counts.launch_counts().values()) == {0}
