"""repro_torch's xLSTM mixers and the sLSTM scan against the JAX package.

Oracles, on the same numpy inputs from a seed:

- ``kernels.slstm.slstm_scan`` on CPU tensors runs its plain version; it
  is held to the Pallas kernel ``repro.kernels.slstm.slstm_scan`` in
  interpret mode and to ``repro.models.ssm._slstm_seq``, with the
  reference kernel test's tolerances (y 2e-5, state 2e-4, relative and
  absolute).  The CUDA kernel is held to the same plain version on the
  card by ``chip_smoke.py``.
- ``_mlstm_seq`` / ``_mlstm_chunkwise`` against the reference's, f32 in
  and out: y within 2e-4, state within 2e-3 (``tests/test_ssm_chunkwise.py``).
- ``slstm_mixer`` / ``mlstm_mixer`` against the reference's mixers
  (which switch to ``_slstm_parallel`` for s > 8 and to the chunkwise
  mLSTM for s % 128 == 0 and s > 128).  x and the weights are bf16, and
  the two frameworks round the bf16 projections at different places, so
  the gates differ by bf16 ulps before the recurrence: the bf16 output
  is held to MIXER_ATOL (a few bf16 ulps at the output's scale) and the
  f32 state to 2e-3.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.slstm import hbm_traffic_bytes as j_traffic
from repro.kernels.slstm import slstm_scan as j_slstm_scan
from repro.models import ssm as jssm
from repro.models.common import ArchConfig as JArchConfig
from repro_torch.kernels import slstm as tslstm
from repro_torch.kernels import counts
from repro_torch.models import ssm
from repro_torch.models.common import ArchConfig
from test_torch_hygiene import limit_torch_threads  # noqa: F401

Y_TOL = dict(rtol=2e-5, atol=2e-5)         # tests/test_slstm_kernel.py
SCAN_STATE_TOL = dict(rtol=2e-4, atol=2e-4)
MLSTM_Y_TOL = dict(rtol=2e-4, atol=2e-4)   # tests/test_ssm_chunkwise.py
STATE_TOL = dict(rtol=2e-3, atol=2e-3)
#: bf16 mixer outputs here have |out| < 1, where one bf16 ulp is at most
#: 2^-8; the gates entering the recurrence already differ by bf16 ulps,
#: so allow 4 such ulps (measured ≤ 1, at |out| ≤ 0.68)
MIXER_ATOL = 4 * 2.0 ** -8


def _rng(seed):
    return np.random.default_rng(seed)


def _gates(b, s, d, seed, scale=2.5):
    r = _rng(seed)
    return [(r.standard_normal((b, s, d)) * (scale if i in (1, 2) else 1.0))
            .astype(np.float32) for i in range(4)]


def _slstm_state(b, d, warm, seed):
    if not warm:
        return [np.zeros((b, d), np.float32), np.ones((b, d), np.float32),
                np.zeros((b, d), np.float32)]
    # a state the recurrence really reaches: a 16-step prefix
    z, ig, fg, og = _gates(b, 16, d, seed + 100)
    st = {"c": jnp.zeros((b, d)), "n": jnp.ones((b, d)),
          "m": jnp.zeros((b, d))}
    _, st = jssm._slstm_seq(z, ig, fg, og, st)
    return [np.asarray(st[k], np.float32) for k in ("c", "n", "m")]


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32), **tol)


SCAN_CASES = [(warm, s, d) for warm in (False, True) for s in (1, 64, 96)
              for d in (64, 256)]


@pytest.mark.parametrize("warm,s,d", SCAN_CASES)
def test_slstm_scan_plain_matches_pallas_kernel(warm, s, d):
    b = 2
    gates = _gates(b, s, d, seed=s + d)
    state = _slstm_state(b, d, warm, seed=d)
    counts.reset_launch_counts()
    got = tslstm.slstm_scan(*_t(*gates), *_t(*state))
    assert counts.launch_counts()["slstm_scan"] == 0   # plain, on CPU
    want = j_slstm_scan(*map(jnp.asarray, gates + state), interpret=True)
    _close(got[0], want[0], Y_TOL)
    for g, w in zip(got[1:], want[1:]):
        _close(g, w, SCAN_STATE_TOL)


@pytest.mark.parametrize("warm,s,d", SCAN_CASES)
def test_slstm_scan_plain_matches_slstm_seq(warm, s, d):
    b = 2
    gates = _gates(b, s, d, seed=s + d + 1)
    state = _slstm_state(b, d, warm, seed=d + 1)
    y, st = ssm._slstm_seq(*_t(*gates),
                           dict(zip("cnm", _t(*state))))
    y_ref, st_ref = jssm._slstm_seq(
        *map(jnp.asarray, gates), dict(zip("cnm", map(jnp.asarray, state))))
    _close(y, y_ref, Y_TOL)
    for k in "cnm":
        _close(st[k], st_ref[k], SCAN_STATE_TOL)


def test_slstm_scan_takes_strided_gate_views():
    """The mixer's four d-major views (channel stride 4) give what four
    contiguous gate tensors give (to 1e-6: the CPU's vectorised and
    scalar exp differ in the last bits)."""
    b, s, d = 2, 12, 32
    pre = torch.tensor(_rng(5).standard_normal((b, s, d, 4)).astype(
        np.float32))
    views = pre.unbind(-1)
    assert views[1].stride() == (s * d * 4, d * 4, 4)
    state = _t(*_slstm_state(b, d, True, seed=5))
    got = tslstm.slstm_scan(*views, *state)
    want = tslstm.slstm_scan(*(v.contiguous() for v in views), *state)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def test_slstm_scan_rejects_bad_operands():
    z = torch.zeros(1, 4, 8)
    st = torch.zeros(1, 8)
    with pytest.raises(TypeError):
        tslstm.slstm_scan(z.double(), z, z, z, st, st, st)
    with pytest.raises(ValueError):
        tslstm.slstm_scan(z, z, z, z[:, :3], st, st, st)
    with pytest.raises(ValueError):
        tslstm.slstm_scan(z, z, z, z, torch.zeros(8, 2).T, st, st)
    with pytest.raises(RuntimeError):               # no kernel, no fallback
        tslstm._kernel_device(types.SimpleNamespace(device=torch.device("xpu")))
    # meta (the dry run): a shape function, never the plain version
    plain = tslstm._slstm_scan_plain
    tslstm._slstm_scan_plain = None
    try:
        out = tslstm.slstm_scan(*(x.to("meta") for x in (z, z, z, z, st, st,
                                                         st)))
    finally:
        tslstm._slstm_scan_plain = plain
    assert [(o.device.type, tuple(o.shape)) for o in out] == \
        [("meta", (1, 4, 8))] + [("meta", (1, 8))] * 3


@pytest.mark.parametrize("b,s,d", [(16, 4096, 1024), (2, 32768, 1024),
                                   (1, 64, 1024), (4, 1, 1024)])
def test_hbm_traffic_bytes_is_the_reference_model(b, s, d):
    assert tslstm.hbm_traffic_bytes(b, s, d) == j_traffic(b, s, d)


# ---------------------------------------------------------------------------
# mLSTM recurrences
# ---------------------------------------------------------------------------
B, H, HD = 2, 2, 16


def _qkvg(s, seed, gate_scale=3.0):
    r = _rng(seed)
    q, k, v = (r.standard_normal((B, s, H, HD)).astype(np.float32)
               for _ in range(3))
    ig, fg = (gate_scale * r.standard_normal((B, s, H)).astype(np.float32)
              for _ in range(2))
    return [q * HD ** -0.5, k * HD ** -0.5, v, ig, fg]


def _mlstm_state(carried, seed):
    st = {"C": jnp.zeros((B, H, HD, HD)), "n": jnp.zeros((B, H, HD)),
          "m": jnp.full((B, H), -1e30)}
    if carried:                      # the state after a 16-step prefix
        _, st = jssm._mlstm_seq(*map(jnp.asarray, _qkvg(16, seed + 50)), st)
    return {k: np.asarray(v, np.float32) for k, v in st.items()}


def _run_mlstm(fn_t, fn_j, s, carried, seed, **kw):
    xs = _qkvg(s, seed)
    st = _mlstm_state(carried, seed)
    y, new = fn_t(*_t(*xs), {k: torch.tensor(v) for k, v in st.items()},
                  **kw)
    y_ref, new_ref = fn_j(*map(jnp.asarray, xs),
                          {k: jnp.asarray(v) for k, v in st.items()}, **kw)
    _close(y, y_ref, MLSTM_Y_TOL)
    for k in ("C", "n", "m"):
        _close(new[k], new_ref[k], STATE_TOL)


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("s", [1, 64, 256])
def test_mlstm_seq_matches_reference(s, carried):
    _run_mlstm(ssm._mlstm_seq, jssm._mlstm_seq, s, carried, seed=s)


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("s,chunk", [(1, 1), (64, 32), (256, 128)])
def test_mlstm_chunkwise_matches_reference(s, chunk, carried):
    _run_mlstm(ssm._mlstm_chunkwise, jssm._mlstm_chunkwise, s, carried,
               seed=s + 1, chunk=chunk)


@pytest.mark.parametrize("carried", [False, True])
def test_mlstm_chunkwise_matches_seq_and_underflows_m0(carried):
    """m₀ = −1e30 gives e^{m₀−w} = 0, never NaN."""
    xs = _t(*_qkvg(256, 9))
    st = {k: torch.tensor(v) for k, v in _mlstm_state(carried, 9).items()}
    y_seq, st_seq = ssm._mlstm_seq(*xs, st)
    y_chk, st_chk = ssm._mlstm_chunkwise(*xs, st)
    assert torch.isfinite(y_chk).all()
    _close(y_chk, y_seq.numpy(), MLSTM_Y_TOL)
    for k in ("C", "n", "m"):
        _close(st_chk[k], st_seq[k].numpy(), STATE_TOL)


# ---------------------------------------------------------------------------
# mixers (bf16 projections)
# ---------------------------------------------------------------------------
D_MODEL, N_HEADS = 64, 2


def _cfgs():
    kw = dict(name="mixer", n_layers=1, d_model=D_MODEL, n_heads=N_HEADS,
              n_kv_heads=N_HEADS, d_ff=0, vocab=16)
    return JArchConfig(**kw), ArchConfig(**kw)


class _P:
    """Weights as attributes, the way the port's mixer modules hold
    them."""

    def __init__(self, params):
        for k, v in params.items():
            setattr(self, k, torch.tensor(np.asarray(v, np.float32)).to(
                torch.bfloat16))


def _weights(kind, seed):
    jcfg, _ = _cfgs()
    init = jssm.mlstm_params if kind == "mlstm" else jssm.slstm_params
    return init(jcfg, jax.random.key(seed))


def _x(s, seed):
    return _rng(seed).standard_normal((B, s, D_MODEL)).astype(np.float32)


def _mixer_state(kind, carried, params, seed):
    """Zero (initial) or carried state, from the reference mixer on a
    12-token prefix."""
    jcfg, _ = _cfgs()
    init = jssm.mlstm_state_init if kind == "mlstm" else \
        jssm.slstm_state_init
    mixer = jssm.mlstm_mixer if kind == "mlstm" else jssm.slstm_mixer
    st = init(jcfg, B)
    if carried:
        _, st = mixer(jcfg, params, jnp.asarray(_x(12, seed + 7),
                                                jnp.bfloat16), st)
    return {k: np.asarray(v, np.float32) for k, v in st.items()}


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("kind,s", [("slstm", 1), ("slstm", 8),
                                    ("slstm", 64), ("mlstm", 1),
                                    ("mlstm", 64), ("mlstm", 256)])
def test_mixer_matches_reference(kind, s, carried):
    jcfg, cfg = _cfgs()
    params = _weights(kind, seed=s)
    st = _mixer_state(kind, carried, params, seed=s)
    x = _x(s, seed=s + 3)
    jmix = jssm.mlstm_mixer if kind == "mlstm" else jssm.slstm_mixer
    tmix = ssm.mlstm_mixer if kind == "mlstm" else ssm.slstm_mixer
    want, want_st = jmix(jcfg, params, jnp.asarray(x, jnp.bfloat16),
                         {k: jnp.asarray(v) for k, v in st.items()})
    got, got_st = tmix(cfg, _P(params),
                       torch.tensor(x).to(torch.bfloat16),
                       {k: torch.tensor(v) for k, v in st.items()})
    assert got.dtype == torch.bfloat16 and got.shape == (B, s, D_MODEL)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=MIXER_ATOL, rtol=0)
    for k, v in want_st.items():
        _close(got_st[k], v, STATE_TOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_mixer_without_state_returns_none(kind):
    _, cfg = _cfgs()
    params = _P(_weights(kind, seed=1))
    tmix = ssm.mlstm_mixer if kind == "mlstm" else ssm.slstm_mixer
    init = ssm.mlstm_state_init if kind == "mlstm" else ssm.slstm_state_init
    x = torch.tensor(_x(8, 2)).to(torch.bfloat16)
    out, st = tmix(cfg, params, x)
    out2, _ = tmix(cfg, params, x, init(cfg, B, torch.device("cpu")))
    assert st is None and torch.equal(out, out2)


def test_state_init_matches_reference():
    jcfg, cfg = _cfgs()
    cpu = torch.device("cpu")
    for tinit, jinit in ((ssm.mlstm_state_init, jssm.mlstm_state_init),
                         (ssm.slstm_state_init, jssm.slstm_state_init)):
        got, want = tinit(cfg, 3, cpu), jinit(jcfg, 3)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
