"""repro_torch's sLSTM scan with bf16 gates, over the edges of the
kernel's steps, against the JAX package.

- bf16 gates: ``kernels.slstm.slstm_scan`` takes the four d-major views
  of a bf16 (B, S, d, 4) pre-activation (what ``slstm_mixer`` now hands
  it).  On the CPU it upcasts them, so its result equals, bit for bit,
  the scan of the f32 upcast's views, and it is held to the Pallas
  kernel ``repro.kernels.slstm.slstm_scan`` (interpret mode, which casts
  its bf16 operands to f32 itself) at the reference kernel test's
  tolerances (y 2e-5, state 2e-4, relative and absolute).
- the edges of the kernel's steps (it runs 8 steps at a time and reads
  its gate quads 24 steps ahead): bf16 quad views through ``slstm_scan``
  are held to ``repro.models.ssm._slstm_seq`` at the same tolerances
  for S = 1, S below a group of 8, S below the lookahead, S past it and
  not a multiple of 8, and cold, warm and n₀ < 1 states.
- ``slstm_mixer`` hands the kernel its bf16 views without an f32 copy,
  and gives what the f32 pre-activation gave, bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.slstm import slstm_scan as j_slstm_scan
from repro.models import ssm as jssm
from repro_torch.kernels import slstm as tslstm
from repro_torch.models import ssm
from repro_torch.models.common import ArchConfig

Y_TOL = dict(rtol=2e-5, atol=2e-5)         # tests/test_slstm_kernel.py
STATE_TOL = dict(rtol=2e-4, atol=2e-4)


def _pre(b, s, d, seed, dtype=torch.float32):
    """A (B, S, d, 4) pre-activation; input and forget gates scaled by
    2.5, as the reference kernel test scales them."""
    r = np.random.default_rng(seed)
    pre = r.standard_normal((b, s, d, 4)).astype(np.float32) \
        * np.array([1.0, 2.5, 2.5, 1.0], np.float32)
    return torch.tensor(pre).to(dtype)


def _state(b, d, kind, seed):
    r = np.random.default_rng(seed)
    if kind == "cold":
        st = [np.zeros((b, d)), np.ones((b, d)), np.zeros((b, d))]
    elif kind == "warm":
        st = [r.standard_normal((b, d)), 1 + np.abs(r.standard_normal(
            (b, d))), r.standard_normal((b, d))]
    else:                                     # n0 in (0, 1)
        st = [0.3 * r.standard_normal((b, d)), r.uniform(0.05, 0.95, (b, d)),
              r.standard_normal((b, d))]
    return [torch.tensor(x, dtype=torch.float32) for x in st]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# bf16 gates
# ---------------------------------------------------------------------------
BF16_CASES = [(b, s, d, kind) for (b, s, d) in ((1, 16, 128), (4, 1, 64),
                                                (2, 40, 96))
              for kind in ("cold", "warm")]


@pytest.mark.parametrize("b,s,d,kind", BF16_CASES)
def test_bf16_views_equal_the_f32_upcast_bit_for_bit(b, s, d, kind):
    pre = _pre(b, s, d, seed=s + d, dtype=torch.bfloat16)
    st = _state(b, d, kind, seed=d)
    got = tslstm.slstm_scan(*pre.unbind(-1), *st)
    want = tslstm.slstm_scan(*pre.float().unbind(-1), *st)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)


@pytest.mark.parametrize("b,s,d,kind", BF16_CASES)
def test_bf16_views_match_pallas_kernel(b, s, d, kind):
    pre = _pre(b, s, d, seed=s + d + 1, dtype=torch.bfloat16)
    st = _state(b, d, kind, seed=d + 1)
    got = tslstm.slstm_scan(*pre.unbind(-1), *st)
    gates = [jnp.asarray(g.float().numpy(), jnp.bfloat16)
             for g in pre.unbind(-1)]
    want = j_slstm_scan(*gates, *(jnp.asarray(x.numpy()) for x in st),
                        interpret=True)
    _close(got[0], want[0], Y_TOL)
    for g, w in zip(got[1:], want[1:]):
        _close(g, w, STATE_TOL)


def test_bf16_strided_views_upcast_each_gate():
    """Views that are not the quad layout (a gate-major (B, S, 4, d)
    tensor) take the per-gate upcast and agree with the f32 scan."""
    b, s, d = 2, 12, 32
    pre = _pre(b, s, d, seed=7, dtype=torch.bfloat16)
    gm = pre.permute(0, 1, 3, 2).contiguous()        # (B, S, 4, d)
    views = gm.unbind(2)
    assert tslstm._quad_base(views) is None
    st = _state(b, d, "warm", seed=7)
    got = tslstm.slstm_scan(*views, *st)
    want = tslstm.slstm_scan(*(v.float() for v in views), *st)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_quad_base_detects_the_mixer_layout():
    pre = _pre(2, 8, 16, seed=1, dtype=torch.bfloat16)
    views = pre.unbind(-1)
    assert tslstm._quad_base(views) == pre.data_ptr()
    assert tslstm._quad_base([v.contiguous() for v in views]) is None
    assert tslstm._quad_base(views[1:] + views[:1]) is None   # gate order
    shifted = torch.zeros(2 * 8 * 16 * 4 + 1, dtype=torch.bfloat16)[1:]
    assert tslstm._quad_base(shifted.view(2, 8, 16, 4).unbind(-1)) is None


def test_scan_rejects_mixed_gate_dtypes():
    z = torch.zeros(1, 4, 8)
    st = torch.zeros(1, 8)
    with pytest.raises(TypeError):
        tslstm.slstm_scan(z, z.bfloat16(), z, z, st, st, st)
    with pytest.raises(TypeError):                    # the state is f32
        tslstm.slstm_scan(z, z, z, z, st.bfloat16(), st, st)


# ---------------------------------------------------------------------------
# the edges of the kernel's steps
# ---------------------------------------------------------------------------
EDGE_CASES = [(s, kind) for s in (1, 3, 21, 99)
              for kind in ("cold", "warm", "n0<1")]


@pytest.mark.parametrize("s,kind", EDGE_CASES)
def test_bf16_scan_matches_slstm_seq(s, kind):
    b, d = 2, 64
    pre = _pre(b, s, d, seed=s + 5, dtype=torch.bfloat16)
    st = _state(b, d, kind, seed=s)
    y, c, n, m = tslstm.slstm_scan(*pre.unbind(-1), *st)
    y_ref, st_ref = jssm._slstm_seq(
        *(jnp.asarray(g.float().numpy()) for g in pre.unbind(-1)),
        {k: jnp.asarray(x.numpy()) for k, x in zip("cnm", st)})
    assert y.shape == (b, s, d)
    _close(y, y_ref, Y_TOL)
    for got, k in zip((c, n, m), "cnm"):
        _close(got, st_ref[k], STATE_TOL)


# ---------------------------------------------------------------------------
# the mixer hands in bf16
# ---------------------------------------------------------------------------
class _P:
    def __init__(self, d, seed):
        r = np.random.default_rng(seed)
        self.wx = torch.tensor(r.standard_normal((d, 4 * d)).astype(
            np.float32) / d ** 0.5).to(torch.bfloat16)
        self.wo = torch.tensor(r.standard_normal((d, d)).astype(
            np.float32) / d ** 0.5).to(torch.bfloat16)


@pytest.mark.parametrize("s", [1, 24])
def test_mixer_hands_bf16_views_and_keeps_its_output(s, monkeypatch):
    d, b = 64, 2
    cfg = ArchConfig(name="mixer", n_layers=1, d_model=d, n_heads=2,
                     n_kv_heads=2, d_ff=0, vocab=16)
    p = _P(d, seed=s)
    x = torch.tensor(np.random.default_rng(s + 1).standard_normal(
        (b, s, d)).astype(np.float32)).to(torch.bfloat16)
    st = dict(zip("cnm", _state(b, d, "warm", seed=3)))
    seen = []
    real = ssm.slstm_scan

    def spy(*args, **kw):
        seen.append(args[:4])
        return real(*args, **kw)
    monkeypatch.setattr(ssm, "slstm_scan", spy)
    out, new = ssm.slstm_mixer(cfg, p, x, dict(st))
    [gates] = seen
    assert all(g.dtype == torch.bfloat16 for g in gates)
    assert tslstm._quad_base(gates) is not None       # no copies apart
    # what the mixer gave when it upcast the pre-activation itself
    pre = (x @ p.wx).reshape(b, s, d, 4).float()
    y, c, n, m = tslstm._slstm_scan_plain(*pre.unbind(-1), st["c"],
                                          st["n"], st["m"])
    assert torch.equal(out, y.to(x.dtype) @ p.wo)
    for k, want in zip("cnm", (c, n, m)):
        assert torch.equal(new[k], want)
