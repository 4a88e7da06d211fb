"""The symmetric kernels' tensor-core arithmetic, emulated on the CPU.

``trigrid.matmul_tf32`` repeats what the CUDA kernels compute: operands
rounded to TF32 as ``cvt.rna.tf32.f32`` rounds (to nearest, ties away
from zero) and, with ``passes=3``, split as x = big + small with
big = tf32(x), small = x − big truncated to TF32 (the tensor cores read
its top 19 bits), the product being small·big′ + big·small′ + big·big′
(3xTF32).  At the Newton–Schulz
contraction depth (K = 2048) that meets the kernels' f32 tolerance
against an f64 product; one TF32 product (``passes=1``) does not, which
is why the port never uses it.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import trigrid
from test_torch_hygiene import limit_torch_threads  # noqa: F401

#: the kernels' f32 tolerance: max |got − want| / max(1, max |want|)
TOL_F32 = 2e-5


def _rel(got: torch.Tensor, want: np.ndarray) -> float:
    err = np.abs(got.double().numpy() - want).max()
    return float(err / max(1.0, np.abs(want).max()))


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(torch.int32).numpy().astype(np.int64) \
        & 0xFFFFFFFF


@pytest.mark.parametrize("value, want", [
    (1.0, 1.0),
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),     # tie: away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -12, 1.0),                  # below half an ulp: down
    (1.0 + 3 * 2.0 ** -12, 1.0 + 2.0 ** -10),
    (-2.5, -2.5),
])
def test_tf32_round_matches_rna(value, want):
    got = trigrid.tf32_round(torch.tensor([value], dtype=torch.float32))
    np.testing.assert_array_equal(got.numpy(), np.float32([want]))


def test_tf32_round_keeps_ten_mantissa_bits_and_specials():
    x = torch.tensor(np.random.default_rng(0).standard_normal(4096),
                     dtype=torch.float32) * 1e3
    r = trigrid.tf32_round(x)
    assert (_bits(r) & 0x1FFF == 0).all()            # low 13 bits cleared
    assert ((r - x).abs() <= x.abs() * 2.0 ** -11).all()
    special = torch.tensor([float("inf"), -float("inf"), float("nan")])
    out = trigrid.tf32_round(special)
    assert _bits(out).tolist() == [0x7F800000, 0xFF800000, 0x7FC00000]
    assert trigrid.tf32_round(torch.zeros(3)).eq(0).all()


def test_tf32_truncate_reads_the_top_19_bits():
    x = _from_bits([0x3F800FFF, 0xBF801FFF, 0x7FFFFFFF, 0x7FC00000,
                    0x7F800000])
    assert _bits(trigrid.tf32_truncate(x)).tolist() == [
        0x3F800000, 0xBF800000, 0x7FFFE000, 0x7FC00000, 0x7F800000]


def _from_bits(bits) -> torch.Tensor:
    u = np.array(bits, dtype=np.uint64).astype(np.uint32)
    return torch.tensor(u.view(np.int32)).view(torch.float32)


@pytest.mark.parametrize("bits", [
    0x7FFFFFFF,      # the GPU's canonical NaN (0/0, inf − inf)
    0xFFFFFFFF,      # the same with the sign set
    0x7FC00000,      # the CPU's quiet NaN
    0xFFC00000,
    0x7F800001,      # a NaN whose only mantissa bit is below TF32's
    0x7FFFF000,      # mantissa bits 12-22 set: the add alone carries
])
def test_3xtf32_split_keeps_every_nan(bits):
    """The rounding's add may carry a NaN's mantissa into the exponent or
    the sign (0x7FFFFFFF into -0, 0xFFFFFFFF into +0, as the kernels'
    integer rounding does), but the small part x − big, which the
    kernels do not round, is then a NaN, and so is every product the
    operand meets."""
    x = _from_bits([bits])
    big = trigrid.tf32_round(x)
    small = trigrid.tf32_truncate(x - big)
    assert torch.isnan(small).all()
    if bits in (0x7FFFFFFF, 0xFFFFFFFF):
        assert _bits(big).tolist() == [0x80000000 if bits == 0x7FFFFFFF
                                       else 0x0]
    a = torch.ones(3, 4)
    a[1, 2] = x[0]
    got = trigrid.matmul_tf32(a, torch.ones(4, 2))
    assert torch.isnan(got[1]).all() and torch.isfinite(got[[0, 2]]).all()
    got = trigrid.matmul_tf32(torch.zeros(2, 4), a.T.contiguous())
    assert torch.isnan(got[:, 1]).all()


def test_tf32_round_at_the_edge_of_the_range():
    """The largest finite f32 rounds up to inf, as ``cvt.rna`` rounds;
    subnormals round like any other value."""
    out = _bits(trigrid.tf32_round(_from_bits(
        [0x7F7FFFFF, 0xFF7FFFFF, 0x00000FFF, 0x00001000])))
    assert out.tolist() == [0x7F800000, 0xFF800000, 0x0, 0x2000]


def test_3xtf32_propagates_nan_and_inf():
    """A NaN operand makes its row (of a) or column (of b) of the 3xTF32
    product NaN, whatever its bits; an inf makes them non-finite."""
    rng = np.random.default_rng(3)
    a = torch.tensor(rng.standard_normal((8, 64)).astype(np.float32))
    b = torch.tensor(rng.standard_normal((64, 6)).astype(np.float32))
    a[2, 5] = _from_bits([0x7FFFFFFF])[0]
    b[9, 4] = _from_bits([0xFFFFFFFF])[0]
    a[6, 1] = float("inf")
    got = trigrid.matmul_tf32(a, b)
    nan = torch.isnan(got)
    assert nan[2].all() and nan[:, 4].all()
    assert not torch.isfinite(got[6]).any()
    finite = torch.ones_like(nan)
    finite[[2, 6]] = False
    finite[:, 4] = False
    assert torch.isfinite(got[finite]).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_3xtf32_meets_f32_tolerance_and_1xtf32_does_not(seed):
    """NS-like operands (a symmetric matrix scaled by 1/sqrt(K), a
    Gaussian B) at the serving path's contraction depth K = 2048."""
    rng = np.random.default_rng(seed)
    k = 2048
    a = (rng.standard_normal((64, k)) / np.sqrt(k)).astype(np.float32)
    b = rng.standard_normal((k, 48)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    ta, tb = torch.tensor(a), torch.tensor(b)
    three = _rel(trigrid.matmul_tf32(ta, tb, passes=3), want)
    one = _rel(trigrid.matmul_tf32(ta, tb, passes=1), want)
    assert three <= TOL_F32, three
    assert one > TOL_F32, one
    assert one > 10 * three


def test_3xtf32_on_a_gram_diagonal():
    """Same-signed sums (the diagonal of A·Aᵀ) at K = 2048 stay within
    the tolerance too."""
    rng = np.random.default_rng(2)
    a = (rng.standard_normal((32, 2048)) / np.sqrt(2048)).astype(np.float32)
    want = a.astype(np.float64) @ a.T.astype(np.float64)
    got = trigrid.matmul_tf32(torch.tensor(a), torch.tensor(a.T.copy()))
    assert _rel(got, want) <= TOL_F32


def test_matmul_tf32_rejects_other_pass_counts():
    with pytest.raises(ValueError):
        trigrid.matmul_tf32(torch.ones(2, 2), torch.ones(2, 2), passes=2)
