"""xlstm-350m [ssm]: 24L d_model=1024 4H — sLSTM + mLSTM blocks
[arXiv:2405.04517], vocab 50304, no separate FFN (d_ff=0: the mixers
carry the capacity; no MLP is attached).

Pattern period 4 = three mLSTM + one sLSTM block (the paper's 7:1-ish
mix approximated at 3:1 for a 24-layer stack, as in the reference).
"""
from repro_torch.models.common import ArchConfig, BlockSpec

_M = BlockSpec(mixer="mlstm", mlp="none")
_S = BlockSpec(mixer="slstm", mlp="none")

CONFIG = ArchConfig(
    remat_policy="dots",    # saves the projections' outputs, as the reference
    name="xlstm-350m",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    pattern=(_M, _M, _M, _S),
    norm="layernorm",
)

SMOKE = ArchConfig(
    name="xlstm-350m-smoke",
    n_layers=4, d_model=64, n_heads=2, n_kv_heads=2,
    d_ff=0, vocab=256,
    pattern=(_M, _M, _M, _S),
    norm="layernorm",
)
