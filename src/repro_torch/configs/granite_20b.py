"""granite-20b [dense]: 52L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152 — GPT-BigCode-family code model [arXiv:2405.04324].

Multi-query attention (single KV head), plain GELU MLP, layernorm.
"""
from repro_torch.models.common import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="granite-20b",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab=49152,
    pattern=(BlockSpec(mixer="attn", mlp="dense"),),
    act="gelu_mlp", norm="layernorm",
    fsdp_params=True,
)

SMOKE = ArchConfig(
    name="granite-20b-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=1,
    d_ff=256, vocab=256,
    pattern=(BlockSpec(mixer="attn", mlp="dense"),),
    act="gelu_mlp", norm="layernorm",
)
