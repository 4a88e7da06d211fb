"""stablelm-1.6b [dense]: 24L d_model=2048 32H (MHA) d_ff=5632
vocab=100352 [hf:stabilityai/stablelm-2-1_6b].

LayerNorm, SwiGLU, partial rotary embeddings (25% of head dim).
"""
from repro_torch.models.common import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=5632, vocab=100352,
    pattern=(BlockSpec(mixer="attn", mlp="dense"),),
    act="silu", norm="layernorm", rope_fraction=0.25,
)

SMOKE = ArchConfig(
    name="stablelm-1.6b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=160, vocab=512,
    pattern=(BlockSpec(mixer="attn", mlp="dense"),),
    act="silu", norm="layernorm", rope_fraction=0.25,
)
