"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144 — 5:1 local:global attention, 128k context
[hf:google/gemma-3 family].

Pattern period = 6: five sliding-window (1024) layers + one global layer.
GeGLU, RMSNorm with post-norms, embed scaling (gemma convention).
"""
from repro_torch.models.common import ArchConfig, BlockSpec

_LOCAL = BlockSpec(mixer="attn", mlp="dense", local_window=1024)
_GLOBAL = BlockSpec(mixer="attn", mlp="dense", local_window=0)

CONFIG = ArchConfig(
    name="gemma3-12b",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=15360, vocab=262144,
    pattern=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL),
    act="gelu", norm="rmsnorm", post_block_norm=True, embed_scale=True,
    rope_theta=1_000_000.0,
    fsdp_params=True,
)

SMOKE = ArchConfig(
    name="gemma3-12b-smoke",
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512,
    pattern=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL),
    act="gelu", norm="rmsnorm", post_block_norm=True, embed_scale=True,
)
