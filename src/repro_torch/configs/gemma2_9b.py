"""gemma2-9b [dense]: 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000 — alternating local(4096)/global attention with logit
softcaps (attn 50, final 30) [arXiv:2408.00118].
"""
from repro_torch.models.common import ArchConfig, BlockSpec

_LOCAL = BlockSpec(mixer="attn", mlp="dense", local_window=4096)
_GLOBAL = BlockSpec(mixer="attn", mlp="dense", local_window=0)

CONFIG = ArchConfig(
    name="gemma2-9b",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=14336, vocab=256000,
    pattern=(_LOCAL, _GLOBAL),
    act="gelu", norm="rmsnorm", post_block_norm=True, embed_scale=True,
    attn_softcap=50.0, final_softcap=30.0,
    fsdp_params=True,
)

SMOKE = ArchConfig(
    name="gemma2-9b-smoke",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512,
    pattern=(_LOCAL, _GLOBAL),
    act="gelu", norm="rmsnorm", post_block_norm=True, embed_scale=True,
    attn_softcap=50.0, final_softcap=30.0,
)
