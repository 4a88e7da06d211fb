"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072 — Pixtral-ViT frontend + Mistral-NeMo-style decoder
[hf:mistralai/Pixtral-12B-2409].

The vision frontend is a stub, as in the reference: the model takes
precomputed patch embeddings (B, 256, d_model) that are prepended to the
text tokens (total sequence = 256 + text length).  The server, as the
reference's, serves text tokens alone (no patch embeddings);
``Model.prefill(tokens, s_max, patch_embeds=...)`` takes them.
"""
from repro_torch.models.common import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="pixtral-12b",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=131072,
    pattern=(BlockSpec(mixer="attn", mlp="dense"),),
    act="silu", norm="rmsnorm", rope_theta=1_000_000_000.0,
    frontend="vlm", n_frontend_tokens=256,
    fsdp_params=True,
)

SMOKE = ArchConfig(
    name="pixtral-12b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512,
    pattern=(BlockSpec(mixer="attn", mlp="dense"),),
    act="silu", norm="rmsnorm",
    frontend="vlm", n_frontend_tokens=16,
)
