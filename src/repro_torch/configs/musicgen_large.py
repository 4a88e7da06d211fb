"""musicgen-large [audio]: 48L d_model=2048 32H (MHA) d_ff=8192 vocab=2048.

Decoder-only transformer over EnCodec tokens [arXiv:2306.05284].  The
EnCodec frontend is a stub, as in the reference: the model takes
precomputed frame embeddings (B, S, d_model); the LM head predicts the
2048-entry codebook.  Plain GELU MLP, MHA (kv == heads), learned-position
behaviour approximated with RoPE, as the reference does.

The port runs its frames through ``Model.prefill(None, s_max,
embeds=...)`` / ``Model.decode_step(None, pos, cache, embeds=...)``;
the server, token-only as the reference's, refuses it.
"""
from repro_torch.models.common import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="musicgen-large",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=2048,
    pattern=(BlockSpec(mixer="attn", mlp="dense"),),
    act="gelu_mlp", norm="layernorm",
    frontend="embeddings",
)

SMOKE = ArchConfig(
    name="musicgen-large-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab=128,
    pattern=(BlockSpec(mixer="attn", mlp="dense"),),
    act="gelu_mlp", norm="layernorm",
    frontend="embeddings",
)
