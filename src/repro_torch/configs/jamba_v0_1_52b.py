"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336,
MoE 16 experts top-2 — Mamba + attention at 1:7 interleave
[arXiv:2403.19887].

Period of 8: attention at index 3, Mamba elsewhere; MoE MLP every other
layer (odd indices), dense MLP otherwise.  Sub-quadratic overall (4
attention layers of 32): eligible for long_500k.

The 32 layers (≈ 51.6 B parameters, ≈ 103 GB in bf16) do not fit one
80 GB card: the port serves it at full width and one period
(``dataclasses.replace(CONFIG, n_layers=8)``, ≈ 26.6 GB), which holds
every block kind of the pattern.
"""
from repro_torch.models.common import ArchConfig, BlockSpec, MoECfg

_MD = BlockSpec(mixer="mamba", mlp="dense")
_MM = BlockSpec(mixer="mamba", mlp="moe")
_AD = BlockSpec(mixer="attn", mlp="dense")
_AM = BlockSpec(mixer="attn", mlp="moe")

CONFIG = ArchConfig(
    remat_policy="names",   # dots policy stacks per-expert matmuls
    name="jamba-v0.1-52b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=65536,
    pattern=(_MD, _MM, _MD, _AM, _MD, _MM, _MD, _MM),
    moe=MoECfg(n_experts=16, top_k=2, n_shared=0, d_ff_expert=14336),
    act="silu", norm="rmsnorm", subquadratic=True,
    mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
    fsdp_params=True,
)

SMOKE = ArchConfig(
    name="jamba-v0.1-52b-smoke",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256,
    pattern=(_MD, _MM, _MD, _AM, _MD, _MM, _MD, _MM),
    moe=MoECfg(n_experts=4, top_k=2, n_shared=0, d_ff_expert=128),
    act="silu", norm="rmsnorm", subquadratic=True,
)
