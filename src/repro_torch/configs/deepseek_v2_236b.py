"""deepseek-v2-236b [moe]: 60L d_model=5120 128H (MLA kv_lora=512)
d_ff_expert=1536, 2 shared + 160 routed top-6 experts [arXiv:2405.04434].

First layer dense (d_ff=12288), remaining layers MoE.  MLA with
q_lora=1536, qk_nope=128, rope=64, v_head=128.

The 60 layers (≈ 236 B parameters) do not fit one 80 GB card: the port
serves it at full width and 2 layers deep (the dense prefix layer and
one MoE layer, ``dataclasses.replace(CONFIG, n_layers=2)``, ≈ 5.4 B
parameters, ≈ 10.7 GB in bf16).
"""
from repro_torch.models.common import ArchConfig, BlockSpec, MLACfg, MoECfg

_DENSE = BlockSpec(mixer="attn", mlp="dense")
_MOE = BlockSpec(mixer="attn", mlp="moe")

CONFIG = ArchConfig(
    remat_policy="names",   # dots policy stacks per-expert matmuls
    name="deepseek-v2-236b",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=12288, vocab=102400,
    prefix=(_DENSE,),          # first layer dense, 59 scanned MoE layers
    pattern=(_MOE,),
    attn_kind="mla",
    mla=MLACfg(kv_lora=512, q_lora=1536, rope_head_dim=64, v_head_dim=128,
               qk_nope_dim=128),
    moe=MoECfg(n_experts=160, top_k=6, n_shared=2, d_ff_expert=1536),
    act="silu", norm="rmsnorm", fsdp_params=True,
)

SMOKE = ArchConfig(
    name="deepseek-v2-236b-smoke",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=256,
    prefix=(_DENSE,),
    pattern=(_MOE,),
    attn_kind="mla",
    mla=MLACfg(kv_lora=32, q_lora=48, rope_head_dim=8, v_head_dim=16,
               qk_nope_dim=16),
    moe=MoECfg(n_experts=8, top_k=2, n_shared=1, d_ff_expert=32),
    act="silu", norm="rmsnorm",
)
