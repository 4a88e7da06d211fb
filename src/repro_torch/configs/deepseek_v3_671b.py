"""deepseek-v3-671b [moe]: 61L d_model=7168 128H (MLA kv_lora=512)
d_ff_expert=2048, 1 shared + 256 routed top-8, MTP [arXiv:2412.19437].

First 3 layers dense (d_ff=18432), remaining 58 MoE; one extra MTP block
predicts t+2 with weight 0.3.

The 61 layers (≈ 671 B parameters) do not fit one 80 GB card: the port
serves it at full width and 4 layers deep (the 3 dense prefix layers and
one MoE layer, with the MTP block's weights,
``dataclasses.replace(CONFIG, n_layers=4)``, ≈ 15.7 B parameters,
≈ 31.4 GB in bf16).
"""
from repro_torch.models.common import ArchConfig, BlockSpec, MLACfg, MoECfg

_DENSE = BlockSpec(mixer="attn", mlp="dense")
_MOE = BlockSpec(mixer="attn", mlp="moe")

CONFIG = ArchConfig(
    remat_policy="names",   # dots policy stacks per-expert matmuls
    name="deepseek-v3-671b",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=18432, vocab=129280,
    prefix=(_DENSE,) * 3,      # first 3 dense, 58 scanned MoE layers
    pattern=(_MOE,),
    attn_kind="mla",
    mla=MLACfg(kv_lora=512, q_lora=1536, rope_head_dim=64, v_head_dim=128,
               qk_nope_dim=128),
    moe=MoECfg(n_experts=256, top_k=8, n_shared=1, d_ff_expert=2048),
    act="silu", norm="rmsnorm", mtp=True, fsdp_params=True,
)

SMOKE = ArchConfig(
    name="deepseek-v3-671b-smoke",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=256,
    prefix=(_DENSE,),
    pattern=(_MOE,),
    attn_kind="mla",
    mla=MLACfg(kv_lora=32, q_lora=48, rope_head_dim=8, v_head_dim=16,
               qk_nope_dim=16),
    moe=MoECfg(n_experts=8, top_k=2, n_shared=1, d_ff_expert=32),
    act="silu", norm="rmsnorm", mtp=True,
)
