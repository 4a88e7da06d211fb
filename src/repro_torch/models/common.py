"""Shared model infrastructure: config schema, norms, RoPE, initialisers.

Port of :mod:`repro.models.common` for the blocks the port serves:
attention + dense MLP (stablelm; gemma2 / gemma3 with sliding windows,
softcaps, post-block norms and scaled embeddings; granite with MQA,
LayerNorm and the ungated GELU MLP; pixtral's ``vlm`` and musicgen's
``embeddings`` frontends), the xLSTM mixers with no MLP (xlstm), and the
Mamba mixer and the routed MoE MLP beside attention and the dense MLP
(jamba), and multi-head latent attention (MLA) with unscanned prefix
blocks, shared experts and the multi-token-prediction block (deepseek).
Tensors keep the reference's layouts
((B, S, d) activations, (B, S, H, D) heads) and dtypes (bf16 weights
and activations, f32 norm parameters and f32 softmax).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


# ---------------------------------------------------------------------------
# block descriptors
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class BlockSpec:
    mixer: str = "attn"          # attn | mamba | mlstm | slstm
    mlp: str = "dense"           # dense | moe | none
    local_window: int = 0        # sliding-window size; 0 = global attention


@dataclass(frozen=True)
class MoECfg:
    n_experts: int = 0
    top_k: int = 1
    n_shared: int = 0
    d_ff_expert: int = 0


@dataclass(frozen=True)
class MLACfg:
    kv_lora: int = 512
    q_lora: int = 0              # 0 = no query compression
    rope_head_dim: int = 64
    v_head_dim: int = 128
    qk_nope_dim: int = 128


@dataclass(frozen=True)
class ArchConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                       # 0 -> d_model // n_heads
    pattern: Tuple[BlockSpec, ...] = (BlockSpec(),)
    prefix: Tuple[BlockSpec, ...] = ()      # unscanned lead-in blocks
    attn_kind: str = "gqa"                  # gqa | mla
    mla: Optional[MLACfg] = None
    moe: Optional[MoECfg] = None
    norm: str = "rmsnorm"                   # rmsnorm | layernorm
    act: str = "silu"                       # silu | gelu (gated) | gelu_mlp
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0              # stablelm: 0.25 partial rotary
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    post_block_norm: bool = False
    tie_embeddings: bool = False
    embed_scale: bool = False
    frontend: str = "tokens"                # tokens | embeddings | vlm
    n_frontend_tokens: int = 0              # vlm: patch tokens per sample
    mtp: bool = False                       # deepseek-v3 multi-token predict
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    subquadratic: bool = False              # eligible for long_500k
    remat_policy: str = "full"              # full | dots | names
    fsdp_params: bool = False               # weight rows also over 'data'

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def n_periods(self) -> int:
        """The scanned periods: the layers after the prefix, over the
        pattern's length."""
        scanned = self.n_layers - len(self.prefix)
        assert scanned % self.period == 0, (self.n_layers, self.period)
        return scanned // self.period

    def param_count(self) -> int:
        """Parameters of the model, counted on a :class:`Model` built on
        the meta device (for the 6ND model-flops accounting)."""
        return _param_count(self)

    def active_param_count(self) -> int:
        """Active parameters a token (MoE: only top-k + shared experts),
        the reference's formula: the inactive routed experts of the MoE
        layers in ``pattern`` × ``n_periods`` (a prefix's or the MTP
        block's are not subtracted), 3·d·f each."""
        total = self.param_count()
        if not self.moe or not self.moe.n_experts:
            return total
        n_moe_layers = sum(1 for b in self.pattern if b.mlp == "moe") \
            * self.n_periods
        per_expert = 3 * self.d_model * self.moe.d_ff_expert
        inactive = (self.moe.n_experts - self.moe.top_k) * per_expert \
            * n_moe_layers
        return total - inactive


@functools.lru_cache(maxsize=None)
def _param_count(cfg: ArchConfig) -> int:
    from .model import Model  # lazy; counts from real shapes
    model = Model(cfg, torch.Generator(), torch.device("meta"))
    return sum(p.numel() for p in model.parameters())


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale + bias).to(x.dtype)


def apply_norm(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    """``p`` holds ``scale`` (and ``bias`` for LayerNorm)."""
    if cfg.norm == "layernorm":
        return layer_norm(x, p.scale, p.bias)
    return rms_norm(x, p.scale)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               fraction: float = 1.0) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S).  Rotates the first
    ``fraction·D`` dims (partial rotary à la stablelm), interleaved
    pairs as in the reference."""
    d = x.shape[-1]
    rot = int(d * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    freqs = rope_freqs(rot, theta, x.device)                 # (rot/2,)
    ang = positions[..., None].float() * freqs               # (B, S, rot/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = xr[..., ::2].float(), xr[..., 1::2].float()
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([out, xp], dim=-1)


# ---------------------------------------------------------------------------
# initialisers (truncated normal at ±2σ, f32 draw, bf16 storage)
# ---------------------------------------------------------------------------
def dense_init(shape, gen: torch.Generator, device: torch.device,
               in_axis: int = 0) -> torch.Tensor:
    std = 1.0 / math.sqrt(shape[in_axis])
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    # scaled in place: the product's bits, one f32 transient fewer (a
    # deepseek-v3 expert stack's f32 draw is 15 GB)
    return w.mul_(std).to(torch.bfloat16)


def embed_init(shape, gen: torch.Generator,
               device: torch.device) -> torch.Tensor:
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.to(torch.bfloat16)


# ---------------------------------------------------------------------------
# the remat policies' named outputs (the reference's ``checkpoint_name``)
# ---------------------------------------------------------------------------
@torch.library.custom_op("repro_torch::scan_out", mutates_args=())
def _scan_out(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


@_scan_out.register_fake
def _scan_out_fake(x: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(x)


_scan_out.register_autograd(lambda ctx, grad: grad)

#: the operator a selective-checkpoint policy saves under "names"
SCAN_OUT = torch.ops.repro_torch.scan_out.default


def scan_out(x: torch.Tensor) -> torch.Tensor:
    """Tag ``x`` as a recurrence's output, the reference's
    ``checkpoint_name(x, "scan_out")``: with autograd on, the identity
    operator :data:`SCAN_OUT` (a copy), whose outputs the "names" and
    "dots" remat policies keep (``models.model``); else ``x`` itself."""
    return _scan_out(x) if torch.is_grad_enabled() else x
