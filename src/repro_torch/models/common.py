"""Shared model infrastructure: config schema, norms, RoPE, initialisers.

Port of :mod:`repro.models.common` for the blocks the port serves:
attention + dense MLP (stablelm) and the xLSTM mixers with no MLP
(xlstm).  Tensors keep the reference's layouts
((B, S, d) activations, (B, S, H, D) heads) and dtypes (bf16 weights
and activations, f32 norm parameters and f32 softmax).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


# ---------------------------------------------------------------------------
# block descriptors
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class BlockSpec:
    mixer: str = "attn"          # attn | mlstm | slstm (mamba waits)
    mlp: str = "dense"           # dense | none (moe waits)
    local_window: int = 0        # sliding-window size; 0 = global attention


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
    attn_kind: str = "gqa"                  # gqa (mla waits)
    norm: str = "rmsnorm"                   # rmsnorm | layernorm
    act: str = "silu"                       # silu | gelu (gated) | gelu_mlp
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0              # stablelm: 0.25 partial rotary
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    post_block_norm: bool = False
    tie_embeddings: bool = False
    embed_scale: bool = False
    frontend: str = "tokens"                # tokens (embeddings | vlm wait)
    remat_policy: str = "full"              # full | dots | names

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def period(self) -> int:
        return len(self.pattern)


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
    return (w * std).to(torch.bfloat16)


def embed_init(shape, gen: torch.Generator,
               device: torch.device) -> torch.Tensor:
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.to(torch.bfloat16)
