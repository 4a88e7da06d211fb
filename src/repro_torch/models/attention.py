"""GQA attention with RoPE and a KV cache (port of the GQA half of
:mod:`repro.models.attention`; MLA and the streamed SDPA wait).

Layouts are the reference's: q (B, Sq, H, D), k/v (B, Sk, Hkv, D), the
cache (B, S_max, Hkv, D) in bf16.  The softmax runs in f32 as plain
tensor ops.  Tensor-parallel (``tp`` set by ``Model.shard_``), a rank
runs its n_heads / |model| heads and n_kv_heads / |model| KV heads, and
the output projection's partial sums are all-reduced in f32.  The streamed SDPA never triggers on the serving path
(sq·sk stays far below the reference's ``SDPA_STREAM_MIN``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..distributed.collectives import copy_to_group, row_parallel
from .common import ArchConfig, BlockSpec, apply_rope, dense_init, softcap

NEG_INF = -2.0e38


def _attn_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int,
               k_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, Sq, Sk) bool: causal + optional sliding window + cache
    validity."""
    m = q_pos[:, :, None] >= k_pos[:, None, :]
    if window > 0:
        m &= (q_pos[:, :, None] - k_pos[:, None, :]) < window
    if k_valid is not None:
        m &= k_valid[:, None, :]
    return m


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor, cap: float, scale: float) -> torch.Tensor:
    """q: (B,Sq,H,D), k/v: (B,Sk,Hkv,D) with H % Hkv == 0."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qf = q.reshape(b, sq, hkv, g, d).float() * scale
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    logits = softcap(logits, cap)
    logits = torch.where(mask[:, None, None], logits,
                         torch.tensor(NEG_INF, device=logits.device))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return out.reshape(b, sq, h * v.shape[-1]).to(q.dtype)


class GQA(nn.Module):
    """Grouped-query attention; weights (d, H·D) / (H·D, d) in bf16,
    applied as ``x @ W`` like the reference."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator,
                 device: torch.device):
        super().__init__()
        d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        self.cfg = cfg
        #: the 'model' axis group when the weights hold this rank's heads
        #: (wq / wk / wv column-, wo row-parallel; ``Model.shard_``)
        self.tp = None
        for name, shape in (("wq", (d, h * hd)), ("wk", (d, hkv * hd)),
                            ("wv", (d, hkv * hd)), ("wo", (h * hd, d))):
            setattr(self, name, nn.Parameter(
                dense_init(shape, gen, device)))

    def forward(self, spec: BlockSpec, x: torch.Tensor,
                positions: torch.Tensor,
                cache: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
        """With a cache, k/v are written into it in place at
        ``positions`` (consecutive per row) and attention reads the
        filled region; the same dict is returned."""
        cfg = self.cfg
        b, s, _ = x.shape
        h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        if self.tp is not None:             # this rank's heads
            h, hkv = h // self.tp.size, hkv // self.tp.size
            x = copy_to_group(x, self.tp)
        q = (x @ self.wq).reshape(b, s, h, hd)
        k = (x @ self.wk).reshape(b, s, hkv, hd)
        v = (x @ self.wv).reshape(b, s, hkv, hd)
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
        scale = hd ** -0.5
        if cache is None:
            mask = _attn_mask(positions, positions, spec.local_window)
            y = _sdpa(q, k, v, mask, cfg.attn_softcap, scale)
        else:
            ck, cv = cache["k"], cache["v"]
            s_max = ck.shape[1]
            rows = torch.arange(b, device=x.device)[:, None]
            ck[rows, positions] = k.to(ck.dtype)
            cv[rows, positions] = v.to(cv.dtype)
            k_pos = torch.arange(s_max, device=x.device)[None].expand(b, -1)
            valid = k_pos <= positions[:, -1:]
            mask = _attn_mask(positions, k_pos, spec.local_window, valid)
            y = _sdpa(q, ck, cv, mask, cfg.attn_softcap, scale)
        return row_parallel(y, self.wo, self.tp), cache


def gqa_cache_init(cfg: ArchConfig, batch: int, s_max: int,
                   device: torch.device,
                   dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    shape = (batch, s_max, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
