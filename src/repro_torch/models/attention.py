"""Attention mixers with RoPE and a KV cache (port of
:mod:`repro.models.attention`): GQA with the dense and the streamed SDPA,
and DeepSeek's multi-head latent attention (:class:`MLA`).

Layouts are the reference's: q (B, Sq, H, D), k/v (B, Sk, Hkv, D), the
cache (B, S_max, Hkv, D) in bf16.  The softmax runs in f32 as plain
tensor ops: dense (``_sdpa``) where Sq·Sk is small or Sq = 1, streamed
over KV blocks (``_sdpa_streamed``) where the dense (B, H, Sq, Sk) f32
logits would be large, as the reference dispatches (``_dispatch_sdpa``).
Tensor-parallel (``tp`` set by ``Model.shard_``), a rank
runs its n_heads / |model| heads and n_kv_heads / |model| KV heads, and
the output projection's partial sums are all-reduced in f32.  Under
``fsdp_params`` each projection is also split over 'data' and gathered
where it is used (``collectives.fsdp_weight``).

MLA caches one latent row a token, ``{"ckv": (B, S_max, kv_lora),
"kr": (B, S_max, rope_head_dim)}`` in bf16, and up-projects the whole
cached latent to per-head K and V on every call, with the reference's
dense f32 softmax (it never streams).  Tensor-parallel, a rank holds
column blocks of the three latents' down-projections and gathers each
latent whole over 'model' before its up-projection to the rank's
n_heads / |model| heads (``collectives.gather_from_group``: an
all-gather forward, a reduce-scatter of its gradient backward); the
output projection is row-parallel as GQA's.  The latent cache is not
split: a sharded model trains, and serving it raises.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..distributed.collectives import (copy_to_group, fsdp_weight,
                                       gather_from_group, row_parallel)
from .common import (ArchConfig, BlockSpec, MLACfg, apply_rope, dense_init,
                     softcap)

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


SDPA_KV_BLOCK = 1024
#: Sq·Sk at and above which a multi-token query streams (the reference's
#: threshold: below it the dense logits are cheaper)
SDPA_STREAM_MIN = 4096 * 32768


def _sdpa_streamed(q, k, v, q_pos, k_pos, window: int,
                   k_valid: Optional[torch.Tensor], cap: float, scale: float,
                   block: int = SDPA_KV_BLOCK) -> torch.Tensor:
    """Streaming-softmax SDPA over KV blocks of ``block`` keys with a
    running (max, sum, accumulator), as the reference's
    scan: only a (B, Hkv, g, Sq, block) tile of logits exists at a time,
    and with autograd on each block is recomputed in the backward pass
    (the reference checkpoints its scan body).  The same softcap and
    masking as :func:`_sdpa`; the softmax differs from it only by the
    order of its sums."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qf = q.reshape(b, sq, hkv, g, d).float() * scale
    neg = torch.tensor(NEG_INF, device=q.device)

    def body(m, l, acc, kb, vb, kpb, kvb):
        lg = softcap(torch.einsum("bqhgd,bkhd->bhgqk", qf, kb.float()), cap)
        msk = q_pos[:, :, None] >= kpb[:, None, :]
        if window > 0:
            msk &= (q_pos[:, :, None] - kpb[:, None, :]) < window
        msk &= kvb[:, None, :]
        lg = torch.where(msk[:, None, None], lg, neg)
        m_new = torch.maximum(m, lg.max(dim=-1).values)
        alpha = torch.exp(m - m_new)
        p = torch.exp(lg - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p,
                                                    vb.float())
        return m_new, l, acc

    m = torch.full((b, hkv, g, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, hkv, g, sq), device=q.device)
    acc = torch.zeros((b, hkv, g, sq, v.shape[-1]), device=q.device)
    if k_valid is None:
        k_valid = torch.ones((b, sk), dtype=torch.bool, device=q.device)
    for j in range(0, sk, block):
        blk = (k[:, j:j + block], v[:, j:j + block], k_pos[:, j:j + block],
               k_valid[:, j:j + block])
        if torch.is_grad_enabled():
            m, l, acc = checkpoint(body, m, l, acc, *blk,
                                   use_reentrant=False)
        else:
            m, l, acc = body(m, l, acc, *blk)
    out = acc / torch.clamp(l, min=1e-30)[..., None]       # (B,hkv,g,Sq,dv)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h * v.shape[-1])
    return out.to(q.dtype)


def _dispatch_sdpa(q, k, v, q_pos, k_pos, window: int,
                   k_valid: Optional[torch.Tensor], cap: float,
                   scale: float) -> torch.Tensor:
    """The streamed SDPA for a multi-token query with Sq·Sk at least
    ``SDPA_STREAM_MIN`` and Sk a multiple of ``SDPA_KV_BLOCK``; the
    dense one else (a decode step, short prompts)."""
    sq, sk = q.shape[1], k.shape[1]
    if sq > 1 and sq * sk >= SDPA_STREAM_MIN and sk % SDPA_KV_BLOCK == 0:
        return _sdpa_streamed(q, k, v, q_pos, k_pos, window, k_valid, cap,
                              scale, block=SDPA_KV_BLOCK)
    mask = _attn_mask(q_pos, k_pos, window, k_valid)
    return _sdpa(q, k, v, mask, cap, scale)


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
        #: the weights split over 'data' (``fsdp_params``), each gathered
        #: where it is used: {name: (comm, dim)} (``Model.shard_``)
        self.fsdp = {}
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
        q = (x @ fsdp_weight(self, "wq")).reshape(b, s, h, hd)
        k = (x @ fsdp_weight(self, "wk")).reshape(b, s, hkv, hd)
        v = (x @ fsdp_weight(self, "wv")).reshape(b, s, hkv, hd)
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
        scale = hd ** -0.5
        if cache is None:
            y = _dispatch_sdpa(q, k, v, positions, positions,
                               spec.local_window, None, cfg.attn_softcap,
                               scale)
        else:
            ck, cv = cache["k"], cache["v"]
            s_max = ck.shape[1]
            rows = torch.arange(b, device=x.device)[:, None]
            ck[rows, positions] = k.to(ck.dtype)
            cv[rows, positions] = v.to(cv.dtype)
            k_pos = torch.arange(s_max, device=x.device)[None].expand(b, -1)
            valid = k_pos <= positions[:, -1:]
            y = _dispatch_sdpa(q, ck, cv, positions, k_pos,
                               spec.local_window, valid, cfg.attn_softcap,
                               scale)
        return row_parallel(y, fsdp_weight(self, "wo"), self.tp), cache


def gqa_cache_init(cfg: ArchConfig, batch: int, s_max: int,
                   device: torch.device,
                   dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    shape = (batch, s_max, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


class MLA(nn.Module):
    """Multi-head latent attention (DeepSeek-V2 / V3): queries through a
    low-rank ``w_dq`` · ``w_uq`` (``q_lora`` set) or one ``wq``; keys and
    values from a ``kv_lora``-wide latent ``x @ w_dkv``, up-projected per
    head by ``w_uk`` / ``w_uv``; RoPE only on the ``rope_head_dim``
    query dims and on one key ``x @ w_kr`` that every head shares.
    Weights bf16, applied as ``x @ W`` like the reference.

    Tensor-parallel (``tp`` set by ``Model.shard_``, P ranks, T tokens)
    every weight is column-split but ``wo``, as the reference's specs
    split them: ``w_dq``, ``w_dkv`` and ``w_kr`` give this rank a column
    block of the q latent, of ``ckv`` and of the rope key, each made
    whole by an all-gather over 'model' ((P − 1)·T·q_lora/P,
    (P − 1)·T·kv_lora/P and (P − 1)·T·rd/P words; the rope key before
    its rotation, whose pairs and frequencies run along the whole
    width), whose gradient comes back as a reduce-scatter in f32
    (T·q_lora, T·kv_lora and T·rd words times (P − 1)/P); ``w_uq`` (or
    ``wq``), ``w_uk`` and ``w_uv`` hold this rank's n_heads / P heads,
    and the softmax runs over those; ``wo``'s row block leaves through
    one f32 (T, d) all-reduce (``row_parallel``).  x enters through
    ``copy_to_group``: its gradient, summed over the three
    down-projections, is one f32 (T, d) all-reduce.  Under
    ``fsdp_params`` each weight is also split over 'data' and gathered
    where it is used (``fsdp_weight``)."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator,
                 device: torch.device):
        super().__init__()
        m: MLACfg = cfg.mla
        if m is None:
            raise ValueError(f"{cfg.name}: attn_kind='mla' needs cfg.mla")
        d, h, qk = cfg.d_model, cfg.n_heads, m.qk_nope_dim
        self.cfg = cfg
        #: the 'model' axis group when the weights hold this rank's
        #: latent columns and heads (``Model.shard_``)
        self.tp = None
        #: the weights split over 'data' (``fsdp_params``), each gathered
        #: where it is used: {name: (comm, dim)} (``Model.shard_``)
        self.fsdp = {}
        shapes = [("w_dkv", (d, m.kv_lora)), ("w_kr", (d, m.rope_head_dim)),
                  ("w_uk", (m.kv_lora, h * qk)),
                  ("w_uv", (m.kv_lora, h * m.v_head_dim)),
                  ("wo", (h * m.v_head_dim, d))]
        if m.q_lora:
            shapes += [("w_dq", (d, m.q_lora)),
                       ("w_uq", (m.q_lora, h * (qk + m.rope_head_dim)))]
        else:
            shapes += [("wq", (d, h * (qk + m.rope_head_dim)))]
        for name, shape in shapes:
            setattr(self, name, nn.Parameter(
                dense_init(shape, gen, device)))

    def _latent(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """``x @ name``, gathered whole over 'model' when split there."""
        y = x @ fsdp_weight(self, name)
        return y if self.tp is None else gather_from_group(y, self.tp, -1)

    def forward(self, spec: BlockSpec, x: torch.Tensor,
                positions: torch.Tensor,
                cache: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
        """With a cache, the latent and the rope key are written into it
        in place at ``positions`` and attention reads every cached row
        up to ``positions[:, -1]``; the same dict is returned."""
        cfg, m = self.cfg, self.cfg.mla
        b, s, _ = x.shape
        h, qk, rd, vd = (cfg.n_heads, m.qk_nope_dim, m.rope_head_dim,
                         m.v_head_dim)
        if self.tp is not None:             # this rank's heads
            h //= self.tp.size
            x = copy_to_group(x, self.tp)
        if m.q_lora:
            q = self._latent(x, "w_dq") @ fsdp_weight(self, "w_uq")
        else:
            q = x @ fsdp_weight(self, "wq")
        q = q.reshape(b, s, h, qk + rd)
        q_nope = q[..., :qk]
        q_rope = apply_rope(q[..., qk:], positions, cfg.rope_theta)
        ckv = self._latent(x, "w_dkv")                     # (B, S, kv_lora)
        kr = apply_rope(self._latent(x, "w_kr")[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]           # (B, S, rd)
        if cache is not None:
            rows = torch.arange(b, device=x.device)[:, None]
            cache["ckv"][rows, positions] = ckv.to(cache["ckv"].dtype)
            cache["kr"][rows, positions] = kr.to(cache["kr"].dtype)
            ckv, kr = cache["ckv"], cache["kr"]
            k_pos = torch.arange(ckv.shape[1], device=x.device)[None] \
                .expand(b, -1)
            mask = _attn_mask(positions, k_pos, spec.local_window,
                              k_pos <= positions[:, -1:])
        else:
            mask = _attn_mask(positions, positions, spec.local_window)
        sk = ckv.shape[1]
        # the whole latent up-projected to per-head K / V
        k_nope = (ckv @ fsdp_weight(self, "w_uk")).reshape(b, sk, h, qk)
        v = (ckv @ fsdp_weight(self, "w_uv")).reshape(b, sk, h, vd)
        logits = (torch.einsum("bqhd,bkhd->bhqk", q_nope.float(),
                               k_nope.float())
                  + torch.einsum("bqhd,bkd->bhqk", q_rope.float(),
                                 kr.float())) * (qk + rd) ** -0.5
        logits = torch.where(mask[:, None], logits,
                             torch.tensor(NEG_INF, device=x.device))
        w = torch.softmax(logits, dim=-1)
        y = torch.einsum("bhqk,bkhd->bqhd", w, v.float())
        return row_parallel(y.reshape(b, s, h * vd).to(x.dtype),
                            fsdp_weight(self, "wo"), self.tp), cache


def mla_cache_init(cfg: ArchConfig, batch: int, s_max: int,
                   device: torch.device,
                   dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    m = cfg.mla
    return {"ckv": torch.zeros((batch, s_max, m.kv_lora), dtype=dtype,
                               device=device),
            "kr": torch.zeros((batch, s_max, m.rope_head_dim), dtype=dtype,
                              device=device)}
