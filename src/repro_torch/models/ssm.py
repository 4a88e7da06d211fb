"""Recurrent mixers of xLSTM: mLSTM (matrix memory) and sLSTM (scalar
memory).  Port of the xLSTM half of :mod:`repro.models.ssm`; Mamba
waits.

Both share the attention mixer's calling convention and run eagerly.
Projections are bf16 (``x @ W``) and become f32 before the recurrence,
as in the reference (sLSTM: inside ``slstm_scan``, which takes the bf16
gates).  State layouts (per layer, batch on dim 0, f32):

  mlstm : C (B, H, hd, hd), n (B, H, hd), m (B, H)
  slstm : c, n, m (B, d)

sLSTM: every call, prefill and decode alike, goes through
``kernels.slstm.slstm_scan`` — the hand-written kernel on a CUDA tensor,
its plain version (``_slstm_seq``'s loop) on a CPU tensor.  The
reference switches to an associative-scan form (``_slstm_parallel``)
for s > 8; that form is not ported, because on the card the kernel
takes its place and both compute the same stabilised recurrence.

mLSTM has no TPU kernel: the per-step recurrence (``_mlstm_seq``) and
the chunkwise-parallel form (``_mlstm_chunkwise``) are plain PyTorch,
chosen by the reference's rule (chunkwise iff s % 128 == 0 and
s > 128).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..kernels.slstm import _slstm_scan_plain, slstm_scan
from .common import ArchConfig, BlockSpec, dense_init

State = Dict[str, torch.Tensor]


def _register(module: nn.Module, params: Dict[str, torch.Tensor]) -> None:
    for name, w in params.items():
        setattr(module, name, nn.Parameter(w))


# ===========================================================================
# mLSTM (xLSTM matrix memory)
# ===========================================================================
def mlstm_params(cfg: ArchConfig, gen: torch.Generator,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    d, h = cfg.d_model, cfg.n_heads
    return {name: dense_init(shape, gen, device) for name, shape in (
        ("wq", (d, d)), ("wk", (d, d)), ("wv", (d, d)),
        ("wif", (d, 2 * h)),                 # input + forget gate logits
        ("wo_gate", (d, d)), ("wo", (d, d)))}


def mlstm_state_init(cfg: ArchConfig, batch: int,
                     device: torch.device) -> State:
    h = cfg.n_heads
    hd = cfg.d_model // h
    f32 = torch.float32
    return {"C": torch.zeros((batch, h, hd, hd), dtype=f32, device=device),
            "n": torch.zeros((batch, h, hd), dtype=f32, device=device),
            "m": torch.full((batch, h), -1e30, dtype=f32, device=device)}


MLSTM_CHUNK = 128


def _mlstm_seq(q, k, v, ig, fg, st: State) -> Tuple[torch.Tensor, State]:
    """Per-step stabilised recurrence (decode, and prefill at buckets
    the chunkwise form does not take).  q/k/v (B,S,H,hd), ig/fg (B,S,H)
    log-space gates, all f32."""
    C, n, m = st["C"], st["n"], st["m"]
    ys = []
    for t in range(q.shape[1]):
        qt, kt, vt, it, ft = q[:, t], k[:, t], v[:, t], ig[:, t], fg[:, t]
        m_new = torch.maximum(ft + m, it)                   # stabilizer
        i_ = torch.exp(it - m_new)
        f_ = torch.exp(ft + m - m_new)
        C = f_[..., None, None] * C + i_[..., None, None] \
            * (vt[..., :, None] * kt[..., None, :])
        n = f_[..., None] * n + i_[..., None] * kt
        num = (C @ qt[..., None])[..., 0]
        den = torch.clamp((n * qt).sum(-1).abs(), min=1.0)
        ys.append(num / den[..., None])
        m = m_new
    return torch.stack(ys, dim=1), {"C": C, "n": n, "m": m}


def _mlstm_chunkwise(q, k, v, ig, fg, st: State,
                     chunk: int = MLSTM_CHUNK) -> Tuple[torch.Tensor, State]:
    """Chunkwise-parallel mLSTM: the same stabilised recurrence (the
    same m_t) unrolled over chunks of L tokens,

        m_j = b_j + w_j,  b_j = Σ_{l≤j} f_l,
        w_j = max(m₀, cummax_{l≤j}(i_l − b_l)),

    an (L, L)-masked matmul chain per chunk plus one state update per
    chunk.  ``max(m₀, ·)`` keeps m₀ = −1e30 finite, so e^{m₀−w}
    underflows to 0.  The causal mask selects (``where``) instead of
    multiplying, so an overflowing e^{a_l−w_j} above the diagonal
    cannot turn into inf·0."""
    b, s, h, hd = q.shape
    C0, n0, m0 = st["C"], st["n"], st["m"]
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=q.device).tril()[None, :, :, None]
    ys = []
    for j0 in range(0, s, chunk):
        sl = slice(j0, j0 + chunk)
        qt, kt, vt, it, ft = q[:, sl], k[:, sl], v[:, sl], ig[:, sl], \
            fg[:, sl]
        bcum = torch.cumsum(ft, dim=1)                        # (B,L,H)
        a_l = it - bcum                                       # i_l − b_l
        w = torch.maximum(m0[:, None], torch.cummax(a_l, dim=1).values)
        m_j = bcum + w
        D = torch.where(tri, torch.exp(a_l[:, None] - w[:, :, None]),
                        torch.zeros((), device=q.device))     # (B,j,l,H)
        S = torch.einsum("bjhd,blhd->bjlh", qt, kt) * D
        carry_scale = torch.exp(m0[:, None] - w)              # (B,L,H)
        num = torch.einsum("bjlh,blhd->bjhd", S, vt) \
            + carry_scale[..., None] \
            * torch.einsum("bjhe,bhde->bjhd", qt, C0)
        nq_j = S.sum(dim=2) \
            + carry_scale * torch.einsum("bjhe,bhe->bjh", qt, n0)
        ys.append(num / torch.clamp(nq_j.abs(), min=1.0)[..., None])
        scale_l = torch.exp(a_l - w[:, -1:])                  # (B,L,H)
        end_scale = torch.exp(m0 - w[:, -1])                  # (B,H)
        C0 = end_scale[..., None, None] * C0 + torch.einsum(
            "blhd,blhe->bhde", vt * scale_l[..., None], kt)
        n0 = end_scale[..., None] * n0 + (kt * scale_l[..., None]).sum(1)
        m0 = m_j[:, -1]
    return torch.cat(ys, dim=1), {"C": C0, "n": n0, "m": m0}


def mlstm_mixer(cfg: ArchConfig, p, x: torch.Tensor,
                state: Optional[State] = None
                ) -> Tuple[torch.Tensor, Optional[State]]:
    """Exponential-gated matrix-memory LSTM (xLSTM eq. 19–27),
    stabilised.  ``p`` holds wq, wk, wv, wif, wo_gate, wo (bf16)."""
    b, s, d = x.shape
    h = cfg.n_heads
    hd = d // h
    q = (x @ p.wq).reshape(b, s, h, hd).float() * hd ** -0.5
    k = (x @ p.wk).reshape(b, s, h, hd).float() * hd ** -0.5
    v = (x @ p.wv).reshape(b, s, h, hd).float()
    gif = (x @ p.wif).reshape(b, s, h, 2).float()
    ig, fg = gif[..., 0], gif[..., 1]                    # log-space gates
    st = state if state is not None else mlstm_state_init(cfg, b, x.device)
    if s % MLSTM_CHUNK == 0 and s > MLSTM_CHUNK:
        ys, new_st = _mlstm_chunkwise(q, k, v, ig, fg, st)
    else:
        ys, new_st = _mlstm_seq(q, k, v, ig, fg, st)
    y = ys.reshape(b, s, d).to(x.dtype)
    og = torch.sigmoid(x @ p.wo_gate)
    out = (y * og) @ p.wo
    return out, (None if state is None else new_st)


# ===========================================================================
# sLSTM (xLSTM scalar memory)
# ===========================================================================
def slstm_params(cfg: ArchConfig, gen: torch.Generator,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    return {"wx": dense_init((d, 4 * d), gen, device),  # z, i, f, o
            "wo": dense_init((d, d), gen, device)}


def slstm_state_init(cfg: ArchConfig, batch: int,
                     device: torch.device) -> State:
    shape, f32 = (batch, cfg.d_model), torch.float32
    return {"c": torch.zeros(shape, dtype=f32, device=device),
            "n": torch.ones(shape, dtype=f32, device=device),
            "m": torch.zeros(shape, dtype=f32, device=device)}


def _slstm_seq(z, ig, fg, og, st: State) -> Tuple[torch.Tensor, State]:
    """Per-step recurrence with the reference's dict state: the
    kernel's plain version."""
    y, c, n, m = _slstm_scan_plain(z, ig, fg, og, st["c"], st["n"],
                                   st["m"])
    return y, {"c": c, "n": n, "m": m}


def slstm_mixer(cfg: ArchConfig, p, x: torch.Tensor,
                state: Optional[State] = None
                ) -> Tuple[torch.Tensor, Optional[State]]:
    """``p`` holds wx (d, 4d) and wo (d, d), bf16."""
    b, s, d = x.shape
    # d-major gate layout, as the reference: (B,S,4d) -> (B,S,d,4), gate
    # g is channel stride 4 at offset g; the four strided bf16 views go
    # into the kernel as they are (it reads one quad a step and upcasts in
    # registers; on the CPU the wrapper upcasts the quads to f32)
    pre = (x @ p.wx).reshape(b, s, d, 4)
    z, ig, fg, og = pre.unbind(-1)
    st = state if state is not None else slstm_state_init(cfg, b, x.device)
    ys, c, n, m = slstm_scan(z, ig, fg, og, st["c"], st["n"], st["m"])
    out = ys.to(x.dtype) @ p.wo
    return out, (None if state is None else {"c": c, "n": n, "m": m})


# ===========================================================================
# modules
# ===========================================================================
class _Recurrent(nn.Module):
    """A recurrent mixer as a module with the attention mixer's
    signature: ``forward(spec, x, positions, cache)``.  With a cache, the
    new state replaces the dict's entries in place and the same dict is
    returned (positions are not read).  Subclasses name their
    ``mixer`` and ``params`` functions."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator,
                 device: torch.device):
        super().__init__()
        self.cfg = cfg
        _register(self, self.params(cfg, gen, device))

    def forward(self, spec: BlockSpec, x: torch.Tensor,
                positions: torch.Tensor, cache: Optional[State] = None
                ) -> Tuple[torch.Tensor, Optional[State]]:
        y, new = self.mixer(self.cfg, self, x, cache)
        if cache is not None:
            cache.update(new)
        return y, cache


class MLSTM(_Recurrent):
    mixer = staticmethod(mlstm_mixer)
    params = staticmethod(mlstm_params)


class SLSTM(_Recurrent):
    mixer = staticmethod(slstm_mixer)
    params = staticmethod(slstm_params)
