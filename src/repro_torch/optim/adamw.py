"""AdamW with bf16 params / f32 moments and optional 8-bit moments
(block-wise absmax), port of :mod:`repro.optim.adamw`.

Trees are flat dicts ``{path: tensor}`` (the reference's pytrees
flattened: :meth:`repro_torch.models.model.Model.param_tree`, stacked);
``update`` is a pure function of (grads, state, params) as in the
reference.  ``quantize_moments`` quantizes each leaf as one flat vector
in blocks of ``qblock`` (a stacked leaf's blocks run across its
layers, as the reference's do).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

Tree = Dict[Any, torch.Tensor]


class AdamWState(NamedTuple):
    step: int
    m: Tree
    v: Tree
    m_scale: Optional[Tree] = None     # per-block absmax scales (8-bit)
    v_scale: Optional[Tree] = None


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    quantize_moments: bool = False
    qblock: int = 256

    # -- quantization helpers -------------------------------------------
    def _q(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        flat = x.reshape(-1)
        pad = -flat.shape[0] % self.qblock
        flat = torch.nn.functional.pad(flat, (0, pad)).reshape(
            -1, self.qblock)
        scale = flat.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
        q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
        return q, scale.float()

    @staticmethod
    def _dq(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
        flat = (q.float() * scale).reshape(-1)
        n = 1
        for s in shape:
            n *= s
        return flat[:n].reshape(shape)

    # -- api --------------------------------------------------------------
    def init(self, params: Tree) -> AdamWState:
        zeros = {k: torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for k, p in params.items()}
        if not self.quantize_moments:
            return AdamWState(step=0, m=zeros,
                              v={k: z.clone() for k, z in zeros.items()})
        qm = {k: self._q(z) for k, z in zeros.items()}
        m = {k: t[0] for k, t in qm.items()}
        s = {k: t[1] for k, t in qm.items()}
        return AdamWState(step=0, m=m, v=dict(m), m_scale=s, v_scale=dict(s))

    @torch.no_grad()
    def update(self, grads: Tree, state: AdamWState, params: Tree,
               lr_scale: float = 1.0) -> Tuple[Tree, AdamWState]:
        step = state.step + 1
        b1c = 1 - self.b1 ** float(step)
        b2c = 1 - self.b2 ** float(step)
        if not self.quantize_moments:
            m = {k: self.b1 * state.m[k] + (1 - self.b1) * g.float()
                 for k, g in grads.items()}
            v = {k: self.b2 * state.v[k] + (1 - self.b2)
                 * torch.square(g.float()) for k, g in grads.items()}
            new_state = AdamWState(step=step, m=m, v=v)
        else:
            m = {k: self.b1 * self._dq(state.m[k], state.m_scale[k], g.shape)
                 + (1 - self.b1) * g.float() for k, g in grads.items()}
            # v is stored quantized in the sqrt domain (second moments
            # span many orders of magnitude)
            v = {k: self.b2 * torch.square(self._dq(state.v[k],
                                                    state.v_scale[k],
                                                    g.shape))
                 + (1 - self.b2) * torch.square(g.float())
                 for k, g in grads.items()}
            qm = {k: self._q(x) for k, x in m.items()}
            qv = {k: self._q(torch.sqrt(x)) for k, x in v.items()}
            new_state = AdamWState(
                step=step, m={k: t[0] for k, t in qm.items()},
                v={k: t[0] for k, t in qv.items()},
                m_scale={k: t[1] for k, t in qm.items()},
                v_scale={k: t[1] for k, t in qv.items()})

        def upd(p, mm, vv):
            delta = (mm / b1c) / (torch.sqrt(vv / b2c) + self.eps) \
                + self.weight_decay * p.float()
            return (p.float() - self.lr * lr_scale * delta).to(p.dtype)

        new_params = {k: upd(p, m[k], v[k]) for k, p in params.items()}
        return new_params, new_state
