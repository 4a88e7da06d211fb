"""Dense MLP (port of the gated SwiGLU / GeGLU part of
:mod:`repro.models.moe`; the routed experts wait).  Tensor-parallel
(``tp`` set by ``Model.shard_``), wi / wg hold this rank's columns of
d_ff and wo its rows, and the partial sums are all-reduced in f32."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..distributed.collectives import copy_to_group, row_parallel
from .common import ArchConfig, dense_init


def act_fn(name: str):
    if name.startswith("gelu"):
        return lambda x: torch.nn.functional.gelu(x, approximate="tanh")
    return torch.nn.functional.silu


class MLP(nn.Module):
    """Gated MLP ``act(x·Wi) * (x·Wg) · Wo`` (SwiGLU / GeGLU), bf16
    weights applied as ``x @ W``; the ungated ``gelu_mlp`` waits."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator,
                 device: torch.device, d_ff: Optional[int] = None):
        super().__init__()
        if cfg.act == "gelu_mlp":
            raise NotImplementedError("the ungated gelu_mlp waits")
        d, f = cfg.d_model, d_ff or cfg.d_ff
        self.act = act_fn(cfg.act)
        #: the 'model' axis group when wi / wg hold this rank's columns
        #: of f and wo its rows (``Model.shard_``)
        self.tp = None
        for name, shape in (("wi", (d, f)), ("wg", (d, f)), ("wo", (f, d))):
            setattr(self, name, nn.Parameter(
                dense_init(shape, gen, device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            x = copy_to_group(x, self.tp)
        # tensor-parallel: partial sums over this rank's f
        return row_parallel(self.act(x @ self.wi) * (x @ self.wg), self.wo,
                            self.tp)
