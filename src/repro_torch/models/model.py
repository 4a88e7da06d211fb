"""Decoder model: blocks -> final norm -> LM head (port of
:mod:`repro.models.model` for attention + dense-MLP blocks and the
xLSTM blocks, an mLSTM or sLSTM mixer with no MLP).

    model = init_model(cfg, seed=0)                      # on the GPU
    logits, cache = model.prefill(tokens, s_max)         # (B, 1, V)
    logits, cache = model.decode_step(token, pos, cache) # (B, 1, V)

The reference stacks layers into scanned periods; here layer
``p·period + i`` is ``blocks[p·period + i]``.  :func:`from_jax_params`
loads the reference's ``init_params`` tree (as numpy arrays), so the
tests can run both packages on the same weights.  The KV cache is a
list with one dict per layer, updated in place: ``{"k", "v"}`` for
attention, the recurrent state (``models.ssm``) for mLSTM / sLSTM, batch
on dim 0 in both.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from .attention import GQA, gqa_cache_init
from .common import (ArchConfig, BlockSpec, apply_norm, dense_init,
                     embed_init, softcap)
from .moe import MLP
from .ssm import MLSTM, SLSTM, mlstm_state_init, slstm_state_init

Cache = List[Dict[str, torch.Tensor]]

MIXERS = {"attn": GQA, "mlstm": MLSTM, "slstm": SLSTM}


class Norm(nn.Module):
    """LayerNorm (scale, bias) or RMSNorm (scale, zero-centred), f32."""

    def __init__(self, cfg: ArchConfig, d: int, device: torch.device):
        super().__init__()
        if cfg.norm == "layernorm":
            self.scale = nn.Parameter(torch.ones(d, device=device),
                                      requires_grad=False)
            self.bias = nn.Parameter(torch.zeros(d, device=device),
                                     requires_grad=False)
        else:
            self.scale = nn.Parameter(torch.zeros(d, device=device),
                                      requires_grad=False)


class Block(nn.Module):
    def __init__(self, cfg: ArchConfig, spec: BlockSpec,
                 gen: torch.Generator, device: torch.device):
        super().__init__()
        if spec.mixer not in MIXERS or spec.mlp not in ("dense", "none"):
            raise NotImplementedError(
                f"block {spec} is not ported yet (mixers {sorted(MIXERS)},"
                f" mlp dense | none)")
        if spec.mixer == "attn" and cfg.attn_kind != "gqa":
            raise NotImplementedError(f"attn_kind={cfg.attn_kind!r} waits")
        self.cfg, self.spec = cfg, spec
        self.norm1 = Norm(cfg, cfg.d_model, device)
        self.mixer = MIXERS[spec.mixer](cfg, gen, device)
        if spec.mlp == "dense":
            self.norm2 = Norm(cfg, cfg.d_model, device)
            self.mlp = MLP(cfg, gen, device)

    def forward(self, x, positions, cache):
        cfg = self.cfg
        h = apply_norm(cfg, self.norm1, x)
        y, cache = self.mixer(self.spec, h, positions, cache)
        x = x + y
        if self.spec.mlp == "none":
            return x, cache
        h = apply_norm(cfg, self.norm2, x)
        return x + self.mlp(h), cache

    def init_cache(self, batch: int, s_max: int,
                   device: torch.device) -> Dict[str, torch.Tensor]:
        """This layer's cache: KV for attention, recurrent state else."""
        if self.spec.mixer == "mlstm":
            return mlstm_state_init(self.cfg, batch, device)
        if self.spec.mixer == "slstm":
            return slstm_state_init(self.cfg, batch, device)
        return gqa_cache_init(self.cfg, batch, s_max, device)


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig, gen: torch.Generator,
                 device: torch.device):
        super().__init__()
        if cfg.frontend != "tokens" or cfg.prefix or cfg.post_block_norm \
                or cfg.tie_embeddings or cfg.embed_scale:
            raise NotImplementedError(
                "only token frontends without prefix blocks, post-block "
                "norms, tied or scaled embeddings are ported")
        self.cfg = cfg
        self.device = device
        self.embed = nn.Parameter(
            embed_init((cfg.vocab, cfg.d_model), gen, device),
            requires_grad=False)
        self.unembed = nn.Parameter(
            dense_init((cfg.d_model, cfg.vocab), gen, device),
            requires_grad=False)
        self.final_norm = Norm(cfg, cfg.d_model, device)
        specs = [cfg.pattern[i % cfg.period] for i in range(cfg.n_layers)]
        self.blocks = nn.ModuleList(Block(cfg, s, gen, device)
                                    for s in specs)

    # -- helpers -----------------------------------------------------------
    def init_cache(self, batch: int, s_max: int) -> Cache:
        return [blk.init_cache(batch, s_max, self.device)
                for blk in self.blocks]

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return softcap(x.float() @ self.unembed.float(),
                       self.cfg.final_softcap)

    # -- entry points ------------------------------------------------------
    @torch.no_grad()
    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[Cache] = None
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
        """tokens (B, S) int -> final-norm hidden states (B, S, d)."""
        x = self.embed[tokens]
        b, s, _ = x.shape
        if positions is None:
            positions = torch.arange(s, device=x.device)[None].expand(b, -1)
        for i, blk in enumerate(self.blocks):
            x, _ = blk(x, positions, None if cache is None else cache[i])
        return apply_norm(self.cfg, self.final_norm, x), cache

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, s_max: int,
                return_hidden: bool = False):
        """Full-sequence forward building a fresh KV cache; logits of the
        last position only (B, 1, V).  ``return_hidden`` also returns
        the final-norm hidden states (B, S, d)."""
        b = tokens.shape[0]
        cache = self.init_cache(b, s_max)
        x, cache = self.forward(tokens, cache=cache)
        logits = self._logits(x[:, -1:])
        if return_hidden:
            return logits, cache, x
        return logits, cache

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, pos: torch.Tensor,
                    cache: Cache) -> Tuple[torch.Tensor, Cache]:
        """One token per sequence: token (B, 1), pos (B, 1)."""
        x, cache = self.forward(token, positions=pos, cache=cache)
        return self._logits(x), cache


def init_model(cfg: ArchConfig, seed: int = 0,
               device: DeviceLike = None) -> Model:
    """Random weights from ``seed`` (truncated normal, bf16) on
    ``device`` — the GPU unless the caller asks for the CPU."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return Model(cfg, gen, dev)


def from_jax_params(np_tree: Dict[str, Any], cfg: ArchConfig,
                    device: DeviceLike = None) -> Model:
    """Build a :class:`Model` holding the weights of
    ``repro.models.model.init_params`` (as numpy arrays, with the
    stacked ``periods`` leaves' leading n_periods axis)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    model = Model(cfg, gen, dev)

    def put(param: nn.Parameter, arr) -> None:
        src = torch.from_numpy(np.array(arr, dtype=np.float32))
        if tuple(src.shape) != tuple(param.shape):
            raise ValueError(f"shape {tuple(src.shape)} != "
                             f"{tuple(param.shape)}")
        param.data.copy_(src.to(param.dtype))

    def put_norm(norm: Norm, tree) -> None:
        for k, v in tree.items():
            put(getattr(norm, k), v)

    put(model.embed, np_tree["embed"])
    put(model.unembed, np_tree["unembed"])
    put_norm(model.final_norm, np_tree["final_norm"])
    for li, blk in enumerate(model.blocks):
        p, i = divmod(li, cfg.period)
        src = np_tree["periods"][f"b{i}"]
        take = lambda a: np.asarray(a)[p]       # noqa: E731
        for name in ("norm1", "norm2"):
            if name in src:
                put_norm(getattr(blk, name),
                         {k: take(v) for k, v in src[name].items()})
        for part in ("mixer", "mlp"):
            for name, v in src.get(part, {}).items():
                put(getattr(getattr(blk, part), name), take(v))
    return model
