"""Decoder model: blocks -> final norm -> LM head, and the training
loss (port of :mod:`repro.models.model` for attention + dense-MLP blocks
and the xLSTM blocks, an mLSTM or sLSTM mixer with no MLP).

    model = init_model(cfg, seed=0)                      # on the GPU
    loss = lm_loss(model, {"tokens": t, "labels": l})    # differentiable
    logits, cache = model.prefill(tokens, s_max)         # (B, 1, V)
    logits, cache = model.decode_step(token, pos, cache) # (B, 1, V)

The reference stacks layers into scanned periods; here layer
``p·period + i`` is ``blocks[p·period + i]``.  :func:`from_jax_params`
loads the reference's ``init_params`` tree (as numpy arrays), so the
tests can run both packages on the same weights; :meth:`Model.param_tree`
gives the parameters in the reference's tree, stacked leaves as lists
of per-layer Parameters (what the optimizers update).  The KV cache is a
list with one dict per layer, updated in place: ``{"k", "v"}`` for
attention, the recurrent state (``models.ssm``) for mLSTM / sLSTM, batch
on dim 0 in both.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from ..device import DeviceLike, resolve_device
from .attention import GQA, gqa_cache_init
from .common import (ArchConfig, BlockSpec, apply_norm, dense_init,
                     embed_init, softcap)
from .moe import MLP
from .ssm import MLSTM, SLSTM, mlstm_state_init, slstm_state_init

Cache = List[Dict[str, torch.Tensor]]

MIXERS = {"attn": GQA, "mlstm": MLSTM, "slstm": SLSTM}


def _save_dots(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the outputs of matmuls with no batch dims
    (``aten.mm``: the projections; attention's einsums are batched),
    recompute the rest."""
    if op == torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_context(cfg: ArchConfig):
    """``context_fn`` of each period's checkpoint (reference
    ``_remat_policy``)."""
    if cfg.remat_policy not in ("full", "dots", "names"):
        raise ValueError(f"remat_policy {cfg.remat_policy!r}")
    if cfg.remat_policy == "dots":
        return functools.partial(create_selective_checkpoint_contexts,
                                 _save_dots)
    return noop_context_fn


class Norm(nn.Module):
    """LayerNorm (scale, bias) or RMSNorm (scale, zero-centred), f32."""

    def __init__(self, cfg: ArchConfig, d: int, device: torch.device):
        super().__init__()
        if cfg.norm == "layernorm":
            self.scale = nn.Parameter(torch.ones(d, device=device))
            self.bias = nn.Parameter(torch.zeros(d, device=device))
        else:
            self.scale = nn.Parameter(torch.zeros(d, device=device))


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
            embed_init((cfg.vocab, cfg.d_model), gen, device))
        self.unembed = nn.Parameter(
            dense_init((cfg.d_model, cfg.vocab), gen, device))
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

    def param_tree(self) -> Dict[Tuple[str, ...], List[nn.Parameter]]:
        """The parameters in the reference's ``init_params`` tree, keyed
        by path and in its leaf order (keys sorted, as ``jax.tree``
        flattens a dict): a ``("periods", "b<i>", ...)`` leaf lists the
        Parameter of every period (layer p·period + i), stacked on a
        leading n_periods axis where the reference stacks it; any other
        leaf is one Parameter."""
        tree: Dict[Tuple[str, ...], List[nn.Parameter]] = {
            ("embed",): [self.embed], ("unembed",): [self.unembed]}
        for name, p in self.final_norm.named_parameters():
            tree[("final_norm", name)] = [p]
        for i in range(self.cfg.period):
            for name, _ in self.blocks[i].named_parameters():
                tree[("periods", f"b{i}") + tuple(name.split("."))] = [
                    self.blocks[li].get_parameter(name)
                    for li in range(i, self.cfg.n_layers, self.cfg.period)]
        return dict(sorted(tree.items()))

    def stacked(self, get=lambda p: p.detach()) -> Dict[Tuple[str, ...],
                                                         torch.Tensor]:
        """:meth:`param_tree` with each leaf as one tensor: ``get`` of
        each Parameter (default its data; ``lambda p: p.grad`` for the
        gradients), stacked on the n_periods axis for the periods'
        leaves (a copy), the tensor itself for the others."""
        return {k: torch.stack([get(p) for p in ps]) if k[0] == "periods"
                else get(ps[0]) for k, ps in self.param_tree().items()}

    def _period(self, p: int, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
        period = self.cfg.period
        for blk in self.blocks[p * period:(p + 1) * period]:
            x, _ = blk(x, positions, None)
        return x

    # -- entry points ------------------------------------------------------
    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[Cache] = None, remat: bool = True
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
        """tokens (B, S) int -> final-norm hidden states (B, S, d).

        Without a cache and with autograd on, each period is
        recomputed in the backward pass (``torch.utils.checkpoint``)
        under ``cfg.remat_policy``, as the reference's scan body is:
        "full" keeps only the period's input, "dots" also the outputs
        of its matmuls without batch dims (the projections), "names"
        only the named scan outputs, which the ported blocks do not
        tag (so "full" here)."""
        x = self.embed[tokens]
        b, s, _ = x.shape
        if positions is None:
            positions = torch.arange(s, device=x.device)[None].expand(b, -1)
        if cache is None and remat and torch.is_grad_enabled():
            ctx = _remat_context(self.cfg)
            for p in range(self.cfg.n_layers // self.cfg.period):
                x = checkpoint(self._period, p, x, positions,
                               use_reentrant=False, context_fn=ctx)
        else:
            for i, blk in enumerate(self.blocks):
                x, _ = blk(x, positions,
                           None if cache is None else cache[i])
        return apply_norm(self.cfg, self.final_norm, x), cache

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, s_max: int,
                return_hidden: bool = False):
        """Full-sequence forward building a fresh KV cache; logits of the
        last position only (B, 1, V).  ``return_hidden`` also returns
        the final-norm hidden states (B, S, d)."""
        b = tokens.shape[0]
        cache = self.init_cache(b, s_max)
        x, cache = self.forward(tokens, cache=cache, remat=False)
        logits = self._logits(x[:, -1:])
        if return_hidden:
            return logits, cache, x
        return logits, cache

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, pos: torch.Tensor,
                    cache: Cache) -> Tuple[torch.Tensor, Cache]:
        """One token per sequence: token (B, 1), pos (B, 1)."""
        x, cache = self.forward(token, positions=pos, cache=cache,
                                remat=False)
        return self._logits(x), cache


# ---------------------------------------------------------------------------
# loss (chunked cross-entropy: never the whole (B, S, V) logits)
# ---------------------------------------------------------------------------
def _xent_chunk(cfg: ArchConfig, w: torch.Tensor, x: torch.Tensor,
                labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, Cs, d), labels: (B, Cs) with -1 = ignore -> (sum of the
    token losses, count of valid tokens), f32."""
    logits = softcap(x.float() @ w.float(), cfg.final_softcap)
    lse = torch.logsumexp(logits, dim=-1)
    lab = torch.clamp(labels, min=0).long()
    ll = torch.gather(logits, -1, lab[..., None])[..., 0]
    valid = labels >= 0
    return torch.sum((lse - ll) * valid), torch.sum(valid).float()


def lm_loss(model: Model, batch: Dict[str, torch.Tensor], chunk: int = 512,
            remat: bool = True) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` (-1 ignored), over sequence chunks of ``chunk``
    positions, each recomputed in the backward pass when ``remat``
    (positions past the last whole chunk are dropped, as the
    reference's reshape drops them)."""
    cfg = model.cfg
    x, _ = model(batch["tokens"], positions=batch.get("positions"),
                 remat=remat)
    labels = batch["labels"]
    b, s, _ = x.shape
    nchunks = max(s // chunk, 1)
    cs = s // nchunks
    tot = torch.zeros((), device=x.device)
    cnt = torch.zeros((), device=x.device)
    for i in range(nchunks):
        xs, ls = x[:, i * cs:(i + 1) * cs], labels[:, i * cs:(i + 1) * cs]
        if remat and torch.is_grad_enabled():
            l, n = checkpoint(_xent_chunk, cfg, model.unembed, xs, ls,
                              use_reentrant=False)
        else:
            l, n = _xent_chunk(cfg, model.unembed, xs, ls)
        tot, cnt = tot + l, cnt + n
    return tot / torch.clamp(cnt, min=1.0)


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
