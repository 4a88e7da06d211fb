"""Decoder model: frontend -> blocks -> final norm -> LM head, and the
training loss (port of :mod:`repro.models.model` for attention +
dense-MLP blocks (stablelm; gemma2 / gemma3 with post-block norms and
scaled embeddings; granite; pixtral; musicgen), the xLSTM blocks, an
mLSTM or sLSTM mixer with no MLP (xlstm), Mamba or attention mixers
beside a dense or routed MoE MLP (jamba), and multi-head latent
attention with unscanned prefix blocks and the multi-token-prediction
block (deepseek)).

    model = init_model(cfg, seed=0)                      # on the GPU
    loss = lm_loss(model, {"tokens": t, "labels": l})    # differentiable
    logits, cache = model.prefill(tokens, s_max)         # (B, 1, V)
    logits, cache = model.decode_step(token, pos, cache) # (B, 1, V)

The frontend is the reference's: token rows of ``embed`` ("tokens");
precomputed frames instead of tokens ("embeddings", musicgen: no
``embed``; ``prefill(None, s_max, embeds=(B, S, d))``,
``decode_step(None, pos, cache, embeds=(B, 1, d))``); or token rows
with precomputed patch embeddings put before them ("vlm", pixtral:
``prefill(tokens, s_max, patch_embeds=(B, P, d))`` with P the config's
``n_frontend_tokens``, positions counting the patches; without
``patch_embeds`` text alone).  With
``embed_scale`` the rows are multiplied by sqrt(d_model) rounded to
their dtype first, as the reference does; with ``tie_embeddings`` the
head is ``embed.T`` and there is no ``unembed``.

The reference runs ``cfg.prefix``'s blocks unscanned, then stacks the
other layers into scanned periods; here ``blocks`` holds the prefix's
blocks first, then layer ``p·period + i`` of the periods as
``blocks[len(prefix) + p·period + i]``.  With ``cfg.mtp`` the model also
holds ``mtp``, one dense attention block, and ``mtp_norm``: the loss's
t+2 term reads them (weight 0.3); serving never runs them.
:func:`from_jax_params`
loads the reference's ``init_params`` tree (as numpy arrays), so the
tests can run both packages on the same weights; :meth:`Model.param_tree`
gives the parameters in the reference's tree, stacked leaves as lists
of per-layer Parameters (what the optimizers update).  The KV cache is a
list with one dict per layer, the prefix's first, updated in place:
``{"k", "v"}`` for GQA, the latent ``{"ckv", "kr"}`` for MLA, the
recurrent state (``models.ssm``) for Mamba / mLSTM /
sLSTM, batch on dim 0 in both.

On a (data, model) mesh (``init_model(..., mesh=)``, ``Model.shard_``)
each rank holds its block of every parameter under
:func:`~.sharding.param_specs`: attention, the Mamba / mLSTM / sLSTM
mixers and the MLP (gated or not) Megatron-split over 'model'
(``collectives.copy_to_group`` / ``row_parallel`` around them), the
routed MoE tensor-parallel over every expert's f (one all-reduce a
layer), the embedding on its vocab rows (a masked gather and an
all-reduce) and the head (``unembed``, or the tied ``embed.T``) on its
vocab columns, so that :func:`lm_loss` is vocab-parallel.  A config
with ``fsdp_params`` (gemma2, gemma3, granite, pixtral, jamba) also
splits those weights over 'data', ZeRO-3's way: each rank keeps its
block under both axes and gathers a weight over 'data' where it uses it
(again in the per-period recompute), its gradient reduce-scattered back
(``collectives.gather_from_group``).  That path trains; serving a
sharded model raises.  MLA (deepseek) is tensor-parallel too: its three
latents gathered whole over 'model', its up-projections and ``wo`` on
the rank's heads (``attention.MLA``); the prefix blocks and the MTP
block are split as a period's blocks are, and run outside the
per-period recompute.  A config with as many layers as prefix blocks
has no periods (deepseek-v3 cut to its dense prefix on the card): no
``("periods", ...)`` leaves (the reference's are ``(0, ...)`` and hold
nothing) and no per-period recompute.
"""
from __future__ import annotations

import functools
import importlib
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from ..device import DeviceLike, resolve_device
from ..distributed.collectives import (all_reduce, copy_to_group,
                                       fsdp_weight, reduce_from_group)
from .attention import GQA, MLA, gqa_cache_init, mla_cache_init
from .common import (SCAN_OUT, ArchConfig, BlockSpec, apply_norm,
                     dense_init, embed_init, softcap)
from .moe import MLP, MoE
from .sharding import param_specs, shard_leaf, split_axes
from .ssm import (MLSTM, SLSTM, Mamba, mamba_state_init, mlstm_state_init,
                  slstm_state_init)

Cache = List[Dict[str, torch.Tensor]]

FRONTENDS = ("tokens", "embeddings", "vlm")
MIXERS = {"attn": GQA, "mamba": Mamba, "mlstm": MLSTM, "slstm": SLSTM}
ATTN_KINDS = {"gqa": GQA, "mla": MLA}
#: the block the MTP head runs (the reference's ``init_params``)
MTP_SPEC = BlockSpec(mixer="attn", mlp="dense")
MLPS = {"dense": MLP, "moe": MoE}
#: each mixer's weights that tensor parallelism splits together: the
#: column-parallel projections and the row-parallel ``wo`` ("mla": MLA
#: with ``q_lora``; without it ``wq`` takes the place of the first two)
TP_WEIGHTS = {"attn": ("wq", "wk", "wv", "wo"),
              "mla": ("w_dq", "w_uq", "w_dkv", "w_kr", "w_uk", "w_uv",
                      "wo"),
              "mamba": ("in_proj", "conv_w", "x_proj", "dt_proj", "a_log",
                        "out_proj"),
              "mlstm": ("wq", "wk", "wv", "wif", "wo_gate", "wo"),
              "slstm": ("wx", "wo")}
#: the heads each headed mixer's split weights hold, by config field
HEADS = {"attn": {"wq": "n_heads", "wk": "n_kv_heads", "wv": "n_kv_heads",
                  "wo": "n_heads"},
         "mla": {w: "n_heads" for w in ("w_uq", "wq", "w_uk", "w_uv",
                                        "wo")},
         "mlstm": {w: "n_heads" for w in TP_WEIGHTS["mlstm"]}}


def _mixer_kind(cfg: ArchConfig, spec: BlockSpec) -> str:
    """``spec``'s mixer as :data:`TP_WEIGHTS` and :data:`HEADS` key it:
    attention under ``attn_kind="mla"`` is "mla"."""
    if spec.mixer == "attn" and cfg.attn_kind == "mla":
        return "mla"
    return spec.mixer


def _tp_weights(cfg: ArchConfig, spec: BlockSpec) -> Tuple[str, ...]:
    """The mixer weights of a ``spec`` block that split together."""
    kind = _mixer_kind(cfg, spec)
    if kind == "mla" and not cfg.mla.q_lora:
        return ("wq",) + TP_WEIGHTS["mla"][2:]
    return TP_WEIGHTS[kind]


def _block_spec(cfg: ArchConfig, path: Tuple[str, ...]) -> BlockSpec:
    """The spec of the block a ``("periods" | "prefix", "b<i>", ...)`` or
    ``("mtp", ...)`` parameter path belongs to."""
    if path[0] == "mtp":
        return MTP_SPEC
    return (cfg.pattern if path[0] == "periods" else cfg.prefix)[
        int(path[1][1:])]


def _tp_sets(cfg: ArchConfig, specs) -> Dict[Tuple[str, ...],
                                              List[Tuple[str, ...]]]:
    """The weights that tensor parallelism splits together, by the path
    of their module: each prefix block's, each period's i-th block's and
    the MTP block's mixer and MLP (the MoE's experts and shared experts
    together: one all-reduce sums both)."""
    blocks = [(("prefix", f"b{i}"), s) for i, s in enumerate(cfg.prefix)]
    if cfg.n_periods:
        blocks += [(("periods", f"b{i}"), s)
                   for i, s in enumerate(cfg.pattern)]
    if cfg.mtp:
        blocks.append((("mtp",), MTP_SPEC))
    sets = {}
    for base, spec in blocks:
        sets[base + ("mixer",)] = [base + ("mixer", w)
                                   for w in _tp_weights(cfg, spec)]
        mlp = base + ("mlp",)
        if spec.mlp == "dense":
            sets[mlp] = [mlp + (w,) for w in ("wi", "wg", "wo")
                         if mlp + (w,) in specs]
        elif spec.mlp == "moe":
            sets[mlp] = [k for k in specs if k[:len(mlp)] == mlp
                         and k[-1] in ("wi", "wg", "wo")]
    return sets


def check_head_split(cfg: ArchConfig, specs, model: int
                     ) -> Dict[Tuple[str, ...], bool]:
    """Whether ``specs`` (:func:`~.sharding.param_specs` on a 'model'
    axis of ``model`` ranks) split each mixer and MLP over 'model'
    (:func:`_tp_sets`' keys).  Raise ``ValueError`` where they split a
    headed mixer's weight (attention, MLA, mLSTM; in a period, a prefix
    block or the MTP block) over a head count that ``model`` does not
    divide: a shard would cut a head, and the port's explicit tensor
    parallelism runs whole heads on a rank (the reference's GSPMD would
    split one); and where they split a module's weights only in part (an
    MLA latent whose width ``model`` does not divide, say), naming the
    leaves.  The sLSTM's channels need no head check: a rank takes whole
    channel quads wherever ``wx`` splits."""
    for path, spec in specs.items():
        if path[0] not in ("periods", "prefix", "mtp") \
                or path[-2] != "mixer" or "model" not in spec:
            continue
        mixer = _mixer_kind(cfg, _block_spec(cfg, path))
        field = HEADS.get(mixer, {}).get(path[-1])
        if field and getattr(cfg, field) % model:
            raise ValueError(
                f"{'/'.join(path)}: {field}={getattr(cfg, field)} does not "
                f"split over model={model}; a shard of {spec} would cut a "
                f"head (the port runs whole heads on a rank): plan a "
                f"model axis that divides {field} with --max-model")
    split = {}
    for where, paths in _tp_sets(cfg, specs).items():
        on = ["model" in specs[p] for p in paths]
        if any(on) and not all(on):
            bad = [("/".join(p), specs[p]) for p in paths]
            raise ValueError(f"{'/'.join(where)} split only in part over "
                             f"model={model}: {bad}")
        split[where] = model > 1 and all(on)
    return split


def _save_dots(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the outputs of matmuls with no batch dims
    (``aten.mm``: the projections; attention's einsums are batched) and
    the named scan outputs, recompute the rest (the reference's
    ``save_from_both_policies``)."""
    if op in (torch.ops.aten.mm.default, SCAN_OUT):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _save_names(ctx, op, *args, **kwargs):
    """The "names" policy: keep only the named scan outputs (the
    ``common.scan_out`` tag: each Mamba chunk's and chunkwise mLSTM
    chunk's output), recompute the rest (the reference's
    ``save_only_these_names("scan_out")``)."""
    if op == SCAN_OUT:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


#: each selective remat policy's choice of what to keep
_POLICIES = {"dots": _save_dots, "names": _save_names}


def preload_remat() -> threading.Thread:
    """Start importing, on a daemon thread, what the first call of
    ``torch.utils.checkpoint`` (the per-period remat) imports:
    ``torch._dynamo``, seconds of Python imports that a process's first
    training step would otherwise wait for.  A process calls it once its
    own imports are done and before it waits on the card, the disk or
    its peers; the first remat call then waits only for what is left of
    the import (the module's import lock)."""
    th = threading.Thread(target=importlib.import_module,
                          args=("torch._dynamo",), daemon=True)
    th.start()
    return th


def _remat_context(cfg: ArchConfig):
    """``context_fn`` of each period's checkpoint (reference
    ``_remat_policy``)."""
    if cfg.remat_policy not in ("full", "dots", "names"):
        raise ValueError(f"remat_policy {cfg.remat_policy!r}")
    if cfg.remat_policy == "full":
        return noop_context_fn
    return functools.partial(create_selective_checkpoint_contexts,
                             _POLICIES[cfg.remat_policy])


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
    """norm1 -> mixer [-> postnorm1] -> residual add, then norm2 -> MLP
    [-> postnorm2] -> residual add (the post-block norms with
    ``cfg.post_block_norm``, gemma's, each on its branch's output before
    the add)."""

    def __init__(self, cfg: ArchConfig, spec: BlockSpec,
                 gen: torch.Generator, device: torch.device):
        super().__init__()
        if spec.mixer not in MIXERS or spec.mlp not in (*MLPS, "none"):
            raise NotImplementedError(
                f"block {spec} is not ported yet (mixers {sorted(MIXERS)},"
                f" mlps {sorted(MLPS)} | none)")
        if spec.mixer == "attn" and cfg.attn_kind not in ATTN_KINDS:
            raise ValueError(f"attn_kind {cfg.attn_kind!r} (have "
                             f"{sorted(ATTN_KINDS)})")
        if spec.mlp == "moe" and not (cfg.moe and cfg.moe.n_experts):
            raise ValueError(f"{cfg.name}: an moe block needs cfg.moe")
        self.cfg, self.spec = cfg, spec
        self.norm1 = Norm(cfg, cfg.d_model, device)
        mixer = ATTN_KINDS[cfg.attn_kind] if spec.mixer == "attn" else \
            MIXERS[spec.mixer]
        self.mixer = mixer(cfg, gen, device)
        if spec.mlp != "none":
            self.norm2 = Norm(cfg, cfg.d_model, device)
            self.mlp = MLPS[spec.mlp](cfg, gen, device)
        if cfg.post_block_norm:
            self.postnorm1 = Norm(cfg, cfg.d_model, device)
            if spec.mlp != "none":
                self.postnorm2 = Norm(cfg, cfg.d_model, device)

    def forward(self, x, positions, cache):
        cfg = self.cfg
        h = apply_norm(cfg, self.norm1, x)
        y, cache = self.mixer(self.spec, h, positions, cache)
        if cfg.post_block_norm:
            y = apply_norm(cfg, self.postnorm1, y)
        x = x + y
        if self.spec.mlp == "none":
            return x, cache
        y = self.mlp(apply_norm(cfg, self.norm2, x))
        if cfg.post_block_norm:
            y = apply_norm(cfg, self.postnorm2, y)
        return x + y, cache

    def init_cache(self, batch: int, s_max: int,
                   device: torch.device) -> Dict[str, torch.Tensor]:
        return block_cache_init(self.cfg, self.spec, batch, s_max, device)


def block_cache_init(cfg: ArchConfig, spec: BlockSpec, batch: int,
                     s_max: int, device: DeviceLike
                     ) -> Dict[str, torch.Tensor]:
    """One layer's cache: KV for GQA, the latent for MLA, the recurrent
    state else."""
    if spec.mixer == "attn" and cfg.attn_kind == "mla":
        return mla_cache_init(cfg, batch, s_max, device)
    if spec.mixer == "mamba":
        return mamba_state_init(cfg, batch, device)
    if spec.mixer == "mlstm":
        return mlstm_state_init(cfg, batch, device)
    if spec.mixer == "slstm":
        return slstm_state_init(cfg, batch, device)
    return gqa_cache_init(cfg, batch, s_max, device)


def init_cache(cfg: ArchConfig, batch: int, s_max: int,
               device: DeviceLike) -> Cache:
    """The cache of a ``cfg`` model with no model behind it (the
    reference's ``init_cache(cfg, b, s)``): one dict a layer, the
    prefix's first, in the port's per-block list.  ``device="meta"``
    gives shapes and dtypes with no memory (``configs.shapes``)."""
    specs = tuple(cfg.prefix) + tuple(cfg.pattern) * cfg.n_periods
    return [block_cache_init(cfg, spec, batch, s_max, device)
            for spec in specs]


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig, gen: torch.Generator,
                 device: torch.device):
        super().__init__()
        if cfg.frontend not in FRONTENDS:
            raise ValueError(f"frontend {cfg.frontend!r} (have "
                             f"{FRONTENDS})")
        self.cfg = cfg
        self.device = device
        #: set by :meth:`shard_`: the mesh, each path's spec, and the
        #: 'model' group of the vocab-sharded embed / unembed (or None)
        self.mesh = None
        self.specs = None
        self.embed_tp = self.unembed_tp = None
        #: embed / unembed split over 'data' (``fsdp_params``): {name:
        #: (comm, dim)}, each gathered where it is used
        self.fsdp = {}
        # the reference's leaves: no embed for frames, no unembed when tied
        self.register_parameter("embed", None if cfg.frontend == "embeddings"
                                else nn.Parameter(embed_init(
                                    (cfg.vocab, cfg.d_model), gen, device)))
        self.register_parameter("unembed", None if cfg.tie_embeddings
                                else nn.Parameter(dense_init(
                                    (cfg.d_model, cfg.vocab), gen, device)))
        self.final_norm = Norm(cfg, cfg.d_model, device)
        specs = tuple(cfg.prefix) + tuple(cfg.pattern) * cfg.n_periods
        self.blocks = nn.ModuleList(Block(cfg, s, gen, device)
                                    for s in specs)
        if cfg.mtp:
            self.mtp = Block(cfg, MTP_SPEC, gen, device)
            self.mtp_norm = Norm(cfg, cfg.d_model, device)

    # -- helpers -----------------------------------------------------------
    def init_cache(self, batch: int, s_max: int) -> Cache:
        return init_cache(self.cfg, batch, s_max, self.device)

    def head(self) -> torch.Tensor:
        """The (d, V) LM head: ``unembed``, or ``embed.T`` when tied
        (gathered over 'data' under ``fsdp_params``)."""
        if self.cfg.tie_embeddings:
            return fsdp_weight(self, "embed").T
        return fsdp_weight(self, "unembed")

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        if self.unembed_tp is not None:
            raise NotImplementedError("serving a vocab-sharded model waits:"
                                      " the mesh path trains")
        return softcap(x.float() @ self.head().float(),
                       self.cfg.final_softcap)

    def param_tree(self) -> Dict[Tuple[str, ...], List[nn.Parameter]]:
        """The parameters in the reference's ``init_params`` tree, keyed
        by path and in its leaf order (keys sorted, as ``jax.tree``
        flattens a dict): a ``("periods", "b<i>", ...)`` leaf lists the
        Parameter of every period (layer p·period + i), stacked on a
        leading n_periods axis where the reference stacks it; any other
        leaf (``("prefix", "b<i>", ...)``, ``mtp``, ...) is one
        Parameter."""
        cfg = self.cfg
        tree: Dict[Tuple[str, ...], List[nn.Parameter]] = {
            (name,): [p] for name, p in (("embed", self.embed),
                                         ("unembed", self.unembed))
            if p is not None}
        whole = [(("final_norm",), self.final_norm)] + [
            (("prefix", f"b{i}"), self.blocks[i])
            for i in range(len(cfg.prefix))]
        if cfg.mtp:
            whole += [(("mtp",), self.mtp), (("mtp_norm",), self.mtp_norm)]
        for base, module in whole:
            for name, p in module.named_parameters():
                tree[base + tuple(name.split("."))] = [p]
        first = len(cfg.prefix)
        for i in range(cfg.period if cfg.n_periods else 0):
            for name, _ in self.blocks[first + i].named_parameters():
                tree[("periods", f"b{i}") + tuple(name.split("."))] = [
                    self.blocks[li].get_parameter(name)
                    for li in range(first + i, cfg.n_layers, cfg.period)]
        return dict(sorted(tree.items()))

    def stacked_shapes(self) -> Dict[Tuple[str, ...], Tuple[int, ...]]:
        """The shape of each :meth:`stacked` leaf (this rank's block on a
        mesh), without the copy."""
        return {k: ((len(ps),) if k[0] == "periods" else ())
                + tuple(ps[0].shape) for k, ps in self.param_tree().items()}

    @torch.no_grad()
    def shard_(self, mesh) -> "Model":
        """Keep this rank's block of every parameter under
        :func:`~.sharding.param_specs` on ``mesh`` (the whole model was
        built first, so the blocks are the single-device weights): the
        attention (GQA, MLA), Mamba, mLSTM, sLSTM, MLP and MoE weights
        split over 'model' (whole heads, MLA's latents in column blocks,
        whole sLSTM channel quads, Mamba's d_inner channels, every
        expert's f), embed on its vocab rows,
        unembed (or, tied, embed) on its vocab columns, the norms, the
        router and Mamba's per-channel vectors whole.  Under
        ``fsdp_params`` the attention, Mamba, MLP, expert, embed and
        unembed weights are also split over 'data' (ZeRO-3): each is
        gathered where it is used, and again in the per-period recompute
        (``collectives.fsdp_weight``), its gradient reduce-scattered.  A
        column shard that would cut a head (:func:`check_head_split`), a
        layer's weights split only in part (an MLA latent whose width
        the axis does not divide, say), a weight split over 'data' that
        its module does not gather, or an axis other than 'data' and
        'model' raise, naming the leaf.  The prefix blocks and the MTP
        block are split as a period's blocks are."""
        cfg = self.cfg
        specs = param_specs(cfg, self.stacked_shapes(), mesh)
        P = mesh.shape.get("model", 1)
        split = check_head_split(cfg, specs, P)
        comm = mesh.comm("model") if P > 1 else None
        data = mesh.comm("data") if mesh.shape.get("data", 1) > 1 else None
        for where, on in split.items():
            tp = comm if on else None
            for module in self._modules_at(where):
                module.tp = tp
                if getattr(module, "shared", None) is not None:
                    module.shared.tp = tp
        if ("embed",) in specs:
            self.embed_tp = comm if "model" in specs[("embed",)] else None
        head = ("embed",) if cfg.tie_embeddings else ("unembed",)
        self.unembed_tp = comm if "model" in specs[head] else None
        for k, ps in self.param_tree().items():
            inner = specs[k][1:] if k[0] == "periods" else specs[k]
            axes = split_axes(inner)
            if any(a not in ("data", "model") for a in axes):
                raise NotImplementedError(
                    f"{'/'.join(k)}: spec {specs[k]} splits over an axis "
                    "other than 'data' and 'model'")
            if "data" in axes and data is not None:
                self._gather_over_data(k, inner.index("data"), data)
            for p in ps:
                p.data = shard_leaf(p.data, inner, mesh).clone()
        self.mesh, self.specs = mesh, specs
        return self

    def _modules_at(self, where: Tuple[str, ...]) -> List[nn.Module]:
        """The modules at a :meth:`param_tree` path (without the leaf's
        name): a period's path names that module in each of its
        layers, a ``("prefix", "b<i>", ...)`` path prefix block i's."""
        cfg, first = self.cfg, len(self.cfg.prefix)
        if where[:1] == ("periods",):
            i = int(where[1][1:])
            return [self.blocks[li].get_submodule(".".join(where[2:]))
                    for li in range(first + i, cfg.n_layers, cfg.period)]
        if where[:1] == ("prefix",):
            return [self.blocks[int(where[1][1:])]
                    .get_submodule(".".join(where[2:]))]
        return [self.get_submodule(".".join(where))]

    def _gather_over_data(self, key, dim: int, comm) -> None:
        """Register leaf ``key`` as split over 'data' along ``dim``: each
        module holding one of its Parameters gathers it where it uses
        it.  A module that does not (no ``fsdp``) raises."""
        for owner in self._modules_at(key[:-1]):
            if not hasattr(owner, "fsdp"):
                raise NotImplementedError(
                    f"{'/'.join(key)}: split over 'data' (fsdp_params), "
                    f"and {type(owner).__name__} does not gather it")
            owner.fsdp[key[-1]] = (comm, dim)

    def _rows(self, tokens: torch.Tensor) -> torch.Tensor:
        """Rows of the embedding; vocab-sharded, a masked gather of this
        rank's rows and an all-reduce (one rank holds each row); split
        over 'data' too, its columns gathered first."""
        embed = fsdp_weight(self, "embed")     # its d columns over 'data'
        if self.embed_tp is None:
            return embed[tokens]
        rows = embed.shape[0]
        local = tokens - self.embed_tp.index * rows
        hit = (local >= 0) & (local < rows)
        x = embed[torch.clamp(local, 0, rows - 1)] * hit[..., None]
        return reduce_from_group(x.float(), self.embed_tp).to(x.dtype)

    def _embed(self, tokens: Optional[torch.Tensor],
               embeds: Optional[torch.Tensor] = None,
               patch_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The frontend's (B, S, d) input (reference ``_embed_input``):
        frames cast to bf16, or token rows with the patch embeddings in
        front of them (vlm), then the embed scale, rounded to the rows'
        dtype before the product."""
        cfg = self.cfg
        if cfg.frontend == "embeddings":
            if embeds is None or tokens is not None:
                raise ValueError(f"{cfg.name} takes frames (embeds=), "
                                 "not tokens")
            x = embeds.to(torch.bfloat16)
        else:
            if embeds is not None:
                raise ValueError(f"{cfg.name} takes tokens, not frames")
            if patch_embeds is not None and cfg.frontend != "vlm":
                raise ValueError(f"{cfg.name}: patch_embeds needs the vlm "
                                 "frontend")
            if patch_embeds is not None and \
                    patch_embeds.shape[1] != cfg.n_frontend_tokens:
                raise ValueError(f"{cfg.name} takes {cfg.n_frontend_tokens}"
                                 " patch embeddings a sample, not "
                                 f"{patch_embeds.shape[1]}")
            x = self._rows(tokens)
            if patch_embeds is not None:
                x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
        if cfg.embed_scale:
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                                 device=x.device)
        return x

    def stacked(self, get=lambda p: p.detach()) -> Dict[Tuple[str, ...],
                                                         torch.Tensor]:
        """:meth:`param_tree` with each leaf as one tensor: ``get`` of
        each Parameter (default its data; ``lambda p: p.grad`` for the
        gradients), stacked on the n_periods axis for the periods'
        leaves (a copy; with one period a view, so that a model cut to
        one period at full width does not hold its weights twice in a
        train step), the tensor itself for the others."""
        def leaf(k, ps):
            if k[0] != "periods":
                return get(ps[0])
            if len(ps) == 1:
                return get(ps[0]).unsqueeze(0)
            return torch.stack([get(p) for p in ps])
        return {k: leaf(k, ps) for k, ps in self.param_tree().items()}

    @torch.no_grad()
    def load_stacked(self, tree: Dict[Tuple[str, ...], torch.Tensor]
                     ) -> None:
        """Copy a :meth:`stacked` tree into the parameters, in place
        (period i of a stacked leaf into layer p·period + i)."""
        for k, ps in self.param_tree().items():
            if k[0] == "periods":
                for i, p in enumerate(ps):
                    p.copy_(tree[k][i])
            else:
                ps[0].copy_(tree[k])

    def _period(self, p: int, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
        period, first = self.cfg.period, len(self.cfg.prefix)
        for blk in self.blocks[first + p * period:first + (p + 1) * period]:
            x, _ = blk(x, positions, None)
        return x

    # -- entry points ------------------------------------------------------
    def forward(self, tokens: Optional[torch.Tensor],
                positions: Optional[torch.Tensor] = None,
                cache: Optional[Cache] = None, remat: bool = True, *,
                embeds: Optional[torch.Tensor] = None,
                patch_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
        """tokens (B, S) int (or ``embeds`` (B, S, d) frames for the
        "embeddings" frontend; ``patch_embeds`` (B, P, d) before the
        tokens for "vlm") -> final-norm hidden states (B, S(+P), d).

        The prefix blocks run first, as the reference's unscanned
        lead-in.  Without a cache and with autograd on, each period is
        recomputed in the backward pass (``torch.utils.checkpoint``)
        under ``cfg.remat_policy``, as the reference's scan body is:
        "full" keeps only the period's input, "names" also the named
        scan outputs (each Mamba and chunkwise mLSTM chunk's output,
        ``common.scan_out``), "dots" those and the outputs of its
        matmuls without batch dims (the projections).  What a policy
        keeps is not recomputed, so every policy gives the same
        gradients, bit for bit."""
        x = self._embed(tokens, embeds, patch_embeds)
        b, s, _ = x.shape
        if positions is None:
            positions = torch.arange(s, device=x.device)[None].expand(b, -1)
        if cache is None and remat and torch.is_grad_enabled():
            ctx = _remat_context(self.cfg)
            for blk in self.blocks[:len(self.cfg.prefix)]:
                x, _ = blk(x, positions, None)
            for p in range(self.cfg.n_periods):
                x = checkpoint(self._period, p, x, positions,
                               use_reentrant=False, context_fn=ctx)
        else:
            for i, blk in enumerate(self.blocks):
                x, _ = blk(x, positions,
                           None if cache is None else cache[i])
        return apply_norm(self.cfg, self.final_norm, x), cache

    @torch.no_grad()
    def prefill(self, tokens: Optional[torch.Tensor], s_max: int,
                return_hidden: bool = False, *,
                embeds: Optional[torch.Tensor] = None,
                patch_embeds: Optional[torch.Tensor] = None):
        """Full-sequence forward building a fresh KV cache; logits of the
        last position only (B, 1, V).  ``return_hidden`` also returns
        the final-norm hidden states (B, S, d), the patch positions
        included.  Frames and patches as :meth:`forward`."""
        b = (embeds if tokens is None else tokens).shape[0]
        cache = self.init_cache(b, s_max)
        x, cache = self.forward(tokens, cache=cache, remat=False,
                                embeds=embeds, patch_embeds=patch_embeds)
        logits = self._logits(x[:, -1:])
        if return_hidden:
            return logits, cache, x
        return logits, cache

    @torch.no_grad()
    def decode_step(self, token: Optional[torch.Tensor], pos: torch.Tensor,
                    cache: Cache, *, embeds: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Cache]:
        """One token per sequence: token (B, 1), or for the "embeddings"
        frontend ``token=None`` and a (B, 1, d) frame ``embeds``; pos
        (B, 1)."""
        x, cache = self.forward(token, positions=pos, cache=cache,
                                remat=False, embeds=embeds)
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


def _xent_chunk_tp(cfg: ArchConfig, w: torch.Tensor, x: torch.Tensor,
                   labels: torch.Tensor, comm
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_xent_chunk` with ``w`` this rank's vocab columns
    (d, V/|model|): the max, the sum of exponentials and the label's
    logit are each all-reduced over 'model'."""
    x = copy_to_group(x, comm)
    logits = softcap(x.float() @ w.float(), cfg.final_softcap)
    with torch.no_grad():
        m = all_reduce(logits.max(dim=-1).values, comm, op="max")
    se = reduce_from_group(torch.exp(logits - m[..., None]).sum(dim=-1),
                           comm)
    lse = m + torch.log(se)
    cols = w.shape[-1]
    lab = torch.clamp(labels, min=0).long() - comm.index * cols
    hit = (lab >= 0) & (lab < cols)
    ll = torch.gather(logits, -1, torch.clamp(lab, 0, cols - 1)[..., None])
    ll = reduce_from_group(ll[..., 0] * hit, comm)
    valid = labels >= 0
    return torch.sum((lse - ll) * valid), torch.sum(valid).float()


def _xent_terms(model: Model, w: torch.Tensor, x: torch.Tensor,
                labels: torch.Tensor, chunk: int, remat: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the token losses, count of valid tokens) of hidden ``x``
    (B, S, d) against ``labels`` through the head ``w``, chunk by
    chunk."""
    cfg = model.cfg
    b, s, _ = x.shape
    nchunks = max(s // chunk, 1)
    cs = s // nchunks
    fn, extra = _xent_chunk, ()
    if model.unembed_tp is not None:
        fn, extra = _xent_chunk_tp, (model.unembed_tp,)
    tot = torch.zeros((), device=x.device)
    cnt = torch.zeros((), device=x.device)
    for i in range(nchunks):
        xs, ls = x[:, i * cs:(i + 1) * cs], labels[:, i * cs:(i + 1) * cs]
        if remat and torch.is_grad_enabled():
            l, n = checkpoint(fn, cfg, w, xs, ls, *extra,
                              use_reentrant=False)
        else:
            l, n = fn(cfg, w, xs, ls, *extra)
        tot, cnt = tot + l, cnt + n
    return tot, cnt


#: the weight of the MTP block's t+2 cross-entropy (the reference's)
MTP_WEIGHT = 0.3


Terms = Tuple[torch.Tensor, torch.Tensor]


def lm_loss_terms(model: Model, batch: Dict[str, torch.Tensor],
                  chunk: int = 512, remat: bool = True
                  ) -> Tuple[Terms, Optional[Terms]]:
    """:func:`lm_loss` before its divisions, so that a data-parallel
    step can divide each sum by its count over every rank's rows: the
    next-token (sum of the token losses, count of valid tokens) and,
    with ``cfg.mtp``, the t+2 pair (else None): the MTP block on the
    final-normed hidden the head reads, at the batch's positions, then
    ``mtp_norm``, against ``labels[:, 1:]`` padded with -1.  With a
    vocab-sharded head the loss is vocab-parallel, chunk by chunk; the
    head is gathered over 'data' once (``fsdp_params``) for both
    terms."""
    cfg = model.cfg
    x, _ = model(batch.get("tokens"), positions=batch.get("positions"),
                 remat=remat, embeds=batch.get("embeds"),
                 patch_embeds=batch.get("patch_embeds"))
    labels = batch["labels"]
    w = model.head()
    terms = _xent_terms(model, w, x, labels, chunk, remat)
    if not cfg.mtp:
        return terms, None
    b, s, _ = x.shape
    pos = batch.get("positions")
    if pos is None:
        pos = torch.arange(s, device=x.device)[None].expand(b, -1)
    h, _ = model.mtp(x, pos, None)
    h = apply_norm(cfg, model.mtp_norm, h)
    lab2 = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1], -1)],
                     dim=1)
    return terms, _xent_terms(model, w, h, lab2, chunk, remat)


def lm_loss(model: Model, batch: Dict[str, torch.Tensor], chunk: int = 512,
            remat: bool = True) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"]`` (or its
    ``"embeds"`` frames; with its ``"patch_embeds"`` in front) against
    ``batch["labels"]`` (-1 ignored; one a position of the whole
    sequence, patches included), over sequence chunks of ``chunk``
    positions, each recomputed in the backward pass when ``remat``
    (positions past the last whole chunk are dropped, as the
    reference's reshape drops them); with ``cfg.mtp`` plus
    ``MTP_WEIGHT`` times the MTP block's mean t+2 cross-entropy."""
    (tot, cnt), mtp = lm_loss_terms(model, batch, chunk, remat)
    loss = tot / torch.clamp(cnt, min=1.0)
    if mtp is not None:
        loss = loss + MTP_WEIGHT * mtp[0] / torch.clamp(mtp[1], min=1.0)
    return loss


def init_model(cfg: ArchConfig, seed: int = 0,
               device: DeviceLike = None, mesh=None) -> Model:
    """Random weights from ``seed`` (truncated normal, bf16) on
    ``device`` — the GPU unless the caller asks for the CPU.  With a
    ``mesh``, the whole model is drawn as on one device and each rank
    keeps its block (:meth:`Model.shard_`), so the blocks are the
    single-device weights bit for bit."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model = Model(cfg, gen, dev)
    return model if mesh is None else model.shard_(mesh)


def from_jax_params(np_tree: Dict[str, Any], cfg: ArchConfig,
                    device: DeviceLike = None, mesh=None) -> Model:
    """Build a :class:`Model` holding the weights of
    ``repro.models.model.init_params`` (as numpy arrays, with the
    stacked ``periods`` leaves' leading n_periods axis, the MoE experts'
    (n_periods, E, d, f) included, the unstacked ``prefix`` blocks and
    the ``mtp`` / ``mtp_norm`` leaves); with a ``mesh``, this rank's blocks
    of them.  A leaf with no Parameter to go to (a nested dict
    included), a shape that differs, or a Parameter that no leaf fills
    raises ``ValueError``, naming the path."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    model = Model(cfg, gen, dev)
    placed = set()

    def put(module: nn.Module, tree, path, take) -> None:
        for k, v in tree.items():
            where = path + (k,)
            target = getattr(module, k, None)
            if isinstance(v, dict) and isinstance(target, nn.Module):
                put(target, v, where, take)
                continue
            if isinstance(v, dict) or not isinstance(target, nn.Parameter):
                raise ValueError(f"{'/'.join(where)}: the port has no "
                                 "parameter to place it in")
            src = torch.from_numpy(np.array(take(v), dtype=np.float32))
            if tuple(src.shape) != tuple(target.shape):
                raise ValueError(f"{'/'.join(where)}: shape "
                                 f"{tuple(src.shape)} != "
                                 f"{tuple(target.shape)}")
            target.data.copy_(src.to(target.dtype))
            placed.add(id(target))

    whole = lambda a: a                         # noqa: E731
    top = {k: v for k, v in np_tree.items() if k not in ("periods",
                                                          "prefix")}
    put(model, top, (), whole)
    first = len(cfg.prefix)
    for name, sub in np_tree.get("prefix", {}).items():
        i = int(name[1:]) if name[:1] == "b" and name[1:].isdigit() else -1
        if not 0 <= i < first:
            raise ValueError(f"prefix/{name}: the port has no parameter to "
                             f"place it in ({first} prefix blocks)")
        put(model.blocks[i], sub, ("prefix", name), whole)
    for li, blk in enumerate(model.blocks[first:]):
        p, i = divmod(li, cfg.period)
        put(blk, np_tree["periods"][f"b{i}"], ("periods", f"b{i}"),
            lambda a, p=p: np.asarray(a)[p])

    def leaves(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, path + (k,))
            else:
                yield path + (k,), v
    if not cfg.n_periods:       # the reference's (0, ...) stacks hold nothing
        for where, v in leaves(np_tree.get("periods", {}), ("periods",)):
            if np.size(v):
                raise ValueError(f"{'/'.join(where)}: the port has no "
                                 "parameter to place it in (no periods)")
    missed = [n for n, q in model.named_parameters() if id(q) not in placed]
    if missed:
        raise ValueError(f"no leaf for the port's parameters {missed[:4]}"
                         f"{' ...' if len(missed) > 4 else ''}")
    return model if mesh is None else model.shard_(mesh)
