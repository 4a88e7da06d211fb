"""Train and serve step factories (port of :mod:`repro.launch.steps`).

``make_train_step`` builds the training step: microbatched gradient
accumulation, global-norm clipping, optionally int8 gradient
compression with error feedback, and the optimizer update (AdamW /
AdamW-8bit / Muon), with the host seconds of each part.  On a model
sharded over a (data, model) mesh (``Model.shard_``) the same step runs
on this rank's rows and blocks: the gradient mean over the data axes
(``collectives.all_reduce``, or ``ErrorFeedbackInt8.allreduce`` int8 on
the wire; a leaf split over 'data' under ``fsdp_params`` arrives summed
by its gather's reduce-scatter and is only divided), the global norm
summed over the axes each sharded leaf is split over, and the optimizer
on the blocks.
``make_prefill_step`` / ``make_decode_step`` are the serving entry
points.  PyTorch runs them eagerly; the parameters live in the model
and the optimizers see them as the reference's tree
(:meth:`~repro_torch.models.model.Model.param_tree`, stacked leaves
stacked).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

from ..distributed import collectives
from ..models.common import ArchConfig
from ..models.model import MTP_WEIGHT, Model, lm_loss, lm_loss_terms
from ..models.sharding import split_axes
from ..optim.adamw import AdamW
from ..optim.muon import Muon
from .mesh import dp_axes

Tree = Dict[Any, torch.Tensor]


def describe_blas_routing(shapes: Iterable[Tuple[int, ...]],
                          limit: int = 12, grad: bool = True,
                          device=None, mesh=None,
                          axis: str = "model") -> List[str]:
    """Routing table of the optimizer's symmetric kernels: one line per
    distinct trailing-2-D parameter shape (whole shapes), the route the
    NS Gram SYRK takes (``blas.explain``) on one device or, given a
    ``mesh``, on its ``axis``, and with ``grad=True`` the route of its
    cotangent SYMM."""
    from .. import blas
    if mesh is not None and axis not in mesh.shape:
        return [f"  (mesh has no {axis!r} axis: all shapes route dense)"]
    pairs = sorted({tuple(sorted(int(s) for s in shape[-2:]))
                    for shape in shapes if len(shape) >= 2})
    lines = []
    for n1, n2 in pairs[:limit]:
        text = blas.explain("syrk", n1, n2, device=device, mesh=mesh,
                            axis=None if mesh is None else axis, grad=grad)
        lines.extend("  " + ln for ln in text.splitlines())
    if len(pairs) > limit:
        lines.append(f"  ... ({len(pairs) - limit} more shapes)")
    return lines


def make_optimizer(cfg: ArchConfig, name: str = "adamw", lr: float = 3e-4,
                   track_gram: bool = False, mesh=None,
                   specs: Optional[Dict[Any, Any]] = None):
    """``track_gram``: EMA a packed momentum-Gram per 2-D matrix param in
    the Muon state (ignored by the AdamW family).  ``muon-syrk`` names
    the 1D mesh schedule, which with no mesh takes the reference branch,
    as the reference does when its mesh is None.  ``specs``: the
    parameters are this rank's blocks on ``mesh`` (Muon orthogonalizes
    them there; AdamW is elementwise and needs neither)."""
    gd = 0.99 if track_gram else None
    if name == "adamw":
        return AdamW(lr=lr)
    if name == "adamw8bit":
        return AdamW(lr=lr, quantize_moments=True)
    if name == "muon":
        return Muon(lr=2e-2, mode="reference", gram_decay=gd, mesh=mesh,
                    specs=specs)
    if name == "muon-syrk":
        return Muon(lr=2e-2, mode="syrk-1d", gram_decay=gd, mesh=mesh,
                    specs=specs)
    raise ValueError(name)


def _split_axes(spec, mesh) -> Tuple[str, ...]:
    """The mesh axes of more than one rank that ``spec`` splits over."""
    return tuple(sorted(a for a in set(split_axes(spec))
                        if mesh.shape.get(a, 1) > 1))


def _clip_by_global_norm(grads: Tree, max_norm: float, specs=None,
                         mesh=None) -> Tuple[Tree, torch.Tensor]:
    """Scale every gradient by min(1, max_norm / ‖g‖) (‖g‖ over all
    leaves, in f32); the clipped gradients are f32, as the reference's
    (a bf16 leaf times its f32 scale promotes there).  Given this rank's
    blocks (``specs`` on ``mesh``), the squares of the leaves split over
    'model', 'data' (``fsdp_params``) or both are all-reduced over those
    axes, one all-reduce for each set of axes, and each replicated leaf
    counts once."""
    dev = next(iter(grads.values())).device

    def sq(keys) -> torch.Tensor:
        return sum((torch.sum(torch.square(grads[k].float())) for k in keys),
                   torch.zeros((), device=dev))

    if specs is None:
        total = sq(grads)
    else:
        groups: Dict[Tuple[str, ...], List[Any]] = {}
        for k in grads:
            groups.setdefault(_split_axes(specs[k], mesh), []).append(k)
        total = torch.zeros((), device=dev)
        for axes in sorted(groups, key=lambda a: (not a, a)):
            part = sq(groups[axes])
            for a in axes:
                part = collectives.all_reduce(part, mesh.comm(a))
            total = total + part
    gn = torch.sqrt(total)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return {k: g.float() * scale for k, g in grads.items()}, gn


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _delta(now: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before.get(k, 0) for k, v in now.items()
            if v != before.get(k, 0)}


def data_parallel_loss(model: Model, batch: Dict[str, torch.Tensor],
                       dp: List[Any], chunk: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's share of the global batch's loss on a sharded model,
    ``batch`` its rows, ``dp`` the data axes' groups of more than one
    rank: (what to differentiate, the global loss, detached).  The first
    is its rows' token losses over the valid tokens of every data rank's
    rows, times the data ranks (with an MTP block, plus ``MTP_WEIGHT``
    times its rows' t+2 losses over every data rank's valid t+2 tokens,
    times the data ranks), so that the gradients' mean over the data
    axes is the global loss's gradient; the second, that mean of the
    first, is the same on every rank."""
    n_dp = 1
    for c in dp:
        n_dp *= c.size

    def dp_sum(x: torch.Tensor) -> torch.Tensor:
        for c in dp:
            x = collectives.all_reduce(x, c)
        return x

    (tot, cnt), mtp = lm_loss_terms(model, batch, chunk=chunk)
    if mtp is None:
        cnt = torch.clamp(dp_sum(cnt.detach()), min=1.0)
        loss = tot * (n_dp / cnt)
    else:           # both counts over the data axes in one all-reduce
        cnt, cnt2 = torch.clamp(dp_sum(torch.stack(
            [cnt, mtp[1]]).detach()), min=1.0)
        loss = tot * (n_dp / cnt) + MTP_WEIGHT * mtp[0] * (n_dp / cnt2)
    return loss, dp_sum(loss.detach()) / n_dp


def make_train_step(model: Model, optimizer, *, microbatches: int = 1,
                    clip_norm: float = 1.0, loss_chunk: int = 512,
                    compressor=None) -> Callable:
    """Returns ``train_step(opt_state, batch) -> (opt_state, metrics)``;
    it updates the model's parameters in place.  ``microbatches`` > 1
    accumulates f32 gradients over that split of the batch.  ``metrics``
    holds the loss, the gradient norm and the host seconds of loss +
    backward, clipping, compression (``compress_s``, 0 without a
    compressor) and the optimizer, each ending in a sync.

    ``compressor`` (:class:`~repro_torch.distributed.ErrorFeedbackInt8`):
    ``opt_state`` is then the pair (optimizer state, EF state), and the
    clipped gradients pass through its int8 quantize / dequantize with
    error feedback before the optimizer, as the reference's step does.

    On a sharded model ``batch`` is this rank's rows, and each rank
    differentiates its share of the global loss
    (:func:`data_parallel_loss`); ``metrics["loss"]`` is the global
    batch's on every rank.  A ``compressor`` then replaces the
    data-axis mean (each rank's own residual; the reduction before the
    clip, as the wire needs), timed as ``compress_s``; the plain mean is
    ``reduce_s``.  With no data axis over 1 rank the compressor runs
    after the clip, as on one device.  ``metrics["words"]`` / ``["bytes"]``: this rank's
    collectives by phase (``loss_backward``, ``reduce``, ``clip``,
    ``opt``) and kind."""
    mesh = model.mesh
    axes = [a for a in dp_axes(mesh) if mesh.shape[a] > 1] \
        if mesh is not None else []
    dp = [mesh.comm(a) for a in axes]
    n_dp = 1
    for c in dp:
        n_dp *= c.size
    # the leaves split over a data axis (fsdp_params): their gradients
    # came out of the gather's reduce-scatter already summed over it
    summed = {k: [a for a in axes if a in _split_axes(spec, mesh)]
              for k, spec in (model.specs or {}).items()}
    if compressor is not None and len(dp) > 1:
        raise NotImplementedError("compressed gradients over more than one "
                                  "data axis")
    if compressor is not None and dp and any(summed.values()):
        raise NotImplementedError(
            "compressed gradients of weights split over 'data' "
            "(fsdp_params) wait for ROADMAP A11g")

    def dp_sum(x: torch.Tensor, skip=()) -> torch.Tensor:
        for a, c in zip(axes, dp):
            if a not in skip:
                x = collectives.all_reduce(x, c)
        return x

    def loss_and_grads(batch) -> Tuple[torch.Tensor, Tree]:
        model.zero_grad(set_to_none=True)
        if mesh is None:
            loss = lm_loss(model, batch, chunk=loss_chunk)
            loss.backward()
            return loss.detach(), model.stacked(lambda p: p.grad)
        loss, global_loss = data_parallel_loss(model, batch, dp, loss_chunk)
        loss.backward()
        return global_loss, model.stacked(lambda p: p.grad)

    def counted() -> Tuple[Dict[str, int], Dict[str, int]]:
        return collectives.word_counts(), collectives.byte_counts()

    def train_step(opt_state, batch: Dict[str, torch.Tensor]):
        dev = model.device
        _sync(dev)
        marks = [counted()]
        t0 = time.perf_counter()
        if microbatches > 1:
            loss_sum, gacc = 0.0, None
            for i in range(microbatches):
                mb = {k: v.chunk(microbatches, dim=0)[i]
                      for k, v in batch.items()}
                loss, g = loss_and_grads(mb)
                loss_sum = loss_sum + loss
                gacc = {k: x.float() if gacc is None else gacc[k] + x.float()
                        for k, x in g.items()}
            loss = loss_sum / microbatches
            grads = {k: x / microbatches for k, x in gacc.items()}
        else:
            loss, grads = loss_and_grads(batch)
        model.zero_grad(set_to_none=True)
        _sync(dev)
        t1 = time.perf_counter()
        marks.append(counted())
        inner = opt_state
        if compressor is not None:
            inner, ef = opt_state
        # over the data axes the int8 mean comes before the clip, as the
        # wire needs; with none the single-device order: clip, compress
        reduced = compressor is not None and bool(dp)
        if reduced:
            grads, ef = compressor.allreduce(grads, ef, dp[0])
        elif dp:
            grads = {k: dp_sum(g.float(), summed[k]) / n_dp
                     for k, g in grads.items()}
        _sync(dev)
        t2 = time.perf_counter()
        marks.append(counted())
        grads, gnorm = _clip_by_global_norm(grads, clip_norm, model.specs,
                                            mesh)
        _sync(dev)
        t3 = time.perf_counter()
        if compressor is not None and not reduced:
            grads, ef = compressor.compress(grads, ef)
            _sync(dev)
        t4 = time.perf_counter()
        marks.append(counted())
        params = model.stacked()
        new_params, inner = optimizer.update(grads, inner, params)
        del grads, params
        model.load_stacked(new_params)
        _sync(dev)
        t5 = time.perf_counter()
        marks.append(counted())
        phases = ("loss_backward", "reduce", "clip", "opt")
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "loss_backward_s": t1 - t0,
                   "reduce_s": t2 - t1 if dp and not reduced else 0.0,
                   "clip_s": t3 - t2,
                   "compress_s": (t2 - t1) + (t4 - t3) if reduced
                   else t4 - t3,
                   "opt_s": t5 - t4,
                   "words": {p: _delta(marks[i + 1][0], marks[i][0])
                             for i, p in enumerate(phases)},
                   "bytes": {p: _delta(marks[i + 1][1], marks[i][1])
                             for i, p in enumerate(phases)}}
        if compressor is not None:
            return (inner, ef), metrics
        return inner, metrics

    return train_step


def init_opt_state(model: Model, optimizer, compressor=None):
    """The optimizer's state for the model's parameter tree; with a
    ``compressor``, the pair (that state, the compressor's EF state)."""
    params = model.stacked()
    if compressor is None:
        return optimizer.init(params)
    return optimizer.init(params), compressor.init(params)


def make_prefill_step(model: Model, s_max: int,
                      return_hidden: bool = False) -> Callable:
    """``prefill_step(tokens)`` -> (logits, cache[, hidden]); hidden are
    the final-norm activations (B, S, d), padded positions included.
    ``embeds=`` (frames, with ``tokens`` None) and ``patch_embeds=`` go
    to :meth:`~repro_torch.models.model.Model.prefill`, as the
    reference's batch keys do."""
    def prefill_step(tokens: Optional[torch.Tensor], *,
                     embeds: Optional[torch.Tensor] = None,
                     patch_embeds: Optional[torch.Tensor] = None):
        return model.prefill(tokens, s_max=s_max,
                             return_hidden=return_hidden, embeds=embeds,
                             patch_embeds=patch_embeds)
    return prefill_step


def make_decode_step(model: Model) -> Callable:
    """``decode_step(token, pos, cache)`` -> (next_token (B, 1) int32,
    logits, cache), greedy; for the "embeddings" frontend ``token=None``
    and ``embeds=`` a (B, 1, d) frame."""
    def serve_step(token: Optional[torch.Tensor], pos: torch.Tensor, cache,
                   *, embeds: Optional[torch.Tensor] = None):
        logits, cache = model.decode_step(token, pos, cache, embeds=embeds)
        next_token = torch.argmax(logits[:, -1], dim=-1)[:, None] \
            .to(torch.int32)
        return next_token, logits, cache
    return serve_step
