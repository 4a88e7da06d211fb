"""Train and serve step factories (port of :mod:`repro.launch.steps`).

``make_train_step`` builds the single-device training step: microbatched
gradient accumulation, global-norm clipping and the optimizer update
(AdamW / AdamW-8bit / Muon), with the host seconds of each part.
``make_prefill_step`` / ``make_decode_step`` are the serving entry
points.  PyTorch runs them eagerly; the parameters live in the model
and the optimizers see them as the reference's tree
(:meth:`~repro_torch.models.model.Model.param_tree`, stacked leaves
stacked).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, List, Tuple

import torch

from ..models.common import ArchConfig
from ..models.model import Model, lm_loss
from ..optim.adamw import AdamW
from ..optim.muon import Muon

Tree = Dict[Any, torch.Tensor]


def describe_blas_routing(shapes: Iterable[Tuple[int, ...]],
                          limit: int = 12, grad: bool = True,
                          device=None) -> List[str]:
    """Routing table of the optimizer's symmetric kernels on one device:
    one line per distinct trailing-2-D parameter shape, the route the NS
    Gram SYRK takes (``blas.explain``), and with ``grad=True`` the route
    of its cotangent SYMM."""
    from .. import blas
    pairs = sorted({tuple(sorted(int(s) for s in shape[-2:]))
                    for shape in shapes if len(shape) >= 2})
    lines = []
    for n1, n2 in pairs[:limit]:
        text = blas.explain("syrk", n1, n2, device=device, grad=grad)
        lines.extend("  " + ln for ln in text.splitlines())
    if len(pairs) > limit:
        lines.append(f"  ... ({len(pairs) - limit} more shapes)")
    return lines


def make_optimizer(cfg: ArchConfig, name: str = "adamw", lr: float = 3e-4,
                   track_gram: bool = False):
    """``track_gram``: EMA a packed momentum-Gram per 2-D matrix param in
    the Muon state (ignored by the AdamW family).  ``muon-syrk`` names
    the 1D mesh schedule, which with no mesh takes the reference branch,
    as the reference does when its mesh is None."""
    gd = 0.99 if track_gram else None
    if name == "adamw":
        return AdamW(lr=lr)
    if name == "adamw8bit":
        return AdamW(lr=lr, quantize_moments=True)
    if name == "muon":
        return Muon(lr=2e-2, mode="reference", gram_decay=gd)
    if name == "muon-syrk":
        return Muon(lr=2e-2, mode="syrk-1d", gram_decay=gd)
    raise ValueError(name)


def _clip_by_global_norm(grads: Tree, max_norm: float
                         ) -> Tuple[Tree, torch.Tensor]:
    """Scale every gradient by min(1, max_norm / ‖g‖) (‖g‖ over all
    leaves, in f32); the clipped gradients are f32, as the reference's
    (a bf16 leaf times its f32 scale promotes there)."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                        for g in grads.values()))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return {k: g.float() * scale for k, g in grads.items()}, gn


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_train_step(model: Model, optimizer, *, microbatches: int = 1,
                    clip_norm: float = 1.0,
                    loss_chunk: int = 512) -> Callable:
    """Returns ``train_step(opt_state, batch) -> (opt_state, metrics)``;
    it updates the model's parameters in place.  ``microbatches`` > 1
    accumulates f32 gradients over that split of the batch.  ``metrics``
    holds the loss, the gradient norm and the host seconds of loss +
    backward, clipping and the optimizer, each ending in a sync."""
    def loss_and_grads(batch) -> Tuple[torch.Tensor, Tree]:
        model.zero_grad(set_to_none=True)
        loss = lm_loss(model, batch, chunk=loss_chunk)
        loss.backward()
        return loss.detach(), model.stacked(lambda p: p.grad)

    def train_step(opt_state, batch: Dict[str, torch.Tensor]):
        dev = model.device
        _sync(dev)
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
        grads, gnorm = _clip_by_global_norm(grads, clip_norm)
        _sync(dev)
        t2 = time.perf_counter()
        params = model.stacked()
        new_params, opt_state = optimizer.update(grads, opt_state, params)
        del grads, params
        model.load_stacked(new_params)
        _sync(dev)
        t3 = time.perf_counter()
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "loss_backward_s": t1 - t0, "clip_s": t2 - t1,
                   "opt_s": t3 - t2}
        return opt_state, metrics

    return train_step


def init_opt_state(model: Model, optimizer):
    """The optimizer's state for the model's parameter tree."""
    return optimizer.init(model.stacked())


def make_prefill_step(model: Model, s_max: int,
                      return_hidden: bool = False) -> Callable:
    """``prefill_step(tokens)`` -> (logits, cache[, hidden]); hidden are
    the final-norm activations (B, S, d), padded positions included."""
    def prefill_step(tokens: torch.Tensor):
        return model.prefill(tokens, s_max=s_max,
                             return_hidden=return_hidden)
    return prefill_step


def make_decode_step(model: Model) -> Callable:
    """``decode_step(token, pos, cache)`` -> (next_token (B, 1) int32,
    logits, cache), greedy."""
    def serve_step(token: torch.Tensor, pos: torch.Tensor, cache):
        logits, cache = model.decode_step(token, pos, cache)
        next_token = torch.argmax(logits[:, -1], dim=-1)[:, None] \
            .to(torch.int32)
        return next_token, logits, cache
    return serve_step
