"""Serving step factories (port of the serving half of
:mod:`repro.launch.steps`): plain functions around the model's
``prefill`` / ``decode_step``; PyTorch runs them eagerly."""
from __future__ import annotations

from typing import Callable

import torch

from ..models.model import Model


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
