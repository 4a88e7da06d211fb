"""Input-shape cells and meta-tensor ``input_specs`` per architecture
(port of :mod:`repro.configs.shapes`).

The four LM shapes (seq_len × global_batch):
  train_4k    : 4,096 × 256   -> train_step
  prefill_32k : 32,768 × 32   -> serve prefill
  decode_32k  : 32,768 × 128  -> serve decode (1 new token, 32k cache)
  long_500k   : 524,288 × 1   -> long-context decode (sub-quadratic archs
                                 only: xlstm, jamba)

The stand-ins are tensors on the meta device (the reference's
``ShapeDtypeStruct``): shapes and dtypes, no memory.  The decode cells'
``cache`` is the port's per-block list (``models.model.init_cache`` on
meta).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from ..models.common import ArchConfig
from ..models.model import init_cache

META = torch.device("meta")


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_applicable(cfg: ArchConfig, shape_name: str) -> bool:
    """long_500k only for sub-quadratic archs."""
    if shape_name == "long_500k":
        return cfg.subquadratic
    return True


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ArchConfig, shape_name: str,
                scale: int = 1) -> Dict[str, Any]:
    """Meta-tensor stand-ins for every model input of the cell, under
    the reference's keys.  ``scale`` divides batch (for reduced smoke
    runs of the same cell)."""
    cell = SHAPES[shape_name]
    b = max(cell.global_batch // scale, 1)
    s = cell.seq_len
    out: Dict[str, Any] = {}
    if cell.kind in ("train", "prefill"):
        if cfg.frontend == "embeddings":
            out["embeds"] = _meta((b, s, cfg.d_model), torch.bfloat16)
        elif cfg.frontend == "vlm":
            out["tokens"] = _meta((b, s - cfg.n_frontend_tokens),
                                  torch.int32)
            out["patch_embeds"] = _meta((b, cfg.n_frontend_tokens,
                                         cfg.d_model), torch.bfloat16)
        else:
            out["tokens"] = _meta((b, s), torch.int32)
        if cell.kind == "train":
            out["labels"] = _meta((b, s), torch.int32)
    else:  # decode: one new token against an s-long cache
        if cfg.frontend == "embeddings":
            out["token"] = _meta((b, 1, cfg.d_model), torch.bfloat16)
        else:
            out["token"] = _meta((b, 1), torch.int32)
        out["pos"] = _meta((b, 1), torch.int32)
        out["cache"] = init_cache(cfg, b, s, META)
    return out
