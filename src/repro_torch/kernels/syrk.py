"""SYRK into packed lower-triangle tiles (port of
:mod:`repro.kernels.syrk`): ``alpha·A·Aᵀ + beta·C0`` on the
``rank_update`` kernel with the SYRK body."""
from __future__ import annotations

from typing import Optional

import torch

from . import trigrid


def syrk_tiles(a: torch.Tensor, *, bm: int = 128,
               c0: Optional[torch.Tensor] = None, alpha: float = 1.0,
               beta: float = 0.0, out_dtype=torch.float32) -> torch.Tensor:
    """A (n1, n2) f32 -> packed lower-triangle tiles (T, bm, bm) of
    ``alpha·A·Aᵀ + beta·C0`` in ``out_dtype`` (f32 accumulation);
    n1 % bm == 0 (blas/api.py pads).  ``c0`` is read only when
    ``beta != 0``."""
    ep = trigrid.Epilogue(alpha=alpha, beta=beta,
                          accumulate=c0 is not None and beta != 0.0,
                          out_dtype=out_dtype)
    return trigrid.rank_update("syrk", a, bm=bm, epilogue=ep,
                               c0=c0 if ep.accumulate else None)
