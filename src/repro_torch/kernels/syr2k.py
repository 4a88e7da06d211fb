"""SYR2K into packed lower-triangle tiles (port of
:mod:`repro.kernels.syr2k`): ``alpha·(A·Bᵀ + B·Aᵀ) + beta·C0`` on the
``rank_update`` kernel with the SYR2K body."""
from __future__ import annotations

from typing import Optional

import torch

from . import trigrid


def syr2k_tiles(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128,
                c0: Optional[torch.Tensor] = None, alpha: float = 1.0,
                beta: float = 0.0, out_dtype=torch.float32,
                diag_scale: float = 1.0) -> torch.Tensor:
    """A, B (n1, n2) f32 -> packed lower-triangle tiles (T, bm, bm) of
    ``alpha·(A·Bᵀ + B·Aᵀ) + beta·C0`` in ``out_dtype``; ``diag_scale``
    scales the matrix diagonal in the fused epilogue."""
    ep = trigrid.Epilogue(alpha=alpha, beta=beta,
                          accumulate=c0 is not None and beta != 0.0,
                          out_dtype=out_dtype, diag_scale=diag_scale)
    return trigrid.rank_update("syr2k", a, b, bm=bm, epilogue=ep,
                               c0=c0 if ep.accumulate else None)
