"""Direct wrappers of the symmetric kernels (port of
:mod:`repro.kernels.ops`): fixed tiles, the dtype contract and dense
lower-triangular results that match :mod:`repro_torch.kernels.ref`.

The padding, tile packing and unpacking are those of the blas surface's
kernel executors (``blas/api.py``), called here with the given tiles
and no routing.  The kernels always accumulate in f32; ``out_dtype=None``
keeps the f32 result rather than casting to the input dtype.  Most
callers go through :mod:`repro_torch.blas`, which adds routing, batching
and autodiff.  On a CPU tensor the wrappers run the kernels' plain
versions.
"""
from __future__ import annotations

import torch

from ..blas.api import _rank_kernel, _symm_kernel


def _cast_out(x: torch.Tensor, out_dtype) -> torch.Tensor:
    return x if out_dtype is None else x.to(out_dtype)


def syrk(a: torch.Tensor, *, bm: int = 128, bk: int = 128,
         out_dtype=None) -> torch.Tensor:
    """C = tril(A·Aᵀ) on the ``rank_update`` kernel; f32 out by
    default."""
    out = _rank_kernel("syrk", a.float(), None, None, "tril", (bm, bk),
                       1.0, 0.0, torch.float32)
    return _cast_out(out, out_dtype)


def syr2k(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128,
          bk: int = 128, out_dtype=None) -> torch.Tensor:
    """C = tril(A·Bᵀ + B·Aᵀ); f32 out by default."""
    out = _rank_kernel("syr2k", a.float(), b.float(), None, "tril",
                       (bm, bk), 1.0, 0.0, torch.float32)
    return _cast_out(out, out_dtype)


def symm(a_tril: torch.Tensor, b: torch.Tensor, *, bm: int = 128,
         bn: int = 8, out_dtype=None) -> torch.Tensor:
    """C = sym(A)·B with only tril(A) read: A is packed into lower tiles
    first, so its upper half never reaches the kernel.  f32 out by
    default."""
    out = _symm_kernel(a_tril.float(), b.float(), (bm, bn), torch.float32)
    return _cast_out(out, out_dtype)
