"""Dense oracles for the symmetric kernels (port of
:mod:`repro.kernels.ref`); all compute in f32 on the lower triangle:

  syrk_ref  : C = tril(A·Aᵀ)
  syr2k_ref : C = tril(A·Bᵀ + B·Aᵀ)
  symm_ref  : C = sym(A)·B where only tril(A) is defined (upper mirrored)
"""
from __future__ import annotations

import torch


def syrk_ref(a: torch.Tensor) -> torch.Tensor:
    a32 = a.float()
    return torch.tril(a32 @ a32.T)


def syr2k_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a32, b32 = a.float(), b.float()
    g = a32 @ b32.T
    return torch.tril(g + g.T)


def symm_ref(a_tril: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a_tril: full (n1, n1) tensor whose upper triangle is ignored."""
    a32 = a_tril.float()
    sym = torch.tril(a32) + torch.tril(a32, -1).T
    return sym @ b.float()
