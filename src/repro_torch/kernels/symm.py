"""SYMM with the symmetric operand as packed lower-triangle tiles (port
of :mod:`repro.kernels.symm`), on the ``sym_stream`` kernel."""
from __future__ import annotations

import torch

from . import trigrid


def symm_tiles(a_packed: torch.Tensor, b: torch.Tensor, *, bm: int = 128,
               out_dtype=torch.float32,
               diag_scale: float = 1.0) -> torch.Tensor:
    """a_packed: (T, bm, bm) packed lower-triangle tiles of symmetric A
    (row-major, diagonal tiles tril-valid); b: (n1, n2).  Returns
    C = sym_s(A)·B (n1, n2) in ``out_dtype`` (f32 accumulation), the
    matrix diagonal of sym(A) scaled by ``diag_scale``."""
    return trigrid.sym_stream(a_packed, b, bm=bm, out_dtype=out_dtype,
                              diag_scale=diag_scale)
