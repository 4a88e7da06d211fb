"""The two symmetric kernels' wrappers and their plain versions.

Port of :mod:`repro.kernels.trigrid`.  ``rank_update`` (SYRK / SYR2K
into packed lower-triangle tiles, fused epilogue) and ``sym_stream``
(packed-tile symmetric times dense) launch the hand-written CUDA kernels
of ``repro_torch/csrc`` on CUDA tensors and run their plain PyTorch
versions — the same function, the same packed tile layout — on CPU
tensors.  A CUDA tensor never falls back: the kernel launches or the
wrapper raises.

Each wrapper counts its launches in a plain integer attribute
(``rank_update.launches``, ``sym_stream.launches``), incremented only
where the kernel is launched, so a run can show that its path went
through the kernels (``kernels.counts`` reads and resets them).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.packing import tile_tril_coords
from . import native

KERNEL_BMS = (8, 16, 32, 64, 128)
OUT_DTYPES = (torch.float32, torch.bfloat16)


# --------------------------------------------------------------------------
# cached lookup tables (one numpy build per grid size, one copy per device)
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def tri_coords(nt: int) -> Tuple[np.ndarray, np.ndarray]:
    """(imap, jmap) int32 tile coordinates of the flat lower-triangle
    grid, row-major: packed tile t is (imap[t], jmap[t])."""
    coords = tile_tril_coords(nt)
    imap = np.ascontiguousarray(coords[:, 0], dtype=np.int32)
    jmap = np.ascontiguousarray(coords[:, 1], dtype=np.int32)
    imap.setflags(write=False)
    jmap.setflags(write=False)
    return imap, jmap


@functools.lru_cache(maxsize=None)
def symm_lookup(nt: int) -> Tuple[np.ndarray, np.ndarray]:
    """SYMM's packed-operand access tables over (i, k), flattened:
    ``flat`` = tri(max(i,k)) + min(i,k), ``mode`` 0 as stored,
    1 transposed, 2 diagonal (symmetrise from the lower half)."""
    i, k = np.meshgrid(np.arange(nt), np.arange(nt), indexing="ij")
    hi, lo = np.maximum(i, k), np.minimum(i, k)
    flat = (hi * (hi + 1) // 2 + lo).astype(np.int32).ravel()
    mode = np.where(i == k, 2, np.where(k > i, 1, 0)).astype(np.int32)
    mode = mode.ravel()
    flat.setflags(write=False)
    mode.setflags(write=False)
    return flat, mode


@functools.lru_cache(maxsize=None)
def _device_tables(kind: str, nt: int, device: str
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    pair = tri_coords(nt) if kind == "tri" else symm_lookup(nt)
    return tuple(torch.as_tensor(np.array(x), device=device) for x in pair)


# --------------------------------------------------------------------------
# fused epilogue
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Epilogue:
    """What happens to the f32 accumulator before the one store:
    ``out = mask_diag(alpha·acc + beta·C0)`` with the matrix diagonal
    scaled by ``diag_scale``, cast to ``out_dtype``.  ``accumulate``
    means a packed-tile C0 is read."""
    alpha: float = 1.0
    beta: float = 0.0
    accumulate: bool = False
    out_dtype: torch.dtype = torch.float32
    diag_scale: float = 1.0

    def apply(self, acc: torch.Tensor, c0: Optional[torch.Tensor],
              is_diag: torch.Tensor) -> torch.Tensor:
        """Plain version: acc (T, bm, bm) f32, is_diag (T,) bool."""
        bm = acc.shape[-1]
        if self.alpha != 1.0:
            acc = self.alpha * acc
        if self.accumulate:
            acc = acc + self.beta * c0.float()
        rows = torch.arange(bm, device=acc.device)[:, None]
        cols = torch.arange(bm, device=acc.device)[None, :]
        dg = is_diag[:, None, None]
        acc = torch.where(~dg | (rows >= cols), acc, torch.zeros_like(acc))
        if self.diag_scale != 1.0:
            acc = torch.where(dg & (rows == cols), self.diag_scale * acc,
                              acc)
        return acc.to(self.out_dtype)


def _check_operand(x: torch.Tensor, name: str) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_cuda(x: torch.Tensor, bm: int, out_dtype) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no kernel for device {x.device}")
    if x.device.type == "cuda":
        if bm not in KERNEL_BMS:
            raise ValueError(f"kernel tile bm={bm} not in {KERNEL_BMS}")
        if out_dtype not in OUT_DTYPES:
            raise TypeError(f"kernel output dtype {out_dtype} not in "
                            f"{OUT_DTYPES}")


def _stream(device: torch.device) -> int:
    # The current stream of the calling thread: the serving cache's
    # refresh runs on its executor thread, and its launches land on that
    # thread's current stream, like every torch op the refresh issues.
    return torch.cuda.current_stream(device).cuda_stream


# --------------------------------------------------------------------------
# rank update (SYRK / SYR2K) into packed lower-triangle tiles
# --------------------------------------------------------------------------
def _rank_update_plain(body: str, a: torch.Tensor, b: Optional[torch.Tensor],
                       bm: int, ep: Epilogue,
                       c0: Optional[torch.Tensor]) -> torch.Tensor:
    n1, n2 = a.shape
    nt = n1 // bm
    imap, jmap = (t.long() for t in _device_tables("tri", nt,
                                                   str(a.device)))
    ab = a.reshape(nt, bm, n2)
    acc = ab[imap] @ (ab[jmap] if body == "syrk"
                      else b.reshape(nt, bm, n2)[jmap]).transpose(1, 2)
    if body == "syr2k":
        acc = acc + b.reshape(nt, bm, n2)[imap] @ ab[jmap].transpose(1, 2)
    return ep.apply(acc, c0, imap == jmap)


def rank_update(body: str, a: torch.Tensor, b: Optional[torch.Tensor] = None,
                *, bm: int, epilogue: Optional[Epilogue] = None,
                c0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Symmetric rank update over the flat lower-triangle tile grid.

    ``body`` "syrk": Aᵢ·Aⱼᵀ; "syr2k": Aᵢ·Bⱼᵀ + Bᵢ·Aⱼᵀ, f32 accumulation
    for every packed tile t = (imap[t], jmap[t]).  ``a``/``b``: (n1, n2)
    f32, contiguous, n1 % bm == 0.  ``c0``: packed tiles (T, bm, bm) f32,
    read only when ``epilogue.accumulate``.  Returns packed tiles
    (T, bm, bm) in ``epilogue.out_dtype``, diagonal tiles lower-masked."""
    ep = epilogue or Epilogue()
    if body not in ("syrk", "syr2k"):
        raise ValueError(f"body must be 'syrk' or 'syr2k', got {body!r}")
    if body == "syr2k" and b is None:
        raise ValueError("syr2k needs b")
    n1, n2 = a.shape
    if n1 % bm:
        raise ValueError(f"n1={n1} is not a multiple of bm={bm}")
    _check_operand(a, "a")
    if b is not None:
        _check_operand(b, "b")
        if b.shape != a.shape or b.device != a.device:
            raise ValueError(f"b {tuple(b.shape)} on {b.device} does not "
                             f"match a {tuple(a.shape)} on {a.device}")
    nt = n1 // bm
    T = nt * (nt + 1) // 2
    if ep.accumulate:
        if c0 is None or tuple(c0.shape) != (T, bm, bm):
            raise ValueError(f"c0 must be ({T}, {bm}, {bm})")
        _check_operand(c0, "c0")
    _check_cuda(a, bm, ep.out_dtype)
    if a.device.type == "cpu":
        return _rank_update_plain(body, a, b, bm, ep, c0)

    fn = native.load()["repro_rank_update"]
    imap, jmap = _device_tables("tri", nt, str(a.device))
    out = torch.empty((T, bm, bm), dtype=ep.out_dtype, device=a.device)
    with torch.cuda.device(a.device):
        rc = fn(0 if body == "syrk" else 1, bm, a.data_ptr(),
                None if b is None else b.data_ptr(), n2, imap.data_ptr(),
                jmap.data_ptr(), T,
                c0.data_ptr() if ep.accumulate else None,
                ep.alpha, ep.beta if ep.accumulate else 0.0, ep.diag_scale,
                out.data_ptr(), int(ep.out_dtype == torch.bfloat16),
                _stream(a.device))
    native.check(rc, f"rank_update[{body}, bm={bm}]")
    native.count_launch(rank_update)
    return out


rank_update.launches = 0


# --------------------------------------------------------------------------
# packed-operand symmetric times dense (SYMM)
# --------------------------------------------------------------------------
def _effective_tiles(a_tiles: torch.Tensor, nt: int,
                    diag_scale: float = 1.0) -> torch.Tensor:
    """(nt, nt, bm, bm) tiles of sym_s(A) gathered through the lookup
    table: as stored, transposed, or symmetrised from the lower half
    with the diagonal scaled (the upper half of a diagonal tile is never
    read — ``where`` selects, it does not multiply)."""
    bm = a_tiles.shape[-1]
    flat, mode = (t.long() for t in _device_tables("symm", nt,
                                                   str(a_tiles.device)))
    a = a_tiles.float()[flat]                          # (nt*nt, bm, bm)
    at = a.transpose(1, 2)
    rows = torch.arange(bm, device=a.device)[:, None]
    cols = torch.arange(bm, device=a.device)[None, :]
    zero = torch.zeros((), device=a.device)
    a_diag = torch.where(rows >= cols, a, zero) \
        + torch.where(rows > cols, a, zero).transpose(1, 2)
    if diag_scale != 1.0:
        a_diag = a_diag + (diag_scale - 1.0) * torch.where(rows == cols, a,
                                                           zero)
    md = mode[:, None, None]
    eff = torch.where(md == 0, a, torch.where(md == 1, at, a_diag))
    return eff.reshape(nt, nt, bm, bm)


def _sym_stream_plain(a_tiles: torch.Tensor, b: torch.Tensor, nt: int,
                      diag_scale: float, out_dtype) -> torch.Tensor:
    bm = a_tiles.shape[-1]
    eff = _effective_tiles(a_tiles, nt, diag_scale)
    dense = eff.permute(0, 2, 1, 3).reshape(nt * bm, nt * bm)
    return (dense @ b).to(out_dtype)


def sym_stream(a_tiles: torch.Tensor, b: torch.Tensor, *, bm: int,
               out_dtype=torch.float32,
               diag_scale: float = 1.0) -> torch.Tensor:
    """C = sym_s(A)·B with A as packed lower-triangle tiles
    (T, bm, bm) f32 (diagonal tiles tril-valid: their upper halves are
    never read) and B (n1, n2) f32, n1 = nt·bm.  Returns (n1, n2) in
    ``out_dtype`` (f32 accumulation)."""
    n1, n2 = b.shape
    if n1 % bm:
        raise ValueError(f"n1={n1} is not a multiple of bm={bm}")
    nt = n1 // bm
    if tuple(a_tiles.shape) != (nt * (nt + 1) // 2, bm, bm):
        raise ValueError(f"a_tiles {tuple(a_tiles.shape)} does not match "
                         f"nt={nt}, bm={bm}")
    _check_operand(a_tiles, "a_tiles")
    _check_operand(b, "b")
    if a_tiles.device != b.device:
        raise ValueError("a_tiles and b must be on one device")
    _check_cuda(b, bm, out_dtype)
    if b.device.type == "cpu":
        return _sym_stream_plain(a_tiles, b, nt, diag_scale, out_dtype)

    fn = native.load()["repro_sym_stream"]
    flat, mode = _device_tables("symm", nt, str(b.device))
    out = torch.empty((n1, n2), dtype=out_dtype, device=b.device)
    with torch.cuda.device(b.device):
        rc = fn(bm, a_tiles.data_ptr(), b.data_ptr(), nt, n2,
                flat.data_ptr(), mode.data_ptr(), diag_scale,
                out.data_ptr(), int(out_dtype == torch.bfloat16),
                _stream(b.device))
    native.check(rc, f"sym_stream[bm={bm}]")
    native.count_launch(sym_stream)
    return out


sym_stream.launches = 0

