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
through the kernels (``kernels.counts`` reads and resets them).  One
wrapper call counts one launch, also where it makes two CUDA launches
(``sym_stream`` at n2 <= ``NARROW_MAX_N2``: partials, then their sums).
A stack of matrices (leading dims) is one launch of either kernel,
except ``sym_stream`` at n2 <= ``NARROW_MAX_N2``, which launches (and
counts) once a matrix.

The kernels' output blocks are sized for the card, not by the packed
format ``bm``: the tables that map them onto the packed tiles
(:func:`rank_blocks`, :func:`symm_subtiles`) are built here, cached, and
copied to the device once per shape.  :func:`matmul_tf32` emulates the
kernels' 3xTF32 tensor-core arithmetic in plain PyTorch (tests and
``chip_smoke.py`` only).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.packing import tile_tril_coords
from . import native

KERNEL_BMS = (8, 16, 32, 64, 128)
OUT_DTYPES = (torch.float32, torch.bfloat16)
#: the contraction depth of one pipeline stage of both kernels (kBK in
#: csrc/tile_mma.cuh)
PANEL_K = 32
#: ``rank_update``'s output block side (kBO in csrc/rank_update.cu)
RANK_BLOCK = 64
#: ``sym_stream``'s output blocks (rows, columns), in order of preference
SYMM_BLOCKS = ((128, 128), (64, 64))
#: widest B that ``sym_stream`` multiplies with its matrix-vector kernel,
#: and the tile rows one of its blocks reads (kSlab in csrc/sym_stream.cu)
NARROW_MAX_N2 = 8
NARROW_SLAB = 32


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
def rank_blocks(nt: int, bm: int) -> np.ndarray:
    """``rank_update``'s block table for an (nt·bm)² lower triangle cut
    into bo × bo output blocks (bo = RANK_BLOCK): int32 rows (row0, col0),
    one per block (I, J) with I ≥ J.

    The kernel writes each element (r, c) of a block with r, c < n1 to
    packed tile (r // bm, c // bm) at (r % bm, c % bm) when
    r // bm ≥ c // bm.  Where bo < bm, a block with I > J inside one
    diagonal tile also stores the zeros of its mirror image (c, r): the
    strict upper half that no block computes."""
    n1, bo = nt * bm, RANK_BLOCK
    nb = -(-n1 // bo)
    rows = [(i * bo, j * bo) for i in range(nb) for j in range(i + 1)]
    out = np.ascontiguousarray(rows, dtype=np.int32).reshape(-1, 2)
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=None)
def symm_subtiles(nt: int, bm: int, rows: int) -> np.ndarray:
    """``sym_stream``'s sub-tile table for ``rows``-row output blocks:
    for each block I, each PANEL_K-deep contraction panel p and each
    h × w sub-tile (s, cs) of that panel (h = min(bm, rows),
    w = min(bm, PANEL_K)), the packed tile and mode from
    :func:`symm_lookup` as ``flat << 2 | mode``; mode 3 marks a sub-tile
    past the matrix edge (staged as zeros).  Shape (n_blocks, n_panels,
    rows // h, PANEL_K // w), int32."""
    n1 = nt * bm
    h, w = min(bm, rows), min(bm, PANEL_K)
    nb, npan = -(-n1 // rows), -(-n1 // PANEL_K)
    sr, sc = rows // h, PANEL_K // w
    flat, mode = symm_lookup(nt)
    ti = ((np.arange(nb)[:, None] * rows + np.arange(sr)[None, :] * h)
          // bm)[:, None, :, None]
    tk = ((np.arange(npan)[:, None] * PANEL_K + np.arange(sc)[None, :] * w)
          // bm)[None, :, None, :]
    ti, tk = np.broadcast_arrays(ti, tk)
    inside = (ti < nt) & (tk < nt)
    idx = np.where(inside, ti * nt + tk, 0)
    codes = np.where(inside, (flat[idx] << 2) | mode[idx], 3)
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    codes.setflags(write=False)
    return codes


@functools.lru_cache(maxsize=None)
def _device_tables(kind: str, nt: int, device: str, bm: int = 0,
                   rows: int = 0) -> Tuple[torch.Tensor, ...]:
    if kind == "tri":
        arrays = tri_coords(nt)
    elif kind == "symm":
        arrays = symm_lookup(nt)
    elif kind == "blocks":
        arrays = (rank_blocks(nt, bm),)
    else:
        arrays = (symm_subtiles(nt, bm, rows),)
    return tuple(torch.as_tensor(np.array(x), device=device) for x in arrays)


@functools.lru_cache(maxsize=None)
def _sm_count(device: str) -> int:
    return torch.cuda.get_device_properties(
        torch.device(device)).multi_processor_count


def symm_block(n1: int, n2: int, sms: int) -> Tuple[int, int]:
    """``sym_stream``'s output block (rows, columns) for C (n1, n2) on a
    card with ``sms`` SMs: the first of SYMM_BLOCKS whose blocks fill a
    wave of the SMs, else the last."""
    for rows, cols in SYMM_BLOCKS:
        if -(-n1 // rows) * -(-n2 // cols) >= sms:
            return rows, cols
    return SYMM_BLOCKS[-1]


# --------------------------------------------------------------------------
# the kernels' tensor-core arithmetic, emulated (tests, chip_smoke.py)
# --------------------------------------------------------------------------
def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 explicit mantissa bits), ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds, by the kernels' own
    bit operation (``rna_tf32`` in csrc/tile_mma.cuh): add half an ulp,
    clear the low 13 bits.  A NaN may come out as a number (0x7FFFFFFF
    as -0); :func:`matmul_tf32` keeps it in the small part."""
    x = x.float().contiguous()
    u = x.view(torch.int32).long() & 0xFFFFFFFF          # as uint32
    bits = (u + 0x1000) & 0xFFFFE000
    bits = bits - ((bits >> 31) << 32)                   # back to int32
    return bits.to(torch.int32).view(torch.float32)


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """The TF32 value the tensor cores read from an f32 operand: its top
    19 bits (the low 13 cleared, toward zero).  A quiet NaN, which every
    NaN-making f32 operation yields, stays a NaN."""
    bits = x.float().contiguous().view(torch.int32) & -0x2000
    return bits.view(torch.float32)


def matmul_tf32(a: torch.Tensor, b: torch.Tensor,
                passes: int = 3) -> torch.Tensor:
    """a @ b as the kernels' tensor cores compute it, in IEEE f32
    products and sums: ``passes=3`` splits each operand into
    big = tf32(x), rounded, and small = x − big, which the tensor cores
    truncate (a NaN x makes small NaN, whatever big became), and adds
    small·big′ + big·small′ + big·big′ (3xTF32);
    ``passes=1`` is one TF32 product, tf32(a)·tf32(b), which the port
    does not use."""
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    a_big, b_big = tf32_round(a), tf32_round(b)
    if passes == 1:
        return a_big @ b_big
    a_small, b_small = tf32_truncate(a - a_big), tf32_truncate(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


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


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x itself when its data is 16 B-aligned (the kernels' cp.async and
    float4 loads need it), else a fresh copy, which is."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _on(device: torch.device):
    """The device's context, or none when it is already current (the
    common case: entering a device context costs host time per call)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


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
    """The same function in plain PyTorch: the product in IEEE f32, then
    its lower tiles gathered (packed), then the epilogue.  ``a``/``b``
    (..., n1, n2), ``c0`` (..., T, bm, bm)."""
    n1 = a.shape[-2]
    nt = n1 // bm
    imap, jmap = (t.long() for t in _device_tables("tri", nt,
                                                   str(a.device)))
    g = a @ (a if body == "syrk" else b).transpose(-1, -2)
    if body == "syr2k":
        g = g + b @ a.transpose(-1, -2)
    grid = g.reshape(g.shape[:-2] + (nt, bm, nt, bm)).transpose(-3, -2)
    acc = grid[..., imap, jmap, :, :]
    return ep.apply(acc, c0, imap == jmap)


def rank_update(body: str, a: torch.Tensor, b: Optional[torch.Tensor] = None,
                *, bm: int, epilogue: Optional[Epilogue] = None,
                c0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Symmetric rank update over the flat lower-triangle tile grid.

    ``body`` "syrk": Aᵢ·Aⱼᵀ; "syr2k": Aᵢ·Bⱼᵀ + Bᵢ·Aⱼᵀ, f32 accumulation
    for every packed tile t = (imap[t], jmap[t]).  ``a``/``b``:
    (..., n1, n2) f32, contiguous, n1 % bm == 0; leading dims are a
    stack of matrices, one launch for all of them.  ``c0``: packed tiles
    (..., T, bm, bm) f32, read only when ``epilogue.accumulate``.
    Returns packed tiles (..., T, bm, bm) in ``epilogue.out_dtype``,
    diagonal tiles lower-masked."""
    ep = epilogue or Epilogue()
    if body not in ("syrk", "syr2k"):
        raise ValueError(f"body must be 'syrk' or 'syr2k', got {body!r}")
    if body == "syr2k" and b is None:
        raise ValueError("syr2k needs b")
    if a.ndim < 2:
        raise ValueError(f"a must be (..., n1, n2), got {tuple(a.shape)}")
    lead = tuple(a.shape[:-2])
    n1, n2 = a.shape[-2:]
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
        if c0 is None or tuple(c0.shape) != lead + (T, bm, bm):
            raise ValueError(f"c0 must be {lead + (T, bm, bm)}")
        _check_operand(c0, "c0")
    _check_cuda(a, bm, ep.out_dtype)
    if a.device.type == "cpu":
        return _rank_update_plain(body, a, b, bm, ep, c0)

    k = math.prod(lead)
    out = torch.empty(lead + (T, bm, bm), dtype=ep.out_dtype,
                      device=a.device)
    if k == 0:
        return out
    fn = native.load()["repro_rank_update"]
    blocks, = _device_tables("blocks", nt, str(a.device), bm)
    with _on(a.device):
        rc = fn(0 if body == "syrk" else 1, bm, a.data_ptr(),
                None if b is None else b.data_ptr(), n1, n2, k,
                blocks.data_ptr(), blocks.shape[0],
                c0.data_ptr() if ep.accumulate else None,
                ep.alpha, ep.beta if ep.accumulate else 0.0, ep.diag_scale,
                out.data_ptr(), int(ep.out_dtype == torch.bfloat16),
                _stream(a.device))
    native.check(rc, f"rank_update[{body}, bm={bm}, batch={k}]")
    native.count_launch(rank_update)
    return out


rank_update.launches = 0


# --------------------------------------------------------------------------
# packed-operand symmetric times dense (SYMM)
# --------------------------------------------------------------------------
def _effective_tiles(a_tiles: torch.Tensor, nt: int,
                     diag_scale: float = 1.0) -> torch.Tensor:
    """(..., nt, nt, bm, bm) tiles of sym_s(A) gathered through the
    lookup table: as stored, transposed, or symmetrised from the lower
    half with the diagonal scaled (the upper half of a diagonal tile is
    never read — ``where`` selects, it does not multiply)."""
    bm = a_tiles.shape[-1]
    flat, mode = (t.long() for t in _device_tables("symm", nt,
                                                   str(a_tiles.device)))
    a = a_tiles.float()[..., flat, :, :]               # (..., nt*nt, bm, bm)
    at = a.transpose(-1, -2)
    rows = torch.arange(bm, device=a.device)[:, None]
    cols = torch.arange(bm, device=a.device)[None, :]
    zero = torch.zeros((), device=a.device)
    a_diag = torch.where(rows >= cols, a, zero) \
        + torch.where(rows > cols, a, zero).transpose(-1, -2)
    if diag_scale != 1.0:
        a_diag = a_diag + (diag_scale - 1.0) * torch.where(rows == cols, a,
                                                           zero)
    md = mode[:, None, None]
    eff = torch.where(md == 0, a, torch.where(md == 1, at, a_diag))
    return eff.reshape(a.shape[:-3] + (nt, nt, bm, bm))


def _sym_stream_plain(a_tiles: torch.Tensor, b: torch.Tensor, nt: int,
                      diag_scale: float, out_dtype) -> torch.Tensor:
    bm = a_tiles.shape[-1]
    eff = _effective_tiles(a_tiles, nt, diag_scale)
    dense = eff.transpose(-3, -2).reshape(eff.shape[:-4]
                                          + (nt * bm, nt * bm))
    return (dense @ b).to(out_dtype)


def sym_stream(a_tiles: torch.Tensor, b: torch.Tensor, *, bm: int,
               out_dtype=torch.float32,
               diag_scale: float = 1.0) -> torch.Tensor:
    """C = sym_s(A)·B with A as packed lower-triangle tiles
    (..., T, bm, bm) f32 (diagonal tiles tril-valid: their upper halves
    never reach the result) and B (..., n1, n2) f32, n1 = nt·bm, with
    the same leading dims: a stack of products, one launch on the
    tensor-core kernel.  Returns (..., n1, n2) in ``out_dtype`` (f32
    accumulation).  On the card, n2 <= 8 runs the matrix-vector kernel
    (one matrix a launch, looped over a stack), wider B the tensor-core
    kernel."""
    if b.ndim < 2:
        raise ValueError(f"b must be (..., n1, n2), got {tuple(b.shape)}")
    lead = tuple(b.shape[:-2])
    n1, n2 = b.shape[-2:]
    if n1 % bm:
        raise ValueError(f"n1={n1} is not a multiple of bm={bm}")
    nt = n1 // bm
    if tuple(a_tiles.shape) != lead + (nt * (nt + 1) // 2, bm, bm):
        raise ValueError(f"a_tiles {tuple(a_tiles.shape)} does not match "
                         f"b {tuple(b.shape)} with nt={nt}, bm={bm}")
    _check_operand(a_tiles, "a_tiles")
    _check_operand(b, "b")
    if a_tiles.device != b.device:
        raise ValueError("a_tiles and b must be on one device")
    _check_cuda(b, bm, out_dtype)
    if b.device.type == "cpu":
        return _sym_stream_plain(a_tiles, b, nt, diag_scale, out_dtype)

    k = math.prod(lead)
    out = torch.empty(lead + (n1, n2), dtype=out_dtype, device=b.device)
    if k == 0:
        return out
    funcs = native.load()
    dev = str(b.device)
    a_tiles = _aligned(a_tiles)
    bf16 = int(out_dtype == torch.bfloat16)
    with _on(b.device):
        if n2 <= NARROW_MAX_N2:
            imap, jmap = _device_tables("tri", nt, dev)
            slabs = bm // min(bm, NARROW_SLAB)    # U, then V per slab
            part = torch.empty((a_tiles.shape[-3], 1 + slabs, bm, n2),
                               dtype=torch.float32, device=b.device)
            # one matrix a launch: step the pointers through the stack
            step_a = a_tiles.shape[-3] * bm * bm * 4
            step_b, step_o = n1 * n2 * 4, n1 * n2 * out.element_size()
            for z in range(k):
                rc = funcs["repro_sym_stream_narrow"](
                    bm, a_tiles.data_ptr() + z * step_a,
                    b.data_ptr() + z * step_b, nt, n2, imap.data_ptr(),
                    jmap.data_ptr(), diag_scale, part.data_ptr(),
                    out.data_ptr() + z * step_o, bf16, _stream(b.device))
                native.check(rc, f"sym_stream[bm={bm}, n2={n2}]")
                native.count_launch(sym_stream)
            return out
        rows, cols = symm_block(n1, n2, _sm_count(dev))
        sub, = _device_tables("subtiles", nt, dev, bm, rows)
        rc = funcs["repro_sym_stream"](
            bm, rows, cols, a_tiles.data_ptr(), b.data_ptr(), nt, n2, k,
            sub.data_ptr(), diag_scale, out.data_ptr(), bf16,
            _stream(b.device))
    native.check(rc, f"sym_stream[bm={bm}, n2={n2}, batch={k}]")
    native.count_launch(sym_stream)
    return out


sym_stream.launches = 0

