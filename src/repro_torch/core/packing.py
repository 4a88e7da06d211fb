"""Packed lower-triangle storage (port of :mod:`repro.core.packing`).

Element packing is row-major over the lower triangle including the
diagonal; tile packing keeps the lower triangle of a (bm, bm) tile grid,
each tile dense, row-major over tiles — the layout the Hopper kernels
read and write.  Every converter only moves data (gathers and scatters
through cached index tables, plus the reference's own masks and
mirror-adds), so the results are bit-for-bit those of the reference,
ragged n included.

Index tables are built once per shape with numpy and cached per device,
so a converter on the GPU costs one gather and no host transfer after
its first call.  Leading batch dims pass through every converter.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch


def tril_size(n: int, diag: bool = True) -> int:
    return n * (n + 1) // 2 if diag else n * (n - 1) // 2


def pad2d(x: torch.Tensor, m0: int, m1: int) -> torch.Tensor:
    """Zero-pad the last two dims up to multiples of (m0, m1)."""
    p0 = -x.shape[-2] % m0
    p1 = -x.shape[-1] % m1
    if p0 or p1:
        x = torch.nn.functional.pad(x, (0, p1, 0, p0))
    return x


@functools.lru_cache(maxsize=None)
def tril_row_starts(n: int, diag: bool = True) -> np.ndarray:
    """(n,) int32 packed offset of each matrix row: r(r+1)/2 (r(r−1)/2
    without the diagonal)."""
    r = np.arange(n, dtype=np.int64)
    out = (r * (r + 1) // 2 if diag else r * (r - 1) // 2).astype(np.int32)
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=None)
def _device_table(key: tuple, device: str) -> torch.Tensor:
    """A numpy index table from :data:`_TABLES` as an int64 tensor on
    ``device``, cached so repeated conversions skip the host copy."""
    kind, args = key[0], key[1:]
    table = np.array(_TABLES[kind](*args))
    return torch.as_tensor(table, dtype=torch.int64, device=device)


def _table(device: torch.device, kind: str, *args) -> torch.Tensor:
    return _device_table((kind,) + args, str(device))


def _tril_ij(n: int, diag: bool) -> np.ndarray:
    r, c = np.tril_indices(n, 0 if diag else -1)
    return np.stack([r, c])


def pack_tril(x: torch.Tensor, diag: bool = True) -> torch.Tensor:
    """(…, n, n) -> (…, n(n±1)/2) packed lower triangle.  Only the lower
    triangle is read (the upper half may hold garbage, NaN included)."""
    n = x.shape[-1]
    if tril_size(n, diag) == 0:
        return x.new_zeros(x.shape[:-2] + (0,))
    rc = _table(x.device, "tril_ij", n, diag)
    return x[..., rc[0], rc[1]]


def unpack_tril(p: torch.Tensor, n: int, diag: bool = True,
                symmetric: bool = True) -> torch.Tensor:
    """Packed (…, n(n±1)/2) -> full (…, n, n); mirrors into the upper
    triangle when ``symmetric`` (diagonal kept, off-diagonal added to
    its structural-zero mirror, as the reference does)."""
    if p.shape[-1] != tril_size(n, diag):
        raise ValueError(f"packed length {p.shape[-1]} != tril_size({n})")
    out = p.new_zeros(p.shape[:-1] + (n, n))
    if tril_size(n, diag) == 0:
        return out
    rc = _table(p.device, "tril_ij", n, diag)
    out[..., rc[0], rc[1]] = p
    if symmetric:
        mirror = out.transpose(-1, -2)
        if diag:
            eye = torch.eye(n, dtype=torch.bool, device=p.device)
            out = torch.where(eye, out, out + mirror)
        else:
            out = out + mirror
    return out


# ---- tile-granular packing -------------------------------------------------
@functools.lru_cache(maxsize=None)
def tile_tril_coords(nt: int) -> np.ndarray:
    """(T, 2) int64 (i, j) tile coords, row-major lower triangle."""
    out = [(i, j) for i in range(nt) for j in range(i + 1)]
    arr = np.array(out, dtype=np.int64).reshape(-1, 2)
    arr.setflags(write=False)
    return arr


def _coords(nt: int) -> np.ndarray:
    return tile_tril_coords(nt).T


def pack_tril_tiles(x: torch.Tensor, tile: int) -> torch.Tensor:
    """(…, n, n) -> (…, T, tile, tile): the dense tiles of the lower
    triangle of the tile grid (diagonal tiles kept dense)."""
    n = x.shape[-1]
    if n % tile:
        raise ValueError(f"n={n} is not a multiple of tile={tile}")
    nt = n // tile
    xt = x.reshape(x.shape[:-2] + (nt, tile, nt, tile)).movedim(-2, -3)
    ij = _table(x.device, "coords", nt)
    return xt[..., ij[0], ij[1], :, :]


@functools.lru_cache(maxsize=None)
def packed_tile_indices(n: int, bm: int
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Element l of the row-major packed triangle lives at
    ``tiles[tidx[l], ridx[l], cidx[l]]`` of the ceil(n/bm) tile grid."""
    i, j = np.tril_indices(n)
    ti, tj = i // bm, j // bm
    tidx = (ti * (ti + 1) // 2 + tj).astype(np.int32)
    ridx = (i % bm).astype(np.int32)
    cidx = (j % bm).astype(np.int32)
    for arr in (tidx, ridx, cidx):
        arr.setflags(write=False)
    return tidx, ridx, cidx


def _packed_to_tiles_index(n: int, bm: int, nt: int) -> np.ndarray:
    """(T, bm, bm) packed offset of every tile slot; slots outside the
    packed triangle (diagonal-tile upper halves, rows ≥ n) point at the
    appended zero at offset tril_size(n)."""
    coords = tile_tril_coords(nt)
    u = np.arange(bm, dtype=np.int64)
    r = coords[:, 0, None, None] * bm + u[None, :, None]
    c = coords[:, 1, None, None] * bm + u[None, None, :]
    idx = r * (r + 1) // 2 + c
    return np.where((c <= r) & (r < n), idx, tril_size(n))


def _tiles_to_packed_index(n: int, bm: int) -> np.ndarray:
    tidx, ridx, cidx = packed_tile_indices(n, bm)
    return (tidx.astype(np.int64) * bm + ridx) * bm + cidx


def packed_to_tiles(p: torch.Tensor, n: int, bm: int,
                    nt: Optional[int] = None) -> torch.Tensor:
    """Element-packed (…, tril_size(n)) -> tile-packed (…, T, bm, bm)
    over an ``nt``-tile grid (default ceil(n/bm); padding slots zero)."""
    if p.shape[-1] != tril_size(n):
        raise ValueError(f"packed length {p.shape[-1]} != tril_size({n})")
    if nt is None:
        nt = -(-n // bm)
    if nt * bm < n:
        raise ValueError(f"grid {nt}x{bm} does not cover n={n}")
    idx = _table(p.device, "p2t", n, bm, nt)
    pz = torch.cat([p, p.new_zeros(p.shape[:-1] + (1,))], dim=-1)
    return pz[..., idx]


def _grid_side(T: int) -> int:
    nt = int((np.sqrt(8 * T + 1) - 1) // 2)
    if nt * (nt + 1) // 2 != T:
        raise ValueError(f"{T} is not a triangle number")
    return nt


def tiles_to_packed(tiles: torch.Tensor, n: int) -> torch.Tensor:
    """Tile-packed (…, T, bm, bm) -> element-packed (…, tril_size(n))."""
    T, bm = tiles.shape[-3], tiles.shape[-1]
    if _grid_side(T) * bm < n:
        raise ValueError(f"{T} tiles of {bm} do not cover n={n}")
    idx = _table(tiles.device, "t2p", n, bm)
    return tiles.reshape(tiles.shape[:-3] + (-1,))[..., idx]


def unpack_tril_tiles(p: torch.Tensor, n: int, tile: int,
                      symmetric: bool = True) -> torch.Tensor:
    """(…, T, tile, tile) -> full (…, n, n) (n a multiple of tile)."""
    nt = n // tile
    lead = p.shape[:-3]
    full = p.new_zeros(lead + (nt, nt, tile, tile))
    ij = _table(p.device, "coords", nt)
    full[..., ij[0], ij[1], :, :] = p
    if symmetric:
        mirrored = full.transpose(-4, -3).transpose(-2, -1)
        ii = torch.arange(nt, device=p.device)
        lower = (ii[:, None] >= ii[None, :])[..., None, None]
        full = torch.where(lower, full, mirrored)
        diag_tiles = full[..., ii, ii, :, :]
        sym = torch.tril(diag_tiles) \
            + torch.tril(diag_tiles, -1).transpose(-1, -2)
        full[..., ii, ii, :, :] = sym
    return full.movedim(-3, -2).reshape(lead + (n, n))


_TABLES = {
    "tril_ij": _tril_ij,
    "coords": _coords,
    "p2t": _packed_to_tiles_index,
    "t2p": _tiles_to_packed_index,
}


# ---- PackedTriangle: the typed element-packed format ----------------------
@dataclasses.dataclass(frozen=True)
class PackedTriangle:
    """Element-packed lower triangle ``vec`` (…, n(n+1)/2) plus its
    logical dimension ``n`` (Gram EMAs, whitening caches)."""
    vec: torch.Tensor
    n: int

    def __post_init__(self):
        if self.vec.shape[-1] != tril_size(self.n):
            raise ValueError(f"PackedTriangle(n={self.n}) needs trailing "
                             f"length {tril_size(self.n)}, got "
                             f"{self.vec.shape[-1]}")

    @property
    def dtype(self):
        return self.vec.dtype

    def to(self, dtype) -> "PackedTriangle":
        return PackedTriangle(self.vec.to(dtype), self.n)

    @classmethod
    def from_dense(cls, x: torch.Tensor) -> "PackedTriangle":
        return cls(pack_tril(x), x.shape[-1])

    def to_dense(self, symmetric: bool = True) -> torch.Tensor:
        return unpack_tril(self.vec, self.n, diag=True, symmetric=symmetric)

    def to_tritiles(self, bm: int = 128) -> "TriTiles":
        return TriTiles.from_packed(self.vec, self.n, bm)


# ---- TriTiles: the kernels' packed-triangular interchange format ----------
@dataclasses.dataclass(frozen=True)
class TriTiles:
    """Tile-packed lower-triangular storage: ``tiles`` (…, T, bm, bm),
    the dense (bm, bm) tiles of the lower triangle of a ceil(n/bm)² tile
    grid, row-major; diagonal tiles lower-triangular (upper halves are
    structural zeros); padding slots zero."""
    tiles: torch.Tensor
    n: int
    bm: int

    @property
    def nt(self) -> int:
        return -(-self.n // self.bm)

    @property
    def num_tiles(self) -> int:
        return self.nt * (self.nt + 1) // 2

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        return tuple(self.tiles.shape[:-3])

    @property
    def dtype(self):
        return self.tiles.dtype

    def __post_init__(self):
        want = (self.num_tiles, self.bm, self.bm)
        if tuple(self.tiles.shape[-3:]) != want:
            raise ValueError(f"TriTiles(n={self.n}, bm={self.bm}) needs "
                             f"trailing tile shape {want}, got "
                             f"{tuple(self.tiles.shape[-3:])}")

    def to(self, dtype) -> "TriTiles":
        return TriTiles(self.tiles.to(dtype), self.n, self.bm)

    @classmethod
    def from_tril(cls, x: torch.Tensor, bm: int) -> "TriTiles":
        """Dense tril-valid (…, n, n) -> TriTiles; only the lower
        triangle is read (``where``, not a multiply: the unread upper
        half may hold NaN)."""
        n = x.shape[-1]
        tiles = pack_tril_tiles(pad2d(x, bm, bm), bm)
        ii = torch.arange(-(-n // bm), device=x.device)
        rows = torch.arange(bm, device=x.device)
        tril_mask = rows[:, None] >= rows[None, :]
        slots = ii * (ii + 3) // 2
        diag = tiles[..., slots, :, :]
        tiles[..., slots, :, :] = torch.where(tril_mask, diag,
                                              torch.zeros_like(diag))
        return cls(tiles, n, bm)

    @classmethod
    def from_packed(cls, p: torch.Tensor, n: int, bm: int) -> "TriTiles":
        return cls(packed_to_tiles(p, n, bm), n, bm)

    def to_packed(self) -> torch.Tensor:
        return tiles_to_packed(self.tiles, self.n)

    def to_tril(self) -> torch.Tensor:
        dense = unpack_tril_tiles(self.tiles, self.nt * self.bm, self.bm,
                                  symmetric=False)
        return dense[..., :self.n, :self.n]

    def to_full(self) -> torch.Tensor:
        dense = unpack_tril_tiles(self.tiles, self.nt * self.bm, self.bm,
                                  symmetric=True)
        return dense[..., :self.n, :self.n]
