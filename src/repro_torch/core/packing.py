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


# ---- ShardedTriTiles: the packed mesh wire format -------------------------
@dataclasses.dataclass(frozen=True)
class ShardedTriTiles:
    """Per-device extended-triangle-block shards of a symmetric matrix:
    the wire format of the 2d / 3d mesh schedules (paper Algs 10–15).

    The affine-plane partition gives every block pair of the c²-block
    row grid to exactly one of P = c(c+1) devices: device k holds the
    T = c(c−1)/2 off-diagonal blocks ``off[k]`` (pairs i > j ∈ R_k) and
    one lower-triangular diagonal block ``diag[k]`` (zeros when it owns
    none), ~n²/(2P) words each.

    Two forms.  Global (``mesh`` None): ``off`` (…, P, T, nb, nb) and
    ``diag`` (…, P, nb, nb), every device's shard, as the reference's
    global arrays hold them.  Local (``mesh`` and ``axis`` set): ``off``
    (…, T, nb, nb) and ``diag`` (…, nb, nb) are the shard of this rank's
    device k of the axis's grid (rank r of a p1·p2 axis holds k = r // p2,
    the p2 ranks of a 3d slice holding the same shard): what a
    ``fill="sharded"`` mesh call returns, no gather made.  Its packed and
    dense exits all-gather the shards first (:meth:`gather`).  Leading
    batch dims pass through every converter; nothing but the explicit
    ``to_tril`` / ``to_full`` exits builds an n × n dense array.
    """
    off: torch.Tensor
    diag: torch.Tensor
    n: int
    c: int
    mesh: object = None
    axis: Optional[str] = None

    @property
    def num_devices(self) -> int:
        return self.c * (self.c + 1)

    @property
    def T(self) -> int:
        return self.c * (self.c - 1) // 2

    @property
    def nb(self) -> int:
        return -(-self.n // (self.c * self.c))

    @property
    def dtype(self):
        return self.diag.dtype

    @property
    def local(self) -> bool:
        return self.mesh is not None

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        return tuple(self.diag.shape[:-2 if self.local else -3])

    def __post_init__(self):
        T, nb, P = self.T, self.nb, self.num_devices
        dev = () if self.local else (P,)
        want_off, want_diag = dev + (T, nb, nb), dev + (nb, nb)
        k = len(want_off)
        off, diag = tuple(self.off.shape), tuple(self.diag.shape)
        if (off[-k:] != want_off or diag[-(k - 1):] != want_diag
                or off[:-k] != diag[:-(k - 1)]):
            raise ValueError(
                f"ShardedTriTiles(n={self.n}, c={self.c}"
                f"{', local' if self.local else ''}) needs off (…,) + "
                f"{want_off} and diag (…,) + {want_diag} with matching "
                f"batch dims, got {off} and {diag}")
        if self.local and self.axis is None:
            raise ValueError("a local ShardedTriTiles needs its mesh axis")

    def to(self, dtype) -> "ShardedTriTiles":
        return ShardedTriTiles(self.off.to(dtype), self.diag.to(dtype),
                               self.n, self.c, self.mesh, self.axis)

    def _grid(self):
        P, p1 = self.mesh.shape[self.axis], self.num_devices
        return self.mesh.grid(self.axis, p1, P // p1)

    def shard_index(self) -> int:
        """The device k whose shard this rank holds (local form)."""
        return _grid_index(self.mesh, self.axis, self.c)

    def gather(self) -> "ShardedTriTiles":
        """Local form -> global: one all-gather of the shards over the
        grid's tb axis, counted as a replication (the global form is
        returned as it is)."""
        if not self.local:
            return self
        from ..distributed import collectives
        tb, _ = self._grid()
        lead = self.batch_shape
        flat = torch.cat([self.off.reshape(lead + (-1,)),
                          self.diag.reshape(lead + (-1,))], -1)
        flat = flat.reshape((-1, flat.shape[-1])).T.contiguous()
        allf = collectives.all_gather(flat[None], tb,
                                      collectives.REPLICATE)  # (P, F, K)
        allf = allf.permute(2, 0, 1).reshape(lead + allf.shape[:2])
        t = self.T * self.nb * self.nb
        P = self.num_devices
        off = allf[..., :t].reshape(lead + (P, self.T, self.nb, self.nb))
        diag = allf[..., t:].reshape(lead + (P, self.nb, self.nb))
        return ShardedTriTiles(off, diag, self.n, self.c)

    # -- packed exits / entrances (block-granular, never dense) ------------
    def to_packed(self) -> torch.Tensor:
        """(…, tril_size(n)) element-packed triangle: one take over the
        block axis (the device-slot -> grid-block bijection), then the
        tile gather."""
        if self.local:
            return self.gather().to_packed()
        from .twodim import tb_block_tables
        src, _ = tb_block_tables(self.c)
        Pn, T, nb = self.num_devices, self.T, self.nb
        stack = torch.cat([self.off, self.diag[..., :, None, :, :]], dim=-3)
        stack = stack.reshape(stack.shape[:-4] + (Pn * (T + 1), nb, nb))
        idx = torch.as_tensor(np.array(src, dtype=np.int64),
                              device=stack.device)
        return tiles_to_packed(stack[..., idx, :, :], self.n)

    @classmethod
    def from_packed(cls, p: torch.Tensor, n: int, c: int, mesh=None,
                    axis: Optional[str] = None) -> "ShardedTriTiles":
        """Element-packed (…, tril_size(n)) -> shards: every device's
        (global form), or with ``mesh`` / ``axis`` only this rank's
        (:func:`packed_to_device_shard`, no communication)."""
        if p.shape[-1] != tril_size(n):
            raise ValueError(f"packed length {p.shape[-1]} != "
                             f"tril_size({n})")
        if mesh is not None:
            k = _grid_index(mesh, axis, c)
            off, diag = packed_to_device_shard(p, n, c, k)
            return cls(off, diag, n, c, mesh, axis)
        from .twodim import tb_block_tables
        _, dst = tb_block_tables(c)
        Pn, T = c * (c + 1), c * (c - 1) // 2
        nb = -(-n // (c * c))
        blocks = packed_to_tiles(p, n, nb, nt=c * c)
        stack = torch.cat([blocks, blocks.new_zeros(blocks.shape[:-3]
                                                    + (1, nb, nb))], dim=-3)
        idx = torch.as_tensor(np.array(dst, dtype=np.int64).reshape(-1),
                              device=p.device)
        sel = stack[..., idx, :, :]
        sel = sel.reshape(sel.shape[:-3] + (Pn, T + 1, nb, nb))
        return cls(sel[..., :T, :, :], sel[..., T, :, :], n, c)

    def to_tritiles(self, bm: int = 128) -> TriTiles:
        return TriTiles.from_packed(self.to_packed(), self.n, bm)

    @classmethod
    def from_tritiles(cls, t: TriTiles, c: int) -> "ShardedTriTiles":
        return cls.from_packed(t.to_packed(), t.n, c)

    # -- dense exits / entrances -------------------------------------------
    @classmethod
    def from_tril(cls, x: torch.Tensor, c: int) -> "ShardedTriTiles":
        """Dense tril-valid (…, n, n) -> shards (lower triangle read)."""
        return cls.from_packed(pack_tril(x), x.shape[-1], c)

    def to_tril(self) -> torch.Tensor:
        return unpack_tril(self.to_packed(), self.n, diag=True,
                           symmetric=False)

    def to_full(self) -> torch.Tensor:
        return unpack_tril(self.to_packed(), self.n, diag=True,
                           symmetric=True)


def _grid_index(mesh, axis: str, c: int) -> int:
    """Device k of the c(c+1) grid at this rank: r // p2 for rank r of a
    p1·p2 axis."""
    P, p1 = mesh.shape[axis], c * (c + 1)
    if P % p1:
        raise ValueError(f"axis {axis!r} of size {P} holds no c={c} "
                         "triangle grid")
    return mesh.index(axis) // (P // p1)


def packed_to_device_shard(p: torch.Tensor, n: int, c: int, k: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Element-packed (…, tril_size(n)) -> device ``k``'s extended
    triangle block ``(off (…, T, nb, nb), diag (…, nb, nb))`` and only
    that: (T+1)·nb contiguous width-nb row slices of the packed vector
    (:func:`~repro_torch.core.twodim.tb_device_row_starts`) and one mask.
    Bit for bit ``ShardedTriTiles.from_packed(p, n, c).off[k]`` /
    ``.diag[k]``."""
    from .twodim import tb_device_row_starts
    if p.shape[-1] != tril_size(n):
        raise ValueError(f"packed length {p.shape[-1]} != tril_size({n})")
    starts, is_diag, valid = tb_device_row_starts(c, n, k)
    Tslots, nb = starts.shape
    lpad = tril_size(c * c * nb)
    u = np.arange(nb)
    keep = valid[:, None, None] & (~is_diag[:, None, None]
                                   | (u[:, None] >= u[None, :])[None])
    idx = (starts.astype(np.int64)[:, :, None] + u[None, None, :])
    dev = p.device
    pv = torch.nn.functional.pad(p, (0, lpad - p.shape[-1]))
    blocks = pv[..., torch.as_tensor(idx, device=dev)]
    blocks = torch.where(torch.as_tensor(keep, device=dev), blocks,
                         blocks.new_zeros(()))
    return blocks[..., :Tslots - 1, :, :], blocks[..., Tslots - 1, :, :]
