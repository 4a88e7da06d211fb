"""Int8 gradient compression with error feedback, packed-native for
symmetric state (port of :mod:`repro.distributed.compression`).

A data-parallel all-reduce of f32 gradients moves 4 bytes a parameter
a step.  Block-wise int8 with one f32 scale a block moves 1 + 4/block
bytes (1.016 at block 256), and error feedback carries each step's
quantization residual into the next, so the sum of the compressed
gradients follows the sum of the true ones.

  * :class:`ErrorFeedbackInt8` — the gradient transform the trainer runs
    between clipping and the optimizer (``--compress-grads``).  A leaf
    marked in ``sym_mask`` (a dense symmetric (…, n, n) leaf) quantizes
    its packed lower triangle and keeps its residual packed; a typed
    packed leaf (:class:`~repro_torch.core.packing.PackedTriangle`,
    ``TriTiles``, ``ShardedTriTiles``) compresses its component arrays
    and comes back as the same type.
  * :func:`compressed_allreduce` — the explicit DP collective on one
    :class:`~repro_torch.distributed.mesh.Comm`, SPMD: each rank passes
    its own tensor and gets the mean over the group: quantize the local
    blocks → int8 all-to-all (the reduce-scatter) → dequantize and sum
    the P stripes in rank order → requantize → int8 all-gather.  Its
    bytes on the wire (``collectives.byte_counts()``) are
    :func:`wire_bytes_per_device` exactly where ``block·P`` divides the
    length.  :func:`compressed_allreduce_sym` moves a symmetric leaf as
    its packed triangle.

Quantization is bit-equal to the reference's on the same inputs
(``torch.round`` and ``jnp.round`` both round half to even; the
divisions are IEEE f32 on both sides).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.packing import (PackedTriangle, ShardedTriTiles, TriTiles,
                            pack_tril, tril_size, unpack_tril)
from . import collectives
from .checkpoint import _is_packed_leaf, _unflatten, _walk
from .mesh import Comm

#: the arrays a packed leaf is made of, in the reference's pytree order
_COMPONENTS = {PackedTriangle: ("vec",), TriTiles: ("tiles",),
               ShardedTriTiles: ("off", "diag")}


def _pad_to(x: torch.Tensor, block: int) -> torch.Tensor:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    return F.pad(flat, (0, pad)) if pad else flat


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded once, on every device: PyTorch's CUDA division
    by a host scalar multiplies by its reciprocal instead (two roundings,
    an ulp off now and then), so the divisor goes in as a device
    tensor."""
    return x / x.new_full((), d)


def quantize_int8(x: torch.Tensor, block: int = 256
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric block-wise int8: (q int8 (nb, block), scale f32 (nb, 1)),
    the flat input zero-padded to a multiple of ``block``."""
    blocks = _pad_to(x, block).view(-1, block)
    scale = _div(blocks.abs().amax(dim=1, keepdim=True), 127.0) \
        .clamp_min(1e-12)
    q = (blocks / scale).round_().clamp_(-127, 127).to(torch.int8)
    return q, scale.float()


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype=torch.float32) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= d
    flat = q.float().mul_(scale).reshape(-1)
    return flat[:n].reshape(tuple(shape)).to(dtype)


class EFState(NamedTuple):
    error: Any                     # residual tree, f32; packed for
    #                                sym-masked leaves (…, tril_size(n))


def _arrays(leaf) -> List[torch.Tensor]:
    """A leaf's arrays as the reference's pytree flattens it."""
    if _is_packed_leaf(leaf):
        return [getattr(leaf, f) for f in _COMPONENTS[type(leaf)]]
    return [leaf]


def _assemble(like, arrays: List[torch.Tensor]):
    if _is_packed_leaf(like):
        return dataclasses.replace(
            like, **dict(zip(_COMPONENTS[type(like)], arrays)))
    return arrays[0]


def _leaves(tree) -> list:
    return [leaf for _, leaf in _walk(tree, "")]


class ErrorFeedbackInt8:
    """grads -> (dequantized grads, new EF state).

    The trees are the port's dicts (``Model.stacked()`` keys), walked in
    the reference's leaf order.  ``sym_mask`` (optional) has the grads'
    keys and one bool per array: True marks a dense symmetric (…, n, n)
    leaf, quantized as its n(n+1)/2 packed words with a packed residual,
    and returned dense and exactly symmetric.
    """

    def __init__(self, block: int = 256, sym_mask: Any = None):
        self.block = block
        self.sym_mask = sym_mask

    def _masks(self, narrays: int) -> List[bool]:
        if self.sym_mask is None:
            return [False] * narrays
        flat_m = _leaves(self.sym_mask)
        if len(flat_m) != narrays:
            raise ValueError(
                f"sym_mask has {len(flat_m)} leaves, grads have {narrays}")
        return [bool(m) for m in flat_m]

    def _map(self, fn, width: int, tree, *others) -> list:
        """``fn(array, *the matching arrays of others, sym)`` over every
        array of ``tree``, in order; each of its ``width`` results
        rebuilt in ``tree``'s structure."""
        leaves = _leaves(tree)
        flat = [[a for leaf in _leaves(t) for a in _arrays(leaf)]
                for t in (tree,) + others]
        masks = self._masks(len(flat[0]))
        results = [fn(*arrays, sym)
                   for *arrays, sym in zip(*flat, masks)]

        def rebuild(j):
            it = iter(r[j] for r in results)
            return _unflatten(tree, iter(
                _assemble(leaf, [next(it) for _ in _arrays(leaf)])
                for leaf in leaves))
        return [rebuild(j) for j in range(width)]

    def init(self, params: Any) -> EFState:
        def zero(p, sym):
            if sym:
                n = p.shape[-1]
                if tuple(p.shape[-2:]) != (n, n):
                    raise ValueError(
                        f"sym-masked leaf must be (…, n, n), got "
                        f"{tuple(p.shape)}")
                shape = tuple(p.shape[:-2]) + (tril_size(n),)
            else:
                shape = tuple(p.shape)
            return (torch.zeros(shape, dtype=torch.float32,
                                device=p.device),)

        return EFState(error=self._map(zero, 1, params)[0])

    def compress(self, grads: Any, state: EFState) -> Tuple[Any, EFState]:
        """One array at a time, its temporaries freed before the next
        (the residual is computed in place of the corrected gradient)."""
        def one(g, e, sym):
            if sym:
                n = g.shape[-1]
                corrected = pack_tril(g.float()) + e
            else:
                corrected = g.float() + e
            q, s = quantize_int8(corrected, self.block)
            deq = dequantize_int8(q, s, corrected.shape)
            del q, s
            if sym:
                out = unpack_tril(deq, n, symmetric=True).to(g.dtype)
            else:
                out = deq.to(g.dtype)
            return out, corrected.sub_(deq)

        new_g, new_e = self._map(one, 2, grads, state.error)
        return new_g, EFState(error=new_e)

    def allreduce(self, grads: Any, state: EFState,
                  comm: Comm) -> Tuple[Any, EFState]:
        """The data-parallel form: each rank adds its own residual to its
        own gradients, the mean over ``comm`` goes through
        :func:`compressed_allreduce` (int8 on the wire), and the new
        residual is what this rank's first quantization dropped.
        Returns (the f32 mean, the new EF state)."""
        if self.sym_mask is not None:
            raise NotImplementedError("sym_mask on the data-parallel "
                                      "all-reduce")

        def one(g, e, sym):
            corrected = g.float() + e
            out, local = compressed_allreduce(corrected, comm, self.block,
                                              local=True)
            return out, corrected.sub_(local)

        new_g, new_e = self._map(one, 2, grads, state.error)
        return new_g, EFState(error=new_e)


def compressed_allreduce(x: torch.Tensor, comm: Comm, block: int = 256,
                         local: bool = False):
    """Mean over ``comm``'s ranks of each rank's ``x``, int8 on the wire;
    with ``local``, the pair (that mean, this rank's own ``x`` as its
    quantization gives it back, f32), which error feedback subtracts.

    Each rank quantizes its own blocks (padded so that the block count
    divides P), sends stripe p to rank p (``all_to_all``), dequantizes
    and sums the P stripes it received as a left fold in rank order,
    divides by P, requantizes, and all-gathers the int8 stripes and
    their scales.  Per rank that is (P−1)/P of the local int8 blocks and
    f32 scales each way: :func:`wire_bytes_per_device`.
    """
    P = comm.size
    flat = _pad_to(x, block)
    extra = (-(flat.numel() // block)) % P
    if extra:
        flat = torch.cat([flat, flat.new_zeros(extra * block)])
    q, s = quantize_int8(flat, block)
    mine = dequantize_int8(q, s, x.shape) if local else None
    stripe = q.shape[0] // P
    qs = collectives.all_to_all(q.view(P, stripe, block), comm)
    ss = collectives.all_to_all(s.view(P, stripe, 1), comm)
    del q, s, flat
    part = qs[0].float() * ss[0]
    for p in range(1, P):
        part = part + qs[p].float() * ss[p]
    part = _div(part, P)
    del qs, ss
    q2, s2 = quantize_int8(part, block)
    q2 = collectives.all_gather(q2, comm)
    s2 = collectives.all_gather(s2, comm)
    out = dequantize_int8(q2, s2, x.shape, x.dtype)
    return (out, mine) if local else out


def compressed_allreduce_sym(x, comm: Comm, block: int = 256):
    """Packed-symmetric :func:`compressed_allreduce`: a dense (…, n, n)
    leaf moves as its n(n+1)/2 packed lower triangle and comes back
    mirrored, so exactly symmetric; a :class:`PackedTriangle` stays
    packed."""
    if isinstance(x, PackedTriangle):
        v = compressed_allreduce(x.vec, comm, block)
        return PackedTriangle(v.to(x.vec.dtype), x.n)
    n = x.shape[-1]
    if tuple(x.shape[-2:]) != (n, n):
        raise ValueError(f"expected symmetric (…, n, n), got "
                         f"{tuple(x.shape)}")
    v = compressed_allreduce(pack_tril(x), comm, block)
    return unpack_tril(v, n, symmetric=True).to(x.dtype)


def wire_bytes_per_device(n_params: int, p: int, *, compressed: bool,
                          block: int = 256, sym_n: Optional[int] = None
                          ) -> float:
    """Ring-model bytes a rank sends for one DP gradient reduction:
    2·(P−1)/P·n·(1 + 4/block) compressed (the all-to-all leg and the
    all-gather leg of :func:`compressed_allreduce`), 2·(P−1)/P·n·4 for
    an f32 all-reduce.  With ``sym_n``, ``n_params`` counts dense n×n
    leaves that go on the wire as their tril_size(n) packed triangles."""
    if sym_n is not None:
        full = sym_n * sym_n
        n_params = (n_params // full) * tril_size(sym_n)
    pf = 2.0 * (p - 1) / p
    per_param = (1.0 + 4.0 / block) if compressed else 4.0
    return pf * n_params * per_param
