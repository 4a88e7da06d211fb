"""Muon: momentum plus Newton–Schulz (NS) orthogonalization on the
symmetric BLAS (port of the single-device half of
:mod:`repro.optim.muon`, reference mode).

Each NS iteration of X (m × n, m ≤ n) computes

    S  = X·Xᵀ                (SYRK)
    X ← a·X + (b·S + c·S²)·X (SYMM chain: S², then symmetric·X)

On the card every Gram is a ``rank_update`` launch and both products
``sym_stream`` launches.  A stacked parameter (the reference's
``(n_periods, m, n)`` leaves) goes through as one stack: each blas call
takes the whole stack in one launch, where the reference vmaps the same
chain over the flattened stack.  Norms are per matrix (over the last two
dims) and every matrix of a stack works on its short side.

On a mesh with X column-sharded over an axis, ``mode="syrk-1d"`` runs
:func:`orthogonalize_1d`: the Gram is the paper's 1D SYRK (Alg 7, a
local outer product and one reduce-scatter of the packed lower
triangle), and the symmetric factor is rebuilt by the 1D SYMM's gather
of the packed triangle (Alg 9): (1−1/P)·m² words a step against
2·(1−1/P)·m² for a full-matrix all-reduce.  That is Thm 9 case 1
(n₁ = m ≤ n, small P), where 1D is communication-optimal; elsewhere, or
without a mesh, the reference branch runs (on the mesh's blas routes
when there is one), as in the reference.  The result stays column-
sharded, as the reference's; the optimizer, whose parameters every rank
holds whole, gathers the shards once per update
(:func:`~repro_torch.core.onedim.gather_columns`, counted as a
replication, not as the schedule's words).

With ``specs`` (the trainer on a (data, model) mesh) every rank holds
only its blocks, and ``Muon._orthogonalize_shard`` takes each leaf
where it lies: a block split over the long side runs
:func:`orthogonalize_1d_local` on the block itself where the 1D
schedule is optimal (a row split through its transpose), a replicated
leaf the single-device chain, anything else one gather, the chain, and
its block back.  For stablelm-1.6b at |model| = 4 that is embed and
unembed on the 1D schedule and every block stack gathered (2048² and
2048 × 5632 are outside Thm 9 case 1 at P = 4); at |model| = 2 the MLP
stacks join the 1D schedule.

With ``gram_decay`` each 2-D matrix leaf also carries the EMA of its
momentum's packed short-side Gram over the width (``MuonState.gram``).
With ``specs``, a leaf split over the NS axis along that width (embed's
rows, unembed's columns) computes it as the paper's 1D SYRK (Alg 7):
each rank's partial Gram of its block (``blas.syrk(fill="packed")``,
the kernel on the card), one reduce-scatter of the padded packed
triangle, and the rank keeps its slice
(:class:`~repro_torch.core.packing.PackedTriangleSlice`): 1/P of the
state, (1 − 1/P)·n(n+1)/2 words a step (padded to a multiple of P).  A
replicated leaf runs the single-device update on every rank; any other
split gathers the momentum first.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from .. import blas
from ..core.onedim import (_pad_packed, _scatter_packed, column_shard,
                           gather_columns, gather_packed, syrk_1d_local)
from ..core.packing import (PackedTriangle, PackedTriangleSlice, tril_size,
                            unpack_tril)
from ..distributed import collectives
from ..models.sharding import (gather_leaf, global_shape, is_sharded,
                               shard_leaf)

Tree = Dict[Any, torch.Tensor]

# quintic Newton–Schulz coefficients (Jordan et al., Muon)
NS_COEFFS = (3.4445, -4.7750, 2.0315)


class MuonState(NamedTuple):
    step: int
    momentum: Tree
    #: optional per-matrix Gram EMA of the momentum (PackedTriangle
    #: leaves, or this rank's PackedTriangleSlice of a leaf split along
    #: its width; an empty placeholder where a leaf is not a 2-D
    #: matrix); None unless ``Muon.gram_decay`` is set
    gram: Optional[Dict[Any, Any]] = None


# ---------------------------------------------------------------------------
# Newton–Schulz cores
# ---------------------------------------------------------------------------
def ns_iteration_reference(x: torch.Tensor,
                           gram_chunk: Optional[int] = None, *, mesh=None,
                           axis: Optional[str] = None) -> torch.Tensor:
    """One NS step of x (..., m, n) on the blas surface: the Gram is a
    SYRK, both products SYMMs, each one call for the whole stack (on the
    mesh's routes when ``mesh`` is given).

    ``gram_chunk`` streams the Gram over column chunks of that size
    through the SYRK's beta-accumulate epilogue (``c=s, beta=1``)."""
    a, b, c = NS_COEFFS
    n = x.shape[-1]
    kw = dict(mesh=mesh, axis=axis)
    if gram_chunk is None or gram_chunk >= n:
        s = blas.syrk(x, fill="full", **kw)                   # S = X·Xᵀ
    else:
        s = None
        for lo in range(0, n, gram_chunk):
            s = blas.syrk(x[..., lo:lo + gram_chunk], fill="full", c=s,
                          **kw)
    y = b * s + c * blas.symm(s, s, **kw)                     # S² (sym·S)
    return a * x + blas.symm(y, x, **kw)                      # sym(Y)·X


def orthogonalize_reference(g: torch.Tensor, steps: int = 5,
                            gram_chunk: Optional[int] = None, *, mesh=None,
                            axis: Optional[str] = None) -> torch.Tensor:
    """NS orthogonalization of g (..., m, n) on the short side of its
    matrices; returns approximately semi-orthogonal matrices in g's
    dtype.  Each matrix of a stack is scaled by its own norm."""
    transpose = g.shape[-2] > g.shape[-1]
    x = (g.mT if transpose else g).float().contiguous()
    x = x / (torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True) + 1e-7)
    for _ in range(steps):
        x = ns_iteration_reference(x, gram_chunk, mesh=mesh, axis=axis)
    return (x.mT if transpose else x).to(g.dtype)


def _ns_iteration_1d_local(x_loc: torch.Tensor, comm) -> torch.Tensor:
    """One NS step on this rank's column shard x_loc (..., m, n/P): the
    Gram by the packed reduce-scatter (Alg 7) and the packed all-gather
    (Alg 9's wire), one collective each for a whole stack; the
    symmetric chain is local."""
    a, b, c = NS_COEFFS
    m = x_loc.shape[-2]
    shard = syrk_1d_local(x_loc, comm)                      # RS: m²/2 words
    packed = gather_packed(shard, comm)[..., :tril_size(m)]  # AG: m²/2 words
    s = unpack_tril(packed, m, diag=True, symmetric=True)
    y = b * s + c * (s @ s)
    return a * x_loc + y @ x_loc


def orthogonalize_1d(g: torch.Tensor, mesh, axis: str = "model",
                     steps: int = 5) -> torch.Tensor:
    """Distributed NS orthogonalization with the communication-optimal
    1D algorithms.

    ``g`` (m, n) or a stack (..., m, n) with m <= n, n divisible by the
    axis size, passed alike by every rank: each rank works on its column
    shard (each matrix scaled by its norm, one all-reduce for the
    stack), and one packed reduce-scatter and all-gather per NS step
    cover the whole stack.  Returns this rank's column shard
    (..., m, n/P) of the result, in g's dtype, as the reference's
    ``shard_map`` does (``out_specs`` = the input's column sharding);
    :func:`~repro_torch.core.onedim.gather_columns` makes it whole."""
    comm = mesh.comm(axis)
    return orthogonalize_1d_local(column_shard(g, comm), comm, steps)


def orthogonalize_1d_local(g_loc: torch.Tensor, comm,
                           steps: int = 5) -> torch.Tensor:
    """:func:`orthogonalize_1d` on this rank's column shard
    (..., m, n/P) of a whole (..., m, n), m <= n, as a caller that holds
    only its shard has it: no gather in, none out."""
    x = g_loc.float().contiguous()
    sq = collectives.all_reduce(x.square().sum(dim=(-2, -1)), comm)
    x = x / (sq.sqrt()[..., None, None] + 1e-7)
    for _ in range(steps):
        x = _ns_iteration_1d_local(x, comm)
    return x.to(g_loc.dtype)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
def _is_matrix(p: torch.Tensor) -> bool:
    """Muon applies to matrices: ``ndim >= 2`` and both trailing dims
    at least 8.  As in the reference, a stacked (n_periods, d) leaf (the
    norms' scales and biases) counts once n_periods >= 8 and is then
    orthogonalized as one n_periods × d matrix."""
    return p.ndim >= 2 and min(p.shape[-2:]) >= 8


@dataclass(frozen=True)
class Muon:
    """Momentum + NS orthogonalization for matrix params, signSGD with
    momentum for the rest.

    mode: 'reference' (the NS chain on the blas surface, on the mesh's
    routes when ``mesh`` is set) or 'syrk-1d' (:func:`orthogonalize_1d`
    on ``mesh`` / ``axis`` where Thm 9 case 1 holds and the axis divides
    the long side; the reference branch elsewhere)."""
    lr: float = 2e-2
    momentum: float = 0.95
    ns_steps: int = 5
    weight_decay: float = 0.0
    mode: str = "reference"
    fallback_lr: float = 3e-4
    #: stream NS Grams over column chunks of this size (None: one shot)
    gram_chunk: Optional[int] = None
    #: EMA decay of a packed momentum-Gram per 2-D matrix param (the
    #: short-side ``blas.syrk(fill="packed")``); None disables it
    gram_decay: Optional[float] = None
    #: a repro_torch.distributed.mesh.Mesh and the axis the NS runs on
    mesh: Any = None
    axis: str = "model"
    #: the caller's leaves are this rank's blocks under these specs
    #: (``models.sharding.param_specs``, keyed as the trees are); None:
    #: every rank holds its parameters whole
    specs: Optional[Dict[Any, Any]] = None

    def _spec(self, k):
        return None if self.specs is None else self.specs[k]

    def _gram_split(self, shape, spec) -> bool:
        """Whether a 2-D leaf of whole ``shape`` is split over the NS
        axis (of more than one rank) along its Gram's width alone: the
        columns when rows <= cols, else the rows."""
        if spec is None or self.mesh.shape.get(self.axis, 1) == 1:
            return False
        width = (None, self.axis) if shape[0] <= shape[1] \
            else (self.axis, None)
        return tuple(spec) == width

    def _gram_zero(self, p: torch.Tensor, spec=None):
        shape = global_shape(p.shape, spec, self.mesh)
        if len(shape) == 2 and min(shape) >= 8:          # _is_matrix
            m = min(shape)
            zeros = torch.zeros((tril_size(m),), dtype=torch.float32,
                                device=p.device)
            if self._gram_split(shape, spec):
                comm = self.mesh.comm(self.axis)
                return PackedTriangleSlice.from_packed(zeros, m, comm.size,
                                                       comm.index)
            return PackedTriangle(zeros, m)
        return torch.zeros((0,), dtype=torch.float32, device=p.device)

    def init(self, params: Tree) -> MuonState:
        gram = None
        if self.gram_decay is not None:
            gram = {k: self._gram_zero(p, self._spec(k))
                    for k, p in params.items()}
        return MuonState(step=0, momentum={
            k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}, gram=gram)

    def _use_1d(self, n1: int, n2: int) -> bool:
        """The paper's regime selection (Thm 9 / §VIII-D): the packed 1D
        algorithm is communication-optimal only in case 1 (n1 ≤ n2 and
        P ≤ n2/√(n1(n1−1))); elsewhere replicating the NS chain costs
        more than it saves, and the reference branch runs."""
        from ..core.dispatch import choose_algorithm
        return choose_algorithm(n1, n2, self.mesh.shape[self.axis],
                                m=1).case == 1

    def _orthogonalize(self, m2: torch.Tensor) -> torch.Tensor:
        """m2: (..., m, n) f32 momentum, stacks included."""
        if self.mode not in ("reference", "syrk-1d"):
            raise ValueError(f"mode {self.mode!r}")
        if self.mode == "syrk-1d" and self.mesh is not None:
            transpose = m2.shape[-2] > m2.shape[-1]
            x = m2.mT if transpose else m2
            if x.shape[-1] % self.mesh.shape[self.axis] == 0 \
                    and self._use_1d(x.shape[-2], x.shape[-1]):
                # every rank holds the parameter whole: gather the
                # sharded result (the replication, not the NS wire)
                out = gather_columns(
                    orthogonalize_1d(x, self.mesh, self.axis, self.ns_steps),
                    self.mesh.comm(self.axis))
                return out.mT if transpose else out
        if m2.ndim > 2 or self.mesh is None \
                or self.axis not in self.mesh.shape:
            # a stack runs as one blas call per product, off the mesh,
            # where the reference vmaps the chain without one
            return orthogonalize_reference(m2, self.ns_steps,
                                           self.gram_chunk)
        return orthogonalize_reference(m2, self.ns_steps, self.gram_chunk,
                                       mesh=self.mesh, axis=self.axis)

    def _orthogonalize_shard(self, m2: torch.Tensor, spec) -> torch.Tensor:
        """m2: this rank's block, under ``spec``, of a (..., m, n) f32
        momentum; returns its block of the orthogonalized matrix.

        * replicated: the single-device chain, alike on every rank (the
          norm stacks);
        * split over the NS axis on the long side, where Thm 9 case 1
          holds (``_use_1d``): the 1D body on the shard itself, no
          gather (a column split of m <= n as it is; a row split of
          m >= n on its transpose, since NS(Xᵀ) = NS(X)ᵀ);
        * anything else (``_use_1d`` declines: at |model| = 4 every
          stablelm-1.6b block matrix): gather the whole matrix, run the
          single-device chain (the kernels on the card), keep the block.
        """
        if not is_sharded(spec):
            return orthogonalize_reference(m2, self.ns_steps,
                                           self.gram_chunk)
        P = self.mesh.shape[self.axis]
        m, n = m2.shape[-2], m2.shape[-1]
        lead_free = all(a is None for a in spec[:-2])
        if self.mode == "syrk-1d" and lead_free:
            rows, cols = spec[-2:]
            if (rows, cols) == (None, self.axis) and m <= n * P \
                    and self._use_1d(m, n * P):
                return orthogonalize_1d_local(
                    m2, self.mesh.comm(self.axis), self.ns_steps)
            if (rows, cols) == (self.axis, None) and m * P >= n \
                    and self._use_1d(n, m * P):
                return orthogonalize_1d_local(
                    m2.mT, self.mesh.comm(self.axis), self.ns_steps).mT
        whole = gather_leaf(m2, spec, self.mesh, kind="all_gather")
        out = orthogonalize_reference(whole, self.ns_steps, self.gram_chunk)
        return shard_leaf(out, spec, self.mesh).contiguous()

    @torch.no_grad()
    def update(self, grads: Tree, state: MuonState, params: Tree,
               lr_scale: float = 1.0) -> Tuple[Tree, MuonState]:
        step = state.step + 1
        mom = {k: self.momentum * state.momentum[k] + g.float()
               for k, g in grads.items()}

        def upd(k, p, mm):
            spec = self._spec(k)
            shape = global_shape(p.shape, spec, self.mesh)
            if len(shape) >= 2 and min(shape[-2:]) >= 8:   # _is_matrix
                o = self._orthogonalize(mm) if spec is None \
                    else self._orthogonalize_shard(mm, spec)
                scale = math.sqrt(max(1.0, shape[-2] / shape[-1]))
                delta = o * scale + self.weight_decay * p.float()
                return (p.float() - self.lr * lr_scale * delta).to(p.dtype)
            return (p.float() - self.fallback_lr * lr_scale
                    * torch.sign(mm)).to(p.dtype)

        new_params = {k: upd(k, p, mom[k]) for k, p in params.items()}

        gram = state.gram
        if self.gram_decay is not None and gram is not None:
            d = self.gram_decay

            def upd_gram(k, gm, mm):
                spec = self._spec(k)
                if isinstance(gm, PackedTriangleSlice):
                    # Alg 7: this rank's partial Gram of its block, the
                    # reduce-scatter of the padded packed triangle
                    shape = global_shape(mm.shape, spec, self.mesh)
                    x = mm if shape[0] <= shape[1] else mm.T
                    comm = self.mesh.comm(self.axis)
                    part = blas.syrk(x.float().contiguous(), fill="packed")
                    g = _scatter_packed(_pad_packed(part, gm.n, comm.size),
                                        comm) / (x.shape[-1] * comm.size)
                    ema = d * gm.vec.float() + (1.0 - d) * g
                    return PackedTriangleSlice(ema.to(gm.dtype), gm.n,
                                               gm.parts, gm.index)
                if not isinstance(gm, PackedTriangle):
                    return gm
                if is_sharded(spec):        # another split: gather it
                    mm = gather_leaf(mm, spec, self.mesh, kind="all_gather")
                x = mm if mm.shape[0] <= mm.shape[1] else mm.T
                g = blas.syrk(x.float().contiguous(),
                              fill="packed") / x.shape[-1]
                ema = d * gm.vec.float() + (1.0 - d) * g
                return PackedTriangle(ema.to(gm.dtype), gm.n)

            gram = {k: upd_gram(k, gm, mom[k]) for k, gm in gram.items()}
        return new_params, MuonState(step=step, momentum=mom, gram=gram)


def state_dict(state: MuonState) -> dict:
    """MuonState as a stable-keyed dict (``gram``: PackedTriangle
    leaves, which a checkpoint layer stores packed)."""
    return {"step": state.step, "momentum": state.momentum,
            "gram": state.gram}


def load_state_dict(d: dict) -> MuonState:
    """Inverse of :func:`state_dict` (``gram`` optional)."""
    return MuonState(step=d["step"], momentum=d["momentum"],
                     gram=d.get("gram"))
