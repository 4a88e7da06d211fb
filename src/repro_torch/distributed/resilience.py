"""ABFT checksums and retry policies for the packed symmetric BLAS (port
of :mod:`repro.distributed.resilience`).

Algorithm-based fault tolerance for the paper's symmetric kernels: the
SYRK output C = A·Aᵀ satisfies the row-sum identity

    sym(C) · 1  =  A · (Aᵀ · 1)

so an O(n) checksum vector guards the O(n²/2) packed triangle payload
of every route (Huang–Abraham encoding specialized to the packed wire).
The verified identity is the *prefix* form of the row sums: the packed
row-major row i holds exactly C[i, :i+1], so

    Σ_{j≤i} C[i, j]  =  a_i · (Σ_{j≤i} a_j)

which maps every packed word into exactly one checksum row (clean
localization).  The expected side needs the row prefixes of A, computed
blocked (:func:`_prefix_dots`: block-level exclusive prefixes plus
batched r×r triangle matmuls).  SYR2K uses Σ_{j≤i} C[i,j] = a_i·cumB[i]
+ b_i·cumA[i]; SYMM (C = sym(S)·B, dense output) keeps the full row-sum
form C·1 = sym(S)·(B·1), a packed matvec on the triangle's view.

The check runs where the payload lives.  The reference checks on the
host, where its packed wire already is; here the payload is on the
card, and a host copy of A at a Muon Gram shape would cost more than
the product, so every term (the packed row sums, A's row prefixes, the
magnitude bound) is a torch op on the payload's device and only the
flagged row indices come back to the host.

Verification is accumulation-aware: the tolerance scales with the
per-row magnitude bound |A|·(|Aᵀ|·1) (what f32 rounding of the same
accumulation could legitimately produce) rather than a global eps, so a
bitflip in one payload word stands apart from honest rounding even when
row norms differ by orders of magnitude (:func:`_default_rtol`).

On mismatch, :func:`checked_syrk` / :func:`checked_syr2k` /
:func:`checked_symm` localize the bad checksum rows to the owning
device's row band, then repair: patch the corrupted device's shard from
a trusted packed reference via
:func:`~repro_torch.distributed.straggler.rebuild_replacement_shard`
when one is given (checkpointed state), else recompute with exponential
backoff (injected transient faults, :mod:`.faults`, do not fire again,
as a real single-event upset would not).

The routes (:func:`route_runner`) compute the reference's functions on
the port's own BLAS.  ``"local"`` is ``repro_torch.blas.syrk(a,
fill="packed")`` / ``syr2k`` and ``symm`` of the packed S: on a CUDA
tensor with n1 >= ``KERNEL_MIN_N1`` these run the hand-written
``rank_update`` / ``sym_stream`` kernels, so the checksum guards them;
on the host, their plain versions.  The mesh routes (1d, ring, 2d, 3d,
3d-limited) are the ``blas/meshpath.py`` schedules with their packed
exits.  On a mesh every rank calls the checked function with the same
operands; the injector is seeded, so every rank corrupts the same slots
and takes the same decision, and a retry is one more schedule on every
rank.  :func:`with_retries` is the generic transient-failure policy of
checkpoint I/O and the serving refresh executor.
"""
from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from ..core.packing import (PackedTriangle, ShardedTriTiles, tril_size,
                            unpack_tril)
from . import faults

#: default relative scale for the accumulation-aware tolerance; the
#: per-row bound already carries the magnitude, this carries the
#: accumulation-length growth (n2-term dots summed over n rows)
DEFAULT_ATOL = 1e-5


class AbftError(RuntimeError):
    """Checksum mismatch that survived every repair attempt."""

    def __init__(self, msg: str, report: "AbftReport"):
        super().__init__(msg)
        self.report = report


@dataclass
class AbftReport:
    op: str
    route: str
    n: int
    attempts: int = 0
    detected: bool = False
    bad_rows: List[int] = field(default_factory=list)
    devices: List[int] = field(default_factory=list)
    #: owner of the highest flagged checksum row: the prefix checksum
    #: maps packed slot (i, j) to exactly row i, so every flagged row
    #: lies inside a corrupted device's own band (SYMM's dense row sums
    #: share the property); max picks the deepest band when the
    #: corruption straddles a boundary
    primary: Optional[int] = None
    action: str = "none"           # none | retry | rebuild


# -- generic retry policy ---------------------------------------------------
def with_retries(fn: Callable, *args, retries: int = 4,
                 backoff: float = 0.05, jitter: float = 0.25,
                 timeout: Optional[float] = None,
                 retry_on=(OSError,), on_retry: Optional[Callable] = None,
                 **kwargs) -> Any:
    """Call ``fn(*args, **kwargs)``, retrying transient failures with
    exponential backoff.

    ``retries`` extra attempts after the first; ``backoff`` doubles per
    retry with a deterministic ``jitter`` fraction added (a reproducible
    run must not depend on a wall-clock rng); ``timeout`` caps the total
    budget: the last error re-raises once sleeping again would exceed
    it.  ``on_retry(attempt, exc)`` observes each failure.  Exceptions
    not in ``retry_on`` propagate at once.
    """
    t0 = time.monotonic()
    delay = backoff
    for attempt in range(retries + 1):
        try:
            return fn(*args, **kwargs)
        except retry_on as e:                       # noqa: PERF203
            if attempt >= retries:
                raise
            pause = delay * (1.0 + jitter
                             * ((attempt * 2654435761) % 997) / 997.0)
            if timeout is not None and \
                    time.monotonic() - t0 + pause > timeout:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            time.sleep(pause)
            delay *= 2.0
    raise AssertionError("unreachable")


# -- packed checksum algebra ------------------------------------------------
def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).float()


def _tril_view(p, n: int) -> torch.Tensor:
    """The dense lower triangle of a packed payload on its device (zeros
    above the diagonal): a local O(n²) temp in the payload's own
    footprint class, nothing on the wire."""
    return unpack_tril(_f32(p), n, symmetric=False)


def packed_row_sums(p, n: int) -> torch.Tensor:
    """Row sums of sym(C) from the packed triangle: row segment sums +
    column sums − diag (the diagonal slot is counted by both sides)."""
    m = _tril_view(p, n)
    return m.sum(-1) + m.sum(-2) - torch.diagonal(m, dim1=-2, dim2=-1)


def packed_sym_matvec(p, n: int, v) -> torch.Tensor:
    """sym(S) · v from the packed triangle (the SYMM checksum's expected
    side): two triangular matvecs on the dense view, minus the
    double-counted diagonal."""
    m = _tril_view(p, n)
    vf = _f32(v).to(m.device)
    return m @ vf + m.T @ vf - torch.diagonal(m) * vf


#: within-block size of the blocked prefix: small enough that the
#: batched r×r cross-dot stays ~n·r·k flops, large enough that the
#: block-level cumsum is negligible
_PREFIX_BLOCK = 64


def _prefix_dots(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``s[i] = x_i · Σ_{j≤i} y_j``, blocked as the reference does: an
    exclusive block-level prefix (one cumsum over n/r block column
    sums) plus batched r×r cross-dot matmuls masked to the within-block
    triangle, ~n·r·k flops, all on ``x``'s device."""
    n, k = x.shape
    r = min(_PREFIX_BLOCK, n)
    b = -(-n // r)
    if b * r != n:
        x = torch.nn.functional.pad(x, (0, 0, 0, b * r - n))
        y = torch.nn.functional.pad(y, (0, 0, 0, b * r - n))
    x3 = x.reshape(b, r, k)
    y3 = y.reshape(b, r, k)
    blk = y3.sum(dim=1)                             # (b, k) block sums
    pre = torch.cumsum(blk, dim=0) - blk            # exclusive
    g = x3 @ y3.transpose(1, 2)                     # (b, r, r)
    mask = torch.ones(r, r, dtype=g.dtype, device=g.device).tril()
    t = (g * mask).sum(dim=2)
    s = (x3 @ pre[:, :, None])[:, :, 0] + t
    return s.reshape(-1)[:n]


def _default_rtol(n1: int, n2: int, dtype=None) -> float:
    """Calibrated detection margin (the reference's).  The worst honest
    f32 rounding keeps |rs − s| below ~1e-8·(m+1), while a single
    corrupted payload word moves its checksum row by at least the slot
    magnitude ≈ 3e-5·(m+1) even in the worst (exponent down-flip)
    direction: 1e-6 splits the two decades.  Scales with machine eps
    for wider-eps payloads (bf16)."""
    del n1, n2                                      # magnitude lives in m
    eps = float(np.finfo(np.float32).eps)
    if dtype is not None:
        try:
            eps = float(torch.finfo(dtype).eps) \
                if isinstance(dtype, torch.dtype) \
                else float(np.finfo(dtype).eps)
        except (TypeError, ValueError):             # non-float payload
            pass
    return max(1e-6, 8.0 * eps)


def _syrk_terms(a, out, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(|observed − expected| prefix row sums, magnitude bound m)."""
    af = _f32(a)
    rs = _tril_view(out, n).sum(-1)
    s = _prefix_dots(af, af)
    ab = af.abs()
    return (rs.to(s.device) - s).abs(), ab @ ab.sum(0)


def _syr2k_terms(a, b, out, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    af, bf = _f32(a), _f32(b)
    rs = _tril_view(out, n).sum(-1)
    s = _prefix_dots(af, bf) + _prefix_dots(bf, af)
    ab, bb = af.abs(), bf.abs()
    return (rs.to(s.device) - s).abs(), ab @ bb.sum(0) + bb @ ab.sum(0)


def _symm_terms(a_packed, b, out, n: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    bf = _f32(b)
    s = packed_sym_matvec(a_packed, n, bf.sum(-1))
    m = packed_sym_matvec(_f32(a_packed).abs(), n, bf.abs().sum(-1))
    return (_f32(out).sum(-1).to(s.device) - s).abs(), m


_TERMS = {"syrk": _syrk_terms, "syr2k": _syr2k_terms, "symm": _symm_terms}


def checksum_residuals(op: str, *operands, out, rtol: Optional[float] = None,
                       atol: float = DEFAULT_ATOL
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the ``op`` check compares, per checksum row: the residual
    |observed − expected| and its threshold ``atol + rtol·(m + 1)``
    (``rtol`` by default :func:`_default_rtol` of the first operand's
    dtype).  A row is flagged when the residual exceeds the threshold
    or is NaN."""
    x = operands[-1] if op == "symm" else operands[0]
    n1 = x.shape[0]
    if rtol is None:
        rtol = _default_rtol(n1, x.shape[1], torch.as_tensor(x).dtype)
    resid, m = _TERMS[op](*operands, out, n1)
    return resid, atol + rtol * (m + 1.0)


def _flags(terms: Tuple[torch.Tensor, torch.Tensor], rtol: float,
           atol: float) -> torch.Tensor:
    resid, m = terms
    return torch.isnan(resid) | (resid > atol + rtol * (m + 1.0))


@functools.lru_cache(maxsize=None)
def _check_syrk(n: int, rtol: float, atol: float):
    def chk(a, out):
        return _flags(_syrk_terms(a, out, n), rtol, atol)
    return chk


@functools.lru_cache(maxsize=None)
def _check_syr2k(n: int, rtol: float, atol: float):
    def chk(a, b, out):
        return _flags(_syr2k_terms(a, b, out, n), rtol, atol)
    return chk


@functools.lru_cache(maxsize=None)
def _check_symm(n: int, rtol: float, atol: float):
    def chk(a_packed, b, out):
        return _flags(_symm_terms(a_packed, b, out, n), rtol, atol)
    return chk


# -- row-band device ownership ----------------------------------------------
def device_rows(n: int, world: int, k: int) -> Tuple[int, int]:
    """Row band [r0, r1) of the packed payload attributed to device
    ``k`` of ``world`` (the corruption/localization model: a device's
    contribution to the assembled triangle is a contiguous row band,
    and its packed slots ``[tril_size(r0), tril_size(r1))`` are
    contiguous by row-major packing)."""
    return (k * n) // world, ((k + 1) * n) // world


def owner_of_rows(rows, n: int, world: int) -> List[int]:
    bounds = np.array([(k * n) // world for k in range(1, world + 1)])
    return sorted(set(int(np.searchsorted(bounds, r, side="right"))
                      for r in np.asarray(rows).ravel()))


def _route_world(route: str, mesh, axis: str, c, p2) -> int:
    if route in ("1d", "ring"):
        return int(mesh.shape[axis])
    if route in ("2d", "3d", "3d-limited"):
        return c * (c + 1)
    return 1                                        # local


# -- route runners ----------------------------------------------------------
def route_runner(op: str, route: str, mesh=None, axis: str = "x",
                 c: Optional[int] = None, p2: Optional[int] = None,
                 chunk: Optional[int] = None) -> Callable:
    """Packed-output runner for (op, route): the port's single-device
    BLAS for ``"local"`` (the kernels on the card), else the meshpath
    schedule the blas router dispatches to, with ShardedTriTiles exits
    lowered to the element-packed triangle."""
    from .. import blas
    from ..blas import meshpath as mp
    if op in ("syrk", "syr2k"):
        return {
            "local": {
                "syrk": lambda a: blas.syrk(a, fill="packed"),
                "syr2k": lambda a, b: blas.syr2k(a, b, fill="packed")},
            "1d": {
                "syrk": lambda a: mp.syrk_1d_packed(a, mesh, axis),
                "syr2k": lambda a, b: mp.syr2k_1d_packed(a, b, mesh, axis)},
            "ring": {
                "syrk": lambda a: mp.syrk_ring_packed(a, mesh, axis),
                "syr2k": lambda a, b: mp.syr2k_ring_packed(a, b, mesh,
                                                           axis)},
            "2d": {
                "syrk": lambda a: mp.syrk_2d_sharded(
                    a, c, mesh, axis).to_packed(),
                "syr2k": lambda a, b: mp.syr2k_2d_sharded(
                    a, b, c, mesh, axis).to_packed()},
            "3d": {
                "syrk": lambda a: mp.syrk_3d_sharded(
                    a, c, p2, mesh, axis).to_packed(),
                "syr2k": lambda a, b: mp.syr2k_3d_sharded(
                    a, b, c, p2, mesh, axis).to_packed()},
            "3d-limited": {
                "syrk": lambda a: mp.syrk_3d_limited_sharded(
                    a, c, p2, chunk, mesh, axis).to_packed(),
                "syr2k": lambda a, b: mp.syr2k_3d_limited_sharded(
                    a, b, c, p2, chunk, mesh, axis).to_packed()},
        }[route][op]
    return {                                        # symm
        "local": lambda p, b: blas.symm(
            PackedTriangle(p.float(), b.shape[0]), b),
        "1d": lambda p, b: mp.symm_1d_packed_a(p, b, b.shape[0], mesh,
                                               axis),
        "ring": lambda p, b: mp.symm_ring_packed_a(p, b, b.shape[0], mesh,
                                                   axis),
        "2d": lambda p, b: mp.symm_2d_packed_a(p, b, c, mesh, axis),
        "3d": lambda p, b: mp.symm_3d_packed_a(p, b, c, p2, mesh, axis),
        "3d-limited": lambda p, b: mp.symm_3d_limited_packed_a(
            p, b, c, p2, chunk, mesh, axis),
    }[route]


# -- shard repair from a trusted reference ----------------------------------
def repair_with_reference(out: torch.Tensor, reference: torch.Tensor,
                          n: int, c: int, *, rtol: float = 1e-6,
                          atol: float = 1e-6
                          ) -> Tuple[torch.Tensor, List[int]]:
    """Patch corrupted device shards of a packed triangle from a
    trusted reference (checkpointed words).

    Each of the P = c(c+1) wire devices' extended triangle blocks is
    rebuilt from the reference via
    :func:`~repro_torch.distributed.straggler.rebuild_replacement_shard`
    (one slice-granular gather per device, never the dense n×n) and
    compared to the same shard of ``out``; differing shards are
    replaced.  Returns ``(repaired_packed, corrupted_devices)``.
    """
    from .straggler import rebuild_replacement_shard
    ref = torch.as_tensor(reference).to(out.device)
    st = ShardedTriTiles.from_packed(out, n, c)
    off, diag = st.off.clone(), st.diag.clone()
    patched: List[int] = []
    for k in range(st.num_devices):
        off_r, diag_r = rebuild_replacement_shard(ref, n, c, k)
        if _differs(off[k], off_r, rtol, atol) \
                or _differs(diag[k], diag_r, rtol, atol):
            off[k] = off_r.to(off.dtype)
            diag[k] = diag_r.to(diag.dtype)
            patched.append(k)
    if not patched:
        return out, patched
    return ShardedTriTiles(off, diag, n, c).to_packed(), patched


def _differs(x, y, rtol: float, atol: float) -> bool:
    d = (x.float() - y.float()).abs()
    tol = atol + rtol * y.float().abs()
    return bool((torch.isnan(d) | (d > tol)).any())


# -- checked collectives ----------------------------------------------------
def _corrupt_packed(out: torch.Tensor, n: int, world: int, op: str,
                    step: Optional[int]) -> torch.Tensor:
    """Fault-injection hook: corrupt the armed device's row band of the
    packed payload (no-op without an active injector)."""
    sp = faults.payload_fault(f"collective:{op}", step)
    if sp is None:
        return out
    k = min(sp.device or 0, world - 1)
    r0, r1 = device_rows(n, world, k)
    return faults.corrupt_slots(out, tril_size(r0), tril_size(r1), sp,
                                f"collective:{op}", step)


def _corrupt_dense_rows(out: torch.Tensor, world: int, op: str,
                        step: Optional[int]) -> torch.Tensor:
    sp = faults.payload_fault(f"collective:{op}", step)
    if sp is None:
        return out
    n1, n2 = out.shape
    k = min(sp.device or 0, world - 1)
    r0, r1 = device_rows(n1, world, k)
    flat = faults.corrupt_slots(out.reshape(-1), r0 * n2, r1 * n2, sp,
                                f"collective:{op}", step)
    return flat.reshape(n1, n2)


def _checked(op: str, n: int, world: int, compute: Callable,
             corrupt: Callable, check: Callable, route: str,
             retries: int, backoff: float, reference, c,
             step: Optional[int]) -> Tuple[torch.Tensor, AbftReport]:
    report = AbftReport(op=op, route=route, n=n)
    delay = backoff
    for attempt in range(retries + 1):
        report.attempts = attempt + 1
        out = corrupt(compute(), step)
        bad_rows = torch.nonzero(check(out)).flatten().cpu().numpy()
        if bad_rows.size == 0:
            return out, report
        report.detected = True
        report.bad_rows = bad_rows[:16].tolist()
        report.devices = owner_of_rows(bad_rows, n, world)
        report.primary = owner_of_rows([int(bad_rows.max())], n,
                                       world)[0]
        if reference is not None and c is not None and op != "symm":
            repaired, patched = repair_with_reference(out, reference,
                                                      n, c)
            if patched and not bool(check(repaired).any()):
                report.action = "rebuild"
                report.devices = patched
                return repaired, report
        report.action = "retry"
        if attempt >= retries:
            break
        time.sleep(delay)
        delay *= 2.0
    raise AbftError(
        f"ABFT checksum mismatch on {op}/{route} (n={n}) not repaired "
        f"after {report.attempts} attempts — rows {report.bad_rows} "
        f"(devices {report.devices})", report)


def checked_syrk(a: torch.Tensor, *, route: str = "local", mesh=None,
                 axis: str = "x", c: Optional[int] = None,
                 p2: Optional[int] = None, chunk: Optional[int] = None,
                 retries: int = 2, backoff: float = 0.02,
                 rtol: Optional[float] = None, atol: float = DEFAULT_ATOL,
                 reference: Optional[torch.Tensor] = None,
                 step: Optional[int] = None
                 ) -> Tuple[torch.Tensor, AbftReport]:
    """ABFT-checked packed SYRK over any route.  Returns ``(packed,
    report)``; raises :class:`AbftError` when the checksum still fails
    after shard repair + ``retries`` recomputes."""
    n1, n2 = a.shape
    run = route_runner("syrk", route, mesh, axis, c, p2, chunk)
    chk = _check_syrk(n1, rtol if rtol is not None
                      else _default_rtol(n1, n2, a.dtype), atol)
    world = _route_world(route, mesh, axis, c, p2)
    return _checked(
        "syrk", n1, world, lambda: run(a),
        lambda o, s: _corrupt_packed(o, n1, world, "syrk", s),
        lambda o: chk(a, o), route, retries, backoff, reference, c, step)


def checked_syr2k(a: torch.Tensor, b: torch.Tensor, *,
                  route: str = "local", mesh=None, axis: str = "x",
                  c: Optional[int] = None, p2: Optional[int] = None,
                  chunk: Optional[int] = None, retries: int = 2,
                  backoff: float = 0.02, rtol: Optional[float] = None,
                  atol: float = DEFAULT_ATOL,
                  reference: Optional[torch.Tensor] = None,
                  step: Optional[int] = None
                  ) -> Tuple[torch.Tensor, AbftReport]:
    """ABFT-checked packed SYR2K (C·1 = A·(Bᵀ1) + B·(Aᵀ1))."""
    n1, n2 = a.shape
    run = route_runner("syr2k", route, mesh, axis, c, p2, chunk)
    chk = _check_syr2k(n1, rtol if rtol is not None
                       else _default_rtol(n1, n2, a.dtype), atol)
    world = _route_world(route, mesh, axis, c, p2)
    return _checked(
        "syr2k", n1, world, lambda: run(a, b),
        lambda o, s: _corrupt_packed(o, n1, world, "syr2k", s),
        lambda o: chk(a, b, o), route, retries, backoff, reference, c,
        step)


def checked_symm(a_packed: torch.Tensor, b: torch.Tensor, *,
                 route: str = "local", mesh=None, axis: str = "x",
                 c: Optional[int] = None, p2: Optional[int] = None,
                 chunk: Optional[int] = None, retries: int = 2,
                 backoff: float = 0.02, rtol: Optional[float] = None,
                 atol: float = DEFAULT_ATOL,
                 step: Optional[int] = None
                 ) -> Tuple[torch.Tensor, AbftReport]:
    """ABFT-checked SYMM (C = sym(S)·B, checksum C·1 = sym(S)·(B·1)).
    The symmetric operand is an input here, so repair is recompute."""
    n1, n2 = b.shape
    run = route_runner("symm", route, mesh, axis, c, p2, chunk)
    chk = _check_symm(n1, rtol if rtol is not None
                      else _default_rtol(n1, n2, b.dtype), atol)
    world = _route_world(route, mesh, axis, c, p2)
    return _checked(
        "symm", n1, world, lambda: run(a_packed, b),
        lambda o, s: _corrupt_dense_rows(o, world, "symm", s),
        lambda o: chk(a_packed, b, o), route, retries, backoff, None,
        None, step)
