"""Deterministic, seeded fault injection for chaos tests (port of
:mod:`repro.distributed.faults`).

A fault is a :class:`FaultSpec` keyed by ``(site, step, device)``:

  * ``site`` — a named injection point in the production code paths:
    ``"ckpt:fsync"`` / ``"ckpt:rename"`` (checkpoint commit protocol),
    ``"serve:refresh"`` (whitening refresh executor); the reference's
    ``"collective:*"`` and ``"train:*"`` sites have no caller in the
    port yet.
  * ``kind`` — ``error`` (raise :class:`FaultError`), ``kill`` (raise
    :class:`DeviceLossError`), ``delay`` (sleep ``delay_s``),
    ``bitflip`` / ``nan`` (corrupt packed payload words, applied by the
    caller through :func:`corrupt_slots`, whose rng is keyed by (seed,
    site, step, device) so the corruption is byte-reproducible).

A spec fires at most ``times`` times (default 1: faults are transient,
so a retry succeeds; ``0`` means always) after skipping its first
``skip`` matches.  It is armed by the :class:`inject` context manager or
by the ``REPRO_FAULTS`` environment variable (a JSON list of spec dicts;
``REPRO_FAULTS_SEED`` seeds the corruption rng): the names are the
reference's, so one environment drives either package.  Matching is
thread-safe; every firing is recorded on the injector's ``events``.
"""
from __future__ import annotations

import json
import os
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

ENV_SPECS = "REPRO_FAULTS"
ENV_SEED = "REPRO_FAULTS_SEED"

KINDS = ("error", "kill", "delay", "bitflip", "nan")
#: kinds that corrupt data in place instead of raising/sleeping
PAYLOAD_KINDS = ("bitflip", "nan")


class FaultError(OSError):
    """An injected fault (an OSError: the sites that raise it simulate
    transient I/O / executor errors, so ``retry on OSError`` policies
    see the injected kind)."""


class DeviceLossError(FaultError):
    """An injected device/host loss."""


@dataclass
class FaultSpec:
    site: str
    kind: str = "error"
    step: Optional[int] = None      # None = any step
    device: Optional[int] = None    # payload faults: whose contribution
    times: int = 1                  # max firings (0 = unlimited)
    skip: int = 0                   # ignore the first `skip` matches
    delay_s: float = 0.05           # kind="delay" sleep
    message: str = ""
    matched: int = field(default=0, compare=False)
    fired: int = field(default=0, compare=False)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {KINDS})")


@dataclass
class FaultEvent:
    site: str
    kind: str
    step: Optional[int]
    device: Optional[int]
    detail: str = ""


class FaultInjector:
    """Armed specs and the firing log: one per :class:`inject` context,
    or one process-wide instance built from the environment."""

    def __init__(self, specs: Sequence[FaultSpec], seed: int = 0):
        self.specs = [s if isinstance(s, FaultSpec) else FaultSpec(**s)
                      for s in specs]
        self.seed = int(seed)
        self.events: List[FaultEvent] = []
        self._lock = threading.Lock()

    def match(self, site: str, step: Optional[int] = None,
              kinds: Optional[Sequence[str]] = None
              ) -> Optional[FaultSpec]:
        """Consume one firing of the first armed spec matching
        ``(site, step)`` (and ``kinds`` when given)."""
        with self._lock:
            for sp in self.specs:
                if sp.site != site:
                    continue
                if kinds is not None and sp.kind not in kinds:
                    continue
                if sp.step is not None and step is not None \
                        and sp.step != step:
                    continue
                if sp.matched < sp.skip:
                    sp.matched += 1
                    continue
                if sp.times and sp.fired >= sp.times:
                    continue
                sp.matched += 1
                sp.fired += 1
                return sp
        return None

    def record(self, spec: FaultSpec, step: Optional[int],
               detail: str = "") -> FaultEvent:
        ev = FaultEvent(site=spec.site, kind=spec.kind, step=step,
                        device=spec.device, detail=detail)
        with self._lock:
            self.events.append(ev)
        return ev

    def rng(self, site: str, step: Optional[int],
            device: Optional[int]) -> np.random.Generator:
        """A numpy Generator keyed by (seed, site, step, device): the
        corruption is a pure function of the fault's coordinates (crc32,
        not ``hash``: stable across runs and PYTHONHASHSEED)."""
        key = zlib.crc32(f"{self.seed}|{site}|{step}|{device}".encode())
        return np.random.default_rng(key)


# -- activation -------------------------------------------------------------
_STACK: List[FaultInjector] = []
_STACK_LOCK = threading.Lock()
_ENV_CACHE: Tuple[Optional[str], Optional[FaultInjector]] = (None, None)


def _env_injector() -> Optional[FaultInjector]:
    global _ENV_CACHE
    raw = os.environ.get(ENV_SPECS)
    if not raw:
        return None
    if _ENV_CACHE[0] != raw:
        specs = [FaultSpec(**d) for d in json.loads(raw)]
        seed = int(os.environ.get(ENV_SEED, "0"))
        _ENV_CACHE = (raw, FaultInjector(specs, seed=seed))
    return _ENV_CACHE[1]


def active() -> Optional[FaultInjector]:
    """The innermost :class:`inject` context, else the ``REPRO_FAULTS``
    injector, else None."""
    with _STACK_LOCK:
        if _STACK:
            return _STACK[-1]
    return _env_injector()


class inject:
    """``with inject(FaultSpec(...), seed=7) as inj: ...`` arms faults
    for the enclosed block; ``inj.events`` holds what fired."""

    def __init__(self, *specs: FaultSpec, seed: int = 0):
        self.injector = FaultInjector(specs, seed=seed)

    def __enter__(self) -> FaultInjector:
        with _STACK_LOCK:
            _STACK.append(self.injector)
        return self.injector

    def __exit__(self, *exc):
        with _STACK_LOCK:
            _STACK.remove(self.injector)
        return False


def env_dict(specs: Sequence[FaultSpec], seed: int = 0) -> dict:
    """Environment form of ``specs`` for a subprocess chaos run."""
    return {ENV_SPECS: json.dumps([
        {"site": s.site, "kind": s.kind, "step": s.step,
         "device": s.device, "times": s.times, "skip": s.skip,
         "delay_s": s.delay_s, "message": s.message}
        for s in (s if isinstance(s, FaultSpec) else FaultSpec(**s)
                  for s in specs)]),
        ENV_SEED: str(int(seed))}


# -- firing -----------------------------------------------------------------
def maybe_fail(site: str, step: Optional[int] = None) -> None:
    """Host fault site: raise (``error`` / ``kill``) or sleep
    (``delay``) when a matching spec is armed; no-op otherwise.  Payload
    kinds never fire here (see :func:`payload_fault`)."""
    inj = active()
    if inj is None:
        return
    sp = inj.match(site, step, kinds=("error", "kill", "delay"))
    if sp is None:
        return
    if sp.kind == "delay":
        inj.record(sp, step, detail=f"slept {sp.delay_s}s")
        time.sleep(sp.delay_s)
        return
    msg = sp.message or (
        f"injected device loss at {site}"
        + (f" (device {sp.device})" if sp.device is not None else "")
        + (f" step {step}" if step is not None else "")
        if sp.kind == "kill" else
        f"injected fault at {site}"
        + (f" step {step}" if step is not None else ""))
    inj.record(sp, step, detail=msg)
    raise (DeviceLossError if sp.kind == "kill" else FaultError)(msg)


def payload_fault(site: str, step: Optional[int] = None
                  ) -> Optional[FaultSpec]:
    """Consume an armed ``bitflip`` / ``nan`` spec for a payload site;
    the caller maps ``spec.device`` to its slot range and applies
    :func:`corrupt_slots`."""
    inj = active()
    if inj is None:
        return None
    return inj.match(site, step, kinds=PAYLOAD_KINDS)


#: bf16 bits of a quiet NaN of either sign, as ``ml_dtypes`` rounds any
#: f32 NaN (payload dropped, sign kept)
_BF16_QNAN = np.uint16(0x7FC0)
_BF16_SIGN = np.uint16(0x8000)


def _bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _f32_to_bf16(x: np.ndarray) -> np.ndarray:
    """f32 -> bf16 bits, rounded to nearest-even as ``ml_dtypes`` does."""
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    out = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)
    nan = np.isnan(x)
    out[nan] = _BF16_QNAN | (_BF16_SIGN * np.signbit(x[nan]))
    return out


def corrupt_slots(vec: torch.Tensor, lo: int, hi: int, spec: FaultSpec,
                  site: str, step: Optional[int] = None) -> torch.Tensor:
    """Deterministically corrupt packed payload words ``[lo, hi)``.

    ``bitflip`` flips a high exponent bit (bit 30 of the word as f32) of
    up to 8 seeded slots in the range; ``nan`` poisons one seeded slot.
    Returns a new tensor on ``vec``'s device and dtype (the input is
    never written) and records the event.  The host copy goes through
    numpy as the reference's does; bf16 words (which numpy lacks) are
    handled as their bits, with the reference's ``ml_dtypes`` rounding.
    """
    inj = active()
    rng = (inj or FaultInjector([], seed=0)).rng(site, step, spec.device)
    src = vec.detach().cpu()
    bf16 = src.dtype == torch.bfloat16
    host = (src.view(torch.int16) if bf16 else src).numpy().copy()
    if bf16:
        host = host.view(np.uint16)
    width = max(hi - lo, 1)
    if spec.kind == "nan":
        slots = lo + rng.integers(0, width, size=1)
        host[slots] = _BF16_QNAN if bf16 else np.nan
    else:
        slots = lo + rng.choice(width, size=min(8, width), replace=False)
        as_f32 = _bf16_to_f32(host[slots]) if bf16 \
            else host[slots].astype(np.float32)
        flipped = (as_f32.view(np.uint32) ^ np.uint32(1 << 30)) \
            .view(np.float32)
        host[slots] = _f32_to_bf16(flipped) if bf16 \
            else flipped.astype(host.dtype)
    if inj is not None:
        inj.record(spec, step, detail=f"{spec.kind} slots "
                   f"{np.sort(slots).tolist()} of [{lo},{hi})")
    out = torch.from_numpy(host.view(np.int16) if bf16 else host)
    if bf16:
        out = out.view(torch.bfloat16)
    return out.to(vec.device)
