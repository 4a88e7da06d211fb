"""Multi-tenant packed Gram/whitening serving cache (port of
:mod:`repro.launch.serving_cache`).

Per admitted request::

    update(tenant, arch, layer, feats)   # packed SYRK EMA (rank_update
                                         # kernel), bf16 storage
    factor(tenant, arch, layer)          # latest READY W, never blocks
    every `refresh_stride` updates: submit a refresh
          ▼  single-worker executor (off the decode loop)
    whitening_from_packed(snapshot)      # coupled NS on routed blas:
          ▼                              # SYMM/SYRK kernels
    factors[key] = W                     # harvested by the next factor()

One :class:`~repro_torch.optim.gram.GramMonitor` per (tenant, arch), the
layer name as its state key, so tenants never share statistics.  A
refresh closes over the packed state as it was at submit time (updates
replace the tensor, they never write into it), so a factor depends only
on the update stream.  Its CUDA work runs on the executor thread's
current stream, which is the device's default stream, the one the
decode loop uses too: the snapshot is complete before the refresh reads
it, and the factor is complete before decode reads it.

Cold starts warm from the packed checkpoints of
:mod:`repro_torch.distributed.checkpoint`: :meth:`ServingGramCache.save`
writes the EMA state as ``PackedTriangle`` leaves (bf16 triangle words)
with the (tenant, arch, layer) keying in the manifest's ``extra``, and
:meth:`ServingGramCache.warm_start` rebuilds the monitors from the
manifest alone, then schedules a refresh per key.  The files are the
reference's, so either package warm-starts from the other's cache.

Degradation, as in the reference: a failed refresh is retried
(:func:`with_retries`), then counted and fed to a per-key circuit
breaker that holds the last-good factor while open; a non-finite NS
factor falls back to the eigh oracle for that refresh; idle keys are
evicted after ``max_idle_s``.  The refresh is the ``serve:refresh``
fault site of :mod:`repro_torch.distributed.faults`.
"""
from __future__ import annotations

import functools
import logging
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..core.packing import PackedTriangle, tril_size
from ..device import DeviceLike, resolve_device
from ..distributed import faults
from ..distributed.checkpoint import (read_manifest, restore_checkpoint,
                                      save_checkpoint)
from ..distributed.resilience import with_retries
from ..optim.gram import GramMonitor, whitening_from_packed

Key = Tuple[str, str, str]          # (tenant, arch, layer)

logger = logging.getLogger(__name__)


class ServingGramCache:
    """Per-(tenant, arch, layer) packed Gram EMA + async whitening.

    ``refresh_stride``: schedule a refresh every that many updates per
    key; in-flight refreshes coalesce (one pending per key).
    ``synchronous=True`` runs each refresh inline at schedule time —
    same numerics, deterministic completion, same failure accounting.
    """

    def __init__(self, *, decay: float = 0.99, eps: float = 1e-5,
                 ns_iters: int = 30, refresh_stride: int = 8,
                 out_dtype: Optional[torch.dtype] = torch.bfloat16,
                 synchronous: bool = False, refresh_retries: int = 2,
                 refresh_backoff: float = 0.05, breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 30.0,
                 max_idle_s: Optional[float] = None):
        self.decay = decay
        self.eps = eps
        self.ns_iters = ns_iters
        self.refresh_stride = max(1, int(refresh_stride))
        self.out_dtype = out_dtype
        self.synchronous = synchronous
        self.refresh_retries = max(0, int(refresh_retries))
        self.refresh_backoff = refresh_backoff
        self.breaker_threshold = max(1, int(breaker_threshold))
        self.breaker_cooldown_s = breaker_cooldown_s
        self.max_idle_s = max_idle_s
        self._monitors: Dict[Tuple[str, str], GramMonitor] = {}
        self._factors: Dict[Key, torch.Tensor] = {}
        self._pending: Dict[Key, Future] = {}
        self._since_refresh: Dict[Key, int] = {}
        #: per-key [consecutive failures, breaker-open-until monotonic]
        self._breaker: Dict[Key, List[float]] = {}
        self._last_seen: Dict[Key, float] = {}
        self._lock = threading.Lock()
        self._pool = None if synchronous else \
            ThreadPoolExecutor(max_workers=1,
                               thread_name_prefix="gram-refresh")
        self.stats = {"updates": 0, "refreshes": 0, "factor_hits": 0,
                      "factor_cold": 0, "warm_loaded": 0,
                      "failed_refreshes": 0, "ns_fallbacks": 0,
                      "evicted": 0}
        #: seconds of each completed refresh, host clock around work that
        #: ends in a device sync (the finiteness check)
        self.refresh_seconds: List[float] = []

    # -- accumulation ----------------------------------------------------
    def monitor(self, tenant: str, arch: str) -> GramMonitor:
        mk = (str(tenant), str(arch))
        if mk not in self._monitors:
            self._monitors[mk] = GramMonitor(decay=self.decay,
                                             out_dtype=self.out_dtype)
        return self._monitors[mk]

    def update(self, tenant: str, arch: str, layer: str,
               x: torch.Tensor) -> None:
        """Fold features x (d, n_tokens) into the key's EMA — one routed
        packed SYRK — and schedule a refresh every ``refresh_stride``
        updates (:meth:`GramMonitor.update`: the fresh Gram and the EMA
        run in f32, only the stored triangle is narrowed)."""
        key = (str(tenant), str(arch), str(layer))
        self._evict_idle()
        self._last_seen[key] = time.monotonic()
        self.monitor(tenant, arch).update(layer, x)
        self.stats["updates"] += 1
        n = self._since_refresh.get(key, 0) + 1
        if n >= self.refresh_stride:
            scheduled = self._schedule_refresh(key)
            self._since_refresh[key] = 0 if scheduled else n
        else:
            self._since_refresh[key] = n

    # -- refresh ---------------------------------------------------------
    def _compute_factor(self, packed: torch.Tensor, d: int) -> torch.Tensor:
        faults.maybe_fail("serve:refresh")
        t0 = time.perf_counter()
        w = whitening_from_packed(packed, d, eps=self.eps, method="ns",
                                  iters=self.ns_iters)
        if not bool(torch.all(torch.isfinite(w))):
            self.stats["ns_fallbacks"] += 1
            logger.warning("serving_cache: non-finite NS factor (d=%d); "
                           "falling back to eigh oracle", d)
            w = whitening_from_packed(packed, d, eps=self.eps,
                                      method="eigh")
        if w.is_cuda:
            torch.cuda.synchronize(w.device)
        self.refresh_seconds.append(time.perf_counter() - t0)
        return w

    def _refresh_job(self, packed: torch.Tensor, d: int) -> torch.Tensor:
        return with_retries(self._compute_factor, packed, d,
                            retries=self.refresh_retries,
                            backoff=self.refresh_backoff,
                            retry_on=(Exception,))

    # -- circuit breaker -------------------------------------------------
    def _breaker_open(self, key: Key) -> bool:
        """True while the breaker blocks refreshes for ``key``; after the
        cooldown one half-open probe goes through."""
        with self._lock:
            st = self._breaker.get(key)
            if st is None or st[0] < self.breaker_threshold:
                return False
            if time.monotonic() < st[1]:
                return True
            st[0] = self.breaker_threshold - 1     # half-open probe
            return False

    def _note_refresh_failure(self, key: Key, exc: BaseException) -> None:
        self.stats["failed_refreshes"] += 1
        with self._lock:
            st = self._breaker.setdefault(key, [0, 0.0])
            st[0] += 1
            opened = st[0] >= self.breaker_threshold
            if opened:
                st[1] = time.monotonic() + self.breaker_cooldown_s
        logger.warning(
            "serving_cache: refresh failed for %s (%s: %s)%s",
            "/".join(key), type(exc).__name__, exc,
            "; circuit breaker OPEN — serving last-good factor"
            if opened else "")

    def _note_refresh_success(self, key: Key) -> None:
        with self._lock:
            self._breaker.pop(key, None)

    def _on_refresh_done(self, key: Key, fut: Future) -> None:
        exc = fut.exception()
        if exc is not None:
            self._note_refresh_failure(key, exc)

    def _schedule_refresh(self, key: Key) -> bool:
        """Submit a refresh unless one is pending (coalescing) or the
        breaker is open.  Returns True when a refresh was started."""
        tenant, arch, layer = key
        mon = self._monitors.get((tenant, arch))
        if mon is None or layer not in mon._state:
            return False
        if self._breaker_open(key):
            return False
        packed, d = mon._state[layer], mon._dims[layer]
        if self.synchronous:
            self.stats["refreshes"] += 1
            try:
                w = self._refresh_job(packed, d)
            except Exception as exc:           # same contract as async
                self._note_refresh_failure(key, exc)
                return True
            self._factors[key] = w
            self._note_refresh_success(key)
            return True
        with self._lock:
            if key in self._pending:
                return False
            fut = self._pool.submit(self._refresh_job, packed, d)
            self._pending[key] = fut
        fut.add_done_callback(functools.partial(self._on_refresh_done, key))
        self.stats["refreshes"] += 1
        return True

    def _harvest(self) -> None:
        """Install completed refreshes (non-blocking)."""
        with self._lock:
            done = [(k, f) for k, f in self._pending.items() if f.done()]
            for k, _ in done:
                del self._pending[k]
        for k, f in done:
            if f.exception() is not None:
                continue
            self._factors[k] = f.result()
            self._note_refresh_success(k)

    def factor(self, tenant: str, arch: str,
               layer: str) -> Optional[torch.Tensor]:
        """Latest ready factor for the key, or None while cold."""
        self._harvest()
        key = (str(tenant), str(arch), str(layer))
        self._last_seen[key] = time.monotonic()
        w = self._factors.get(key)
        self.stats["factor_hits" if w is not None else "factor_cold"] += 1
        return w

    def drain(self) -> None:
        """Block until every pending refresh has landed."""
        with self._lock:
            pending = list(self._pending.items())
            self._pending.clear()
        for k, f in pending:
            try:
                self._factors[k] = f.result()
            except Exception:                  # accounted by the callback
                continue
            self._note_refresh_success(k)

    def close(self) -> None:
        """Drain, then stop the refresh worker."""
        self.drain()
        if self._pool is not None:
            self._pool.shutdown(wait=True)

    # -- TTL eviction ----------------------------------------------------
    def evict(self, tenant: str, arch: str,
              layer: Optional[str] = None) -> int:
        """Drop EMA state, factor and bookkeeping for one layer, or all
        layers of the (tenant, arch); returns the number evicted."""
        mk = (str(tenant), str(arch))
        mon = self._monitors.get(mk)
        if mon is None:
            return 0
        layers = [str(layer)] if layer is not None else list(mon._state)
        n = 0
        for lay in layers:
            if lay not in mon._state:
                continue
            key = (mk[0], mk[1], lay)
            with self._lock:
                if key in self._pending:       # let in-flight land first
                    continue
                self._breaker.pop(key, None)
            mon._state.pop(lay, None)
            mon._dims.pop(lay, None)
            self._factors.pop(key, None)
            self._since_refresh.pop(key, None)
            self._last_seen.pop(key, None)
            n += 1
        if not mon._state:
            self._monitors.pop(mk, None)
        self.stats["evicted"] += n
        return n

    def _evict_idle(self) -> None:
        if self.max_idle_s is None:
            return
        now = time.monotonic()
        stale = [k for k, t in list(self._last_seen.items())
                 if now - t > self.max_idle_s]
        for tenant, arch, layer in stale:
            self.evict(tenant, arch, layer)

    # -- persistence -----------------------------------------------------
    def save(self, ckpt_dir: str, step: int = 0, **kw) -> None:
        """Write the EMA state as packed-native checkpoint leaves: one
        ``PackedTriangle`` ``g{i:04d}`` per (tenant, arch, layer) in
        sorted order, with the keying in the manifest's ``extra`` so
        :meth:`warm_start` needs no other schema.  ``kw`` goes to
        :func:`save_checkpoint`."""
        tree: Dict[str, PackedTriangle] = {}
        entries = []
        for (tenant, arch), mon in sorted(self._monitors.items()):
            for layer in sorted(mon._state):
                leaf = f"g{len(entries):04d}"
                tree[leaf] = PackedTriangle(mon._state[layer],
                                            mon._dims[layer])
                entries.append({"leaf": leaf, "tenant": tenant,
                                "arch": arch, "layer": layer,
                                "d": mon._dims[layer]})
        save_checkpoint(ckpt_dir, step, tree,
                        extra={"serving_cache": {
                            "entries": entries, "decay": self.decay}},
                        **kw)

    def warm_start(self, ckpt_dir: str, step: Optional[int] = None,
                   refresh: bool = True, device: DeviceLike = None) -> int:
        """Restore the EMA state of a :meth:`save` checkpoint, found
        through its manifest alone, onto ``device`` (None: the GPU, which
        raises without one), then (by default) schedule a refresh per
        restored key.  Returns the number of restored (tenant, arch,
        layer) entries."""
        dev = resolve_device(device)
        entries = read_manifest(ckpt_dir, step)["extra"]["serving_cache"][
            "entries"]
        store = self.out_dtype or torch.float32
        like = {e["leaf"]: PackedTriangle(
            torch.zeros(tril_size(e["d"]), dtype=store, device=dev),
            e["d"]) for e in entries}
        _, tree = restore_checkpoint(ckpt_dir, like, step=step)
        for e in entries:
            mon = self.monitor(e["tenant"], e["arch"])
            leaf = tree[e["leaf"]]
            mon._state[e["layer"]] = leaf.vec.to(store)
            mon._dims[e["layer"]] = leaf.n
            key = (e["tenant"], e["arch"], e["layer"])
            self._since_refresh[key] = 0
            self._last_seen[key] = time.monotonic()
            if refresh:
                self._schedule_refresh(key)
        self.stats["warm_loaded"] += len(entries)
        return len(entries)

    def snapshot_stats(self) -> Dict[str, Any]:
        now = time.monotonic()
        with self._lock:
            pending = len(self._pending)
            stale = sorted("/".join(k) for k, st in self._breaker.items()
                           if st[0] >= self.breaker_threshold
                           and now < st[1])
        return dict(self.stats, pending=pending,
                    factors_ready=len(self._factors),
                    keys=sum(len(m._state)
                             for m in self._monitors.values()),
                    stale=stale)
