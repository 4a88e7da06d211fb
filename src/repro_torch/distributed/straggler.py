"""Straggler mitigation: per-step timing, robust outlier detection, and
an escalation policy.

In a synchronous SPMD job a slow host delays EVERY step (the collective
waits), so detection is host-local timing + a shared policy.  The
monitor below implements the standard telemetry:

  * rolling median / MAD of step wall-times,
  * a straggler event when ``k`` of the last ``window`` steps exceed
    ``threshold × median``,
  * escalation: first ``warn``, then ``checkpoint`` (pre-emptive), then
    ``evict`` (tell the scheduler to drop the slow host and restart
    elastically — see elastic.py).

The same object doubles as the step timer used by launch/train.py.

Port of :mod:`repro.distributed.straggler` (pure Python);
``rebuild_replacement_shard`` waits for the distributed-state slice.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, List, Optional


@dataclass
class StragglerEvent:
    step: int
    step_time: float
    median: float
    ratio: float
    action: str            # warn | checkpoint | evict


class StragglerMonitor:
    def __init__(self, *, window: int = 64, threshold: float = 2.0,
                 patience: int = 3, warmup: int = 8):
        self.window = window
        self.threshold = threshold
        self.patience = patience
        self.warmup = warmup
        self._times: Deque[float] = deque(maxlen=window)
        self._consecutive = 0
        self._escalation = 0
        self.events: List[StragglerEvent] = []

    @staticmethod
    def _median(xs) -> float:
        s = sorted(xs)
        n = len(s)
        return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])

    def record(self, step: int, seconds: float
               ) -> Optional[StragglerEvent]:
        """Feed one step time; returns an event when action is needed."""
        prior = list(self._times)
        self._times.append(seconds)
        if len(prior) < self.warmup:
            return None
        med = self._median(prior)
        if med <= 0:
            return None
        ratio = seconds / med
        if ratio < self.threshold:
            self._consecutive = 0
            return None
        self._consecutive += 1
        if self._consecutive < self.patience:
            return None
        self._consecutive = 0
        action = ("warn", "checkpoint", "evict")[min(self._escalation, 2)]
        self._escalation += 1
        ev = StragglerEvent(step=step, step_time=seconds, median=med,
                            ratio=ratio, action=action)
        self.events.append(ev)
        return ev

    def summary(self) -> dict:
        ts = list(self._times)
        if not ts:
            return {"steps": 0}
        return {"steps": len(ts), "median_s": self._median(ts),
                "max_s": max(ts), "events": len(self.events)}


class StepTimer:
    """``with timer: step()`` → timer.last / feeds a monitor."""

    def __init__(self, monitor: Optional[StragglerMonitor] = None):
        self.monitor = monitor
        self.last = 0.0
        self._step = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.last = time.perf_counter() - self._t0
        self._step += 1
        if self.monitor is not None:
            self.event = self.monitor.record(self._step, self.last)
        else:
            self.event = None
        return False
