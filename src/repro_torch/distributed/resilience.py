"""Retry policy for transient failures (port of the retry half of
:mod:`repro.distributed.resilience`).

:func:`with_retries` wraps the checkpoint commit protocol's I/O sites
(``fsync`` / ``rename``) and the serving cache's whitening refreshes.
The ABFT checksums and the ``checked_*`` mesh routes are not ported.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Optional


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
