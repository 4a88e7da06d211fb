"""``run_ranks`` on CPU gloo ranks: which rank a failed launch reports.

A launch fails the way a mesh run does when one rank dies of a Python
error: its peers lose it and abort (gloo, exit -6), and the rank that
failed may still be in its teardown.  The launch must quote the rank
that raised, whichever process ended first; and a rank that returned its
result, then crashed in its own teardown, fails nothing.
"""
import atexit
import os
import time

import pytest

from repro_torch.distributed.launch import _first_failure, run_ranks
from test_torch_hygiene import limit_torch_threads  # noqa: F401

TESTS = os.path.dirname(os.path.abspath(__file__))
MARK = "marked failure of the slow rank"


class MarkedError(RuntimeError):
    pass


def raise_then_peer_aborts(mesh, slow: int, teardown_s: float):
    """Rank ``slow`` raises :class:`MarkedError` and then takes
    ``teardown_s`` to exit (an ``atexit`` sleep, after the launcher's
    ``destroy_process_group`` has closed its sockets); every other rank
    aborts as soon as its collective with that rank breaks."""
    import torch.distributed as dist
    dist.barrier()                       # every rank is up
    if dist.get_rank() == slow:
        atexit.register(time.sleep, teardown_s)
        raise MarkedError(MARK)
    try:
        dist.barrier()                   # breaks when rank ``slow`` leaves
    finally:
        os.abort()


def returns_then_aborts(mesh, crash: int):
    """Every rank returns its rank; rank ``crash`` then aborts in its
    teardown, after the launcher wrote its result."""
    import torch.distributed as dist
    if dist.get_rank() == crash:
        atexit.register(os.abort)
    return dist.get_rank()


@pytest.mark.parametrize("world,slow", [(2, 1), (3, 2), (3, 0)])
def test_the_rank_that_raised_is_reported(world, slow):
    """The peers abort first (exit -6) while the rank that raised is
    still in its teardown: the error names that rank and quotes its
    exception, not a peer's abort."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as e:
        run_ranks("test_torch_launch:raise_then_peer_aborts", world,
                  device="cpu", paths=[TESTS], timeout=120,
                  kwargs={"slow": slow, "teardown_s": 2.0})
    msg = str(e.value)
    assert f"failed on rank {slow} of {world} (exit 1)" in msg, msg
    assert MARK in msg and "MarkedError" in msg, msg
    assert time.monotonic() - t0 < 60


def test_a_crash_after_the_result_fails_nothing():
    """Rank 0 aborts after its result is written (exit -6): the launch
    returns every rank's result."""
    assert run_ranks("test_torch_launch:returns_then_aborts", 3,
                     device="cpu", paths=[TESTS], timeout=120,
                     kwargs={"crash": 0}) == [0, 1, 2]


@pytest.mark.parametrize("exits,codes,want", [
    ([0, 1], [-6, 1], 1),          # the Python error, though it ended last
    ([2, 0], [-6, 0, -6], 2),      # no Python error: the first to end
    ([1], [-9, -6, 0], 1),         # rank 0 was killed, rank 1 ended first
    ([], [0, -9], 1),              # only killed ranks
])
def test_first_failure_prefers_a_python_error(exits, codes, want):
    assert _first_failure(exits, codes) == want
