"""``run_ranks`` on CPU gloo ranks: which rank a failed launch reports,
and when a rank may leave.

A launch fails the way a mesh run does when one rank dies of a Python
error: its peers lose it and abort (gloo, exit -6), and the rank that
failed may still be in its teardown.  The launch must quote the rank
that raised, whichever process ended first and however long its
teardown takes; and a rank that returned its result, then crashed in its
own teardown, fails nothing.  A rank that returned stays until every
rank's work has ended: one that left at once closed its sockets under a
peer still connecting a group that work had made (gloo's
``connectFullMesh``: "Connection closed by peer", ROADMAP queue C, C1).
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


def raise_then_peer_raises(mesh, slow: int, teardown_s: float):
    """Rank ``slow`` raises :class:`MarkedError` and takes ``teardown_s``
    to exit; every other rank raises too, a Python error, when its
    barrier breaks as rank ``slow`` leaves, and exits at once."""
    import torch.distributed as dist
    dist.barrier()                       # every rank is up
    if dist.get_rank() == slow:
        atexit.register(time.sleep, teardown_s)
        raise MarkedError(MARK)
    dist.barrier()                       # raises when rank ``slow`` leaves


def _stamp(path: str) -> None:
    with open(path, "w") as f:
        f.write(repr(time.time()))


def leaves_at_once_or_late(mesh, stamps: str, late_s: float):
    """Rank 1 returns at once and stamps its exit (``atexit``: after the
    launcher's teardown); rank 0 stamps the end of its work ``late_s``
    later."""
    import torch.distributed as dist
    if dist.get_rank() == 1:
        atexit.register(_stamp, os.path.join(stamps, "exit1"))
        return 1
    time.sleep(late_s)
    _stamp(os.path.join(stamps, "work0"))
    return 0


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


def test_a_teardown_past_the_grace_still_reports_the_rank_that_raised():
    """The rank that raised takes longer than ``FAIL_GRACE_S`` to tear
    down (a loaded host's slow exit, here an ``atexit`` sleep): it has
    said in its file that its work raised, so it is not killed at the
    grace's end, and the launch names it with its own exit code."""
    from repro_torch.distributed.launch import FAIL_GRACE_S
    with pytest.raises(RuntimeError) as e:
        run_ranks("test_torch_launch:raise_then_peer_aborts", 2,
                  device="cpu", paths=[TESTS], timeout=120,
                  kwargs={"slow": 1, "teardown_s": FAIL_GRACE_S + 3.0})
    msg = str(e.value)
    assert "failed on rank 1 of 2 (exit 1)" in msg, msg
    assert MARK in msg and "MarkedError" in msg, msg


def test_no_rank_leaves_before_every_rank_s_work_ended(tmp_path):
    """Rank 1's work returns at once, rank 0's 2 s later: rank 1's
    process ends after rank 0's work, not before it."""
    assert run_ranks("test_torch_launch:leaves_at_once_or_late", 2,
                     device="cpu", paths=[TESTS], timeout=120,
                     kwargs={"stamps": str(tmp_path),
                             "late_s": 2.0}) == [0, 1]
    work0 = float((tmp_path / "work0").read_text())
    exit1 = float((tmp_path / "exit1").read_text())
    assert exit1 >= work0, (exit1, work0)


def test_the_first_rank_to_raise_is_reported_before_its_peers():
    """A peer whose collective broke raises a Python error of its own
    (exit 1) and ends first, while the rank that raised first is still
    in its teardown: the launch names the rank that raised first."""
    with pytest.raises(RuntimeError) as e:
        run_ranks("test_torch_launch:raise_then_peer_raises", 2,
                  device="cpu", paths=[TESTS], timeout=120,
                  kwargs={"slow": 1, "teardown_s": 2.0})
    msg = str(e.value)
    assert "failed on rank 1 of 2 (exit 1)" in msg, msg
    assert MARK in msg and "MarkedError" in msg, msg
