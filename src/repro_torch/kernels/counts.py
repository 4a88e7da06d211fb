"""The port's kernel launch counts, in one place.

Each wrapper keeps its own count in a plain integer attribute
(``trigrid.rank_update.launches``, ``trigrid.sym_stream.launches``,
``slstm.slstm_scan.launches``), incremented by ``native.count_launch``
only where its kernel is launched.  A run sets them all to 0 with
:func:`reset_launch_counts` and reads them with :func:`launch_counts`
to show that its path went through the kernels.
"""
from __future__ import annotations

from typing import Dict

from . import native, slstm, trigrid

#: every kernel wrapper of the port, in the order reports list them
WRAPPERS = (trigrid.rank_update, trigrid.sym_stream, slstm.slstm_scan)


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    native.zero_launch_counts(WRAPPERS)


def launch_counts() -> Dict[str, int]:
    """Launch count of every kernel wrapper, by name."""
    return native.read_launch_counts(WRAPPERS)
