"""Launch counters of the kernel wrappers and their plain versions.

Each wrapper and each plain version carries a ``launches`` attribute, which
``count`` adds one to where the wrapper launches its kernel (or the plain
version runs).  The viewer and the production loop render on a thread of
their own, and a caller may launch from several, so the add holds a lock:
``+=`` on an attribute is a read, an add and a write, and two threads can
lose one of their counts.
"""

from __future__ import annotations

import threading

_LOCK = threading.Lock()


def count(fn) -> None:
    """Add one to ``fn.launches``."""
    with _LOCK:
        fn.launches += 1
