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


def count(fn, variant=None) -> None:
    """Add one to ``fn.launches``, and with ``variant`` (the name of a probe
    switch set, ops/gridkernel.py ``SWITCHES``) to
    ``fn.variant_launches[variant]``."""
    with _LOCK:
        fn.launches += 1
        if variant:
            fn.variant_launches[variant] = fn.variant_launches.get(variant, 0) + 1
