"""The program's counters and spans.

Counters: each kernel wrapper and each plain version carries a ``launches``
attribute, which ``count`` adds one to where the wrapper launches its
kernel (or the plain version runs).  The viewer and the production loop
render on a thread of their own, and a caller may launch from several, so
the add holds a lock: ``+=`` on an attribute is a read, an add and a write,
and two threads can lose one of their counts.

Spans: ``span(name, **attrs)`` records a span of host time where the work
happens (the renderer's call, a band's set-up, one launch of the grid or
paged driver, the scene's generation and tables), and ``section(name)``
marks a part of one; ``log`` adds a span timed by its caller, and
``current`` is the innermost span open on the thread, for a callee to set
attributes on.  They record only while torch's profiler runs; with it
off a span reads one flag and does nothing else.  With it on, a span
appends a ``Record`` to an in-memory log (``records``) and both open a
profiler range named ``rt.<name>``, which a trace shows nested under the
torch ops beside them.  The range is a plain function range
(``_RecordFunctionFast``), not a user annotation, so the profiler does not
copy it onto the device's timeline, where it would count as device time.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time

import torch
import torch.autograd.profiler as _profiler

_LOCK = threading.Lock()

# the oldest records are dropped past this many, so a profiler left running
# in a long-lived process holds a bounded log
MAX_RECORDS = 1 << 20
_LOG = collections.deque(maxlen=MAX_RECORDS)
_IDS = itertools.count(1)
_OPEN = threading.local()  # .stack: this thread's open spans' records
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None)


def count(fn, variant=None) -> None:
    """Add one to ``fn.launches``, and with ``variant`` (the name of a probe
    switch set, ops/gridkernel.py ``SWITCHES``) to
    ``fn.variant_launches[variant]``."""
    with _LOCK:
        fn.launches += 1
        if variant:
            fn.variant_launches[variant] = fn.variant_launches.get(variant, 0) + 1


if hasattr(_profiler, "_is_profiler_enabled"):
    def recording() -> bool:
        """True while torch's profiler runs: the spans' one gate."""
        return _profiler._is_profiler_enabled
else:
    recording = torch._C._autograd._profiler_enabled


class Record:
    """One span: its name, start and end on ``time.perf_counter``, its id,
    the id of the innermost span open around it on its thread (None at the
    top), and its attributes."""

    __slots__ = ("name", "t0", "t1", "id", "parent", "attrs")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs
        self.t0 = self.t1 = self.id = self.parent = None

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def stamp(self, key: str) -> None:
        """Set attribute ``key`` to the time now."""
        self.attrs[key] = time.perf_counter()


class _NoRecord:
    """What a span yields while nothing records: every write is dropped."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def stamp(self, key: str) -> None:
        pass


NO_RECORD = _NoRecord()


class _Off:
    __slots__ = ()

    def __enter__(self):
        return NO_RECORD

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("rec", "range", "log")

    def __init__(self, name, attrs, log):
        self.rec = Record(name, attrs) if log else None
        self.log = log
        self.range = None if _RANGE is None else _RANGE("rt." + name)

    def __enter__(self):
        if self.range is not None:
            self.range.__enter__()
        if not self.log:
            return NO_RECORD
        rec = self.rec
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        with _LOCK:
            rec.id = next(_IDS)
        rec.parent = stack[-1].id if stack else None
        stack.append(rec)
        rec.t0 = time.perf_counter()
        return rec

    def __exit__(self, *exc):
        if self.log:
            rec = self.rec
            rec.t1 = time.perf_counter()
            _OPEN.stack.pop()
            with _LOCK:
                _LOG.append(rec)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str, **attrs):
    """A context manager around a span of work named ``name``: while the
    profiler runs it logs a ``Record`` with ``attrs`` and yields it, so the
    caller can set more attributes inside (``rec.set``, ``rec.stamp``), and
    opens the profiler range ``rt.<name>``; otherwise it yields
    ``NO_RECORD``, which drops what is set on it."""
    if not recording():
        return _OFF
    return _Span(name, attrs, True)


def section(name: str):
    """A part of a span: the profiler range ``rt.<name>`` while the
    profiler runs, and no record."""
    if not recording():
        return _OFF
    return _Span(name, None, False)


def current():
    """The innermost span open on this thread while the profiler runs, so a
    callee can set attributes on its caller's span; otherwise
    ``NO_RECORD``."""
    stack = getattr(_OPEN, "stack", None)
    return stack[-1] if stack and recording() else NO_RECORD


def log(name: str, t0: float, t1: float, **attrs) -> None:
    """Log a span whose ends the caller took on ``time.perf_counter``
    itself, under the innermost span open on this thread: for spans that
    overlap on one thread, as the bands stepped in turns do.  It opens no
    profiler range; nothing is logged while the profiler is off."""
    if not recording():
        return
    rec = Record(name, attrs)
    rec.t0, rec.t1 = t0, t1
    stack = getattr(_OPEN, "stack", None)
    rec.parent = stack[-1].id if stack else None
    with _LOCK:
        rec.id = next(_IDS)
        _LOG.append(rec)


def records(t0=None, t1=None) -> list:
    """The logged spans that lie inside [``t0``, ``t1``] (either end open
    when None), on ``time.perf_counter``, in the order they ended."""
    with _LOCK:
        out = list(_LOG)
    return [r for r in out if (t0 is None or r.t0 >= t0) and (t1 is None or r.t1 <= t1)]
