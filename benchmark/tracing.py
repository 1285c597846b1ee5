"""Spans around the calls into the program, and the device trace.

``Spans`` records host durations of the benchmark's own spans (the frame
loop's scene generation, ``set_scene``, the render call, the read-back);
in a traced run each span is also a ``torch.profiler.record_function``
range named ``bench.<span>``, so the trace can say what the host was doing
in each of the device's idle gaps.  ``DeviceTrace`` runs ``torch.profiler``
(CUPTI) over a sub-window and reduces it in memory to device busy time,
per-kernel time, per-device spans and the idle gaps by host span; nothing
is written to disk.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict

PREFIX = "bench."
TOP = 10


class Spans:
    """Host durations (seconds) per span name."""

    def __init__(self, profiled: bool = False):
        self.durations = defaultdict(list)
        self.profiled = profiled

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        if self.profiled:
            import torch

            with torch.profiler.record_function(PREFIX + name):
                yield
        else:
            yield
        self.durations[name].append(time.perf_counter() - t0)


def _merge(intervals):
    """Union of [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class _Innermost:
    """The innermost interval of a set that contains a point."""

    def __init__(self, intervals):
        self.items = sorted(intervals)  # (start, end, name)
        self.starts = [s for s, _, _ in self.items]

    def at(self, x, look_back: int = 64):
        i = bisect.bisect_right(self.starts, x)
        for j in range(i - 1, max(-1, i - 1 - look_back), -1):
            s, e, name = self.items[j]
            if e >= x:
                return name
        return None


def summarize(device_events, host_events, window) -> dict:
    """Reduce a trace: ``device_events`` [(device, name, start, end)] and
    ``host_events`` [(name, start, end)], times in microseconds on one
    clock, ``window`` (start, end).  Returns the window's length, each
    device's busy time (the union of its operations), first and last
    operation, the device time of each operation name, and the device's
    idle gaps summed by the benchmark span (and the innermost host op)
    running at each gap's middle."""
    w0, w1 = window
    per_dev = defaultdict(list)
    by_name = defaultdict(float)
    for dev, name, s, e in device_events:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        per_dev[dev].append((s, e))
        by_name[name] += (e - s) * 1e-6
    spans = _Innermost([(s, e, n[len(PREFIX):]) for n, s, e in host_events
                        if n.startswith(PREFIX) and n != PREFIX + "trace_window"])
    ops = _Innermost([(s, e, n) for n, s, e in host_events if n.startswith(("aten::", "cuda"))])
    gaps = defaultdict(float)
    devices = {}
    for dev, iv in per_dev.items():
        merged = _merge(iv)
        busy = sum(e - s for s, e in merged)
        devices[dev] = dict(busy_s=busy * 1e-6, first_us=merged[0][0], last_us=merged[-1][1])
        edges = [w0] + [x for s, e in merged for x in (s, e)] + [w1]
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            if g1 > g0:
                mid = 0.5 * (g0 + g1)
                label = spans.at(mid) or "outside the benchmark's spans"
                op = ops.at(mid)
                gaps[f"{label} / {op}" if op else label] += (g1 - g0) * 1e-6
    window_s = (w1 - w0) * 1e-6
    busy = [d["busy_s"] for d in devices.values()]
    return dict(
        window_s=window_s,
        busy_s=sum(busy) / len(busy) if busy else 0.0,
        devices=devices,
        kernels=dict(by_name),
        breakdown=dict(
            device_ops=[[n[:160], s] for n, s in sorted(by_name.items(), key=lambda x: -x[1])[:TOP]],
            idle_gaps=[[n[:160], s] for n, s in sorted(gaps.items(), key=lambda x: -x[1])[:TOP]]),
    )


class DeviceTrace:
    """``torch.profiler`` over ``start()`` .. ``stop()``; ``stop`` waits for
    the devices and returns ``summarize``'s dict."""

    def __init__(self, devices):
        self.devices = list(devices)
        self.prof = None

    def start(self) -> None:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if any(d.type == "cuda" for d in self.devices):
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self._window = torch.profiler.record_function(PREFIX + "trace_window")
        self._window.__enter__()

    def stop(self) -> dict:
        import torch

        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        self._window.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        dev_ev, host_ev, window = [], [], None
        for e in self.prof.events():
            s, t = e.time_range.start, e.time_range.end
            if e.device_type == torch.autograd.DeviceType.CUDA:
                # the spans' own ranges are mirrored on the device's
                # timeline; they are annotations, not device work
                if not e.name.startswith(PREFIX):
                    dev_ev.append((e.device_index, e.name, s, t))
            elif e.name == PREFIX + "trace_window":
                window = (s, t)
            else:
                host_ev.append((e.name, s, t))
        if window is None:
            raise RuntimeError("the trace lost its window span")
        return summarize(dev_ev, host_ev, window)
