"""Device selection and per-device dispatch.

Port of ``raytrace_tpu/parallel/devices.py`` (the analogue of the
reference's ``pick_physical_devices``, vulkan.h:68-110, truncated to
``--gpus`` at ray_trace.cpp:954-956), plus the dispatch the JAX package gets
from asynchronous arrays: ``run_in_turns`` steps every device's band from
the calling thread, each one again as soon as its last launch completes.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Callable, Generator, List, Optional, Sequence

import torch

from ..ops import launches
from ..runtime.renderer import render_device

_LOCK = threading.Lock()


def pick_devices(count: Optional[int] = None, device_type: str = "cuda") -> List[torch.device]:
    """The devices of ``device_type``, deduplicated by index and truncated to
    ``count``; never more than exist (``pick_devices(99)`` returns what
    there is).  "cuda" without a CUDA device raises like the renderer;
    there is no fallback to the CPU.  "cpu" is the one CPU device."""
    if device_type == "cpu":
        devices = [torch.device("cpu")]
    elif device_type == "cuda":
        render_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        raise ValueError(f"unknown device type: {device_type!r} (cuda|cpu)")
    out, seen = [], set()
    for d in devices:
        if (d.type, d.index) not in seen:
            seen.add((d.type, d.index))
            out.append(d)
    return out if count is None else out[:count]  # truncate, not elastic


def run_in_turns(devices: Sequence, steps: Callable[[int], Generator]):
    """Run ``steps(i)``, a generator of steps such as
    ``ops/trace.render_band_steps``, for every ``devices[i]``, all from the
    calling thread.  Each step issues its band's next launch and yields what
    it issued: on a CUDA device an event recorded after the launch on the
    band's own stream (``band_streams``, which first waits for the calling
    stream, where the scene tables and the accumulator were put); None where
    the step's work is done when it returns (the CPU).  A band is stepped
    again only once its event has completed, so the host never waits on one
    band's launch while another band's launch could be issued: the driver's
    host sync at the top of its next step finds its launch done, a fast
    device's band runs on while a slow device's launch is in flight, and
    each band's completion time ends with its own device's work.  Returns
    (each generator's return value, seconds from the start to each one's
    completion; on a CUDA device its stream synchronised).  An error of any
    step is raised at once.

    While the profiler runs, each band logs a ``bands.band`` span (its
    ``device`` index, its number of ``steps`` and the attributes
    ``steps.band_attrs(i)`` gives, where ``steps`` has that method), from
    its first step's issue to its completion, and the span open around the
    call gets ``host_step_s``, the seconds spent inside the bands' steps,
    and ``idle_passes``, the passes in which every band's launch was in
    flight (``ops/launches.py``).

    The port's drivers read their live count on the host once per launch, so
    a band cannot be issued now and fetched later, as JAX issues one.
    Polling the bands from one thread overlaps them without a thread per
    band: on threads, four host loops of small torch ops hand the
    interpreter lock back and forth, which made four bands of one card nine
    times slower than the whole frame (``PERF.md``, Findings)."""
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    results: list = [None] * n
    done_s = [0.0] * n
    traced = launches.recording()
    first = [None] * n  # each band's first step's issue
    n_steps = [0] * n
    host_s, idle = 0.0, 0
    t0 = time.perf_counter()
    gens = [steps(i) for i in range(n)]
    streams = band_streams(devices)
    for i, dev in enumerate(devices):
        if streams[i] is not None:
            streams[i].wait_stream(torch.cuda.current_stream(dev))
    issued = [None] * n  # each band's launch in flight, if any
    running = list(range(n))
    while running:
        stepped = False
        for i in list(running):
            if issued[i] is not None and not issued[i].query():
                continue
            stepped = True
            with _on(devices[i], streams[i]):
                if traced:
                    t_step = time.perf_counter()
                    if first[i] is None:
                        first[i] = t_step
                try:
                    issued[i] = next(gens[i])
                    n_steps[i] += 1
                    continue
                except StopIteration as stop:
                    results[i] = stop.value
                finally:
                    if traced:
                        host_s += time.perf_counter() - t_step
                if streams[i] is not None:
                    streams[i].synchronize()
            done_s[i] = time.perf_counter() - t0
            running.remove(i)
        if not stepped:
            idle += 1
            time.sleep(0)  # every band's launch is in flight
    if traced:
        attrs = getattr(steps, "band_attrs", lambda i: {})
        for i, dev in enumerate(devices):
            launches.log("bands.band", first[i], t0 + done_s[i], device=dev.index,
                         steps=n_steps[i], **attrs(i))
        launches.current().set(host_step_s=host_s, idle_passes=idle)
    return results, done_s


_STREAMS: dict = {}  # (device, k): the stream of the k-th band on a device


def band_streams(devices) -> list:
    """A CUDA stream for each band (None on the CPU), the same one on every
    call: the k-th band on a device always gets that device's k-th stream.
    A new stream each call would come from torch's round-robin pool, and
    the caching allocator keeps its blocks per stream, so most calls would
    allocate their band's state and compaction buffers anew."""
    out, seen = [], collections.Counter()
    for dev in devices:
        if dev.type != "cuda":
            out.append(None)
            continue
        key = (dev, seen[dev])
        seen[dev] += 1
        with _LOCK:
            if key not in _STREAMS:
                _STREAMS[key] = torch.cuda.Stream(dev)
            out.append(_STREAMS[key])
    return out


@contextlib.contextmanager
def _on(device: torch.device, stream):
    """The current device and stream of a band's step (nothing on the CPU)."""
    if stream is None:
        yield
    else:
        with torch.cuda.device(device), torch.cuda.stream(stream):
            yield
