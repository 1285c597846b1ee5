"""Device selection and per-device dispatch.

Port of ``raytrace_tpu/parallel/devices.py`` (the analogue of the
reference's ``pick_physical_devices``, vulkan.h:68-110, truncated to
``--gpus`` at ray_trace.cpp:954-956), plus the dispatch the JAX package gets
from asynchronous arrays: ``run_in_turns`` steps every device's band from
the calling thread, each one again as soon as its last launch completes.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Generator, List, Optional, Sequence

import torch

from ..runtime.renderer import render_device


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
    band's own stream (which first waits for the calling stream, where the
    scene tables were uploaded); None where the step's work is done when it
    returns (the CPU).  A band is stepped again only once its event has
    completed, so the host never waits on one band's launch while another
    band's launch could be issued: the driver's host sync at the top of its
    next step finds its launch done, a fast device's band runs on while a
    slow device's launch is in flight, and each band's completion time ends
    with its own device's work.  Returns (each generator's return value,
    seconds from the start to each one's completion; on a CUDA device its
    stream synchronised).  An error of any step is raised at once.

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
    t0 = time.perf_counter()
    gens = [steps(i) for i in range(n)]
    streams = [None] * n
    for i, dev in enumerate(devices):
        if dev.type == "cuda":
            streams[i] = torch.cuda.Stream(dev)
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
                try:
                    issued[i] = next(gens[i])
                    continue
                except StopIteration as stop:
                    results[i] = stop.value
                if streams[i] is not None:
                    streams[i].synchronize()
            done_s[i] = time.perf_counter() - t0
            running.remove(i)
        if not stepped:
            time.sleep(0)  # every band's launch is in flight
    return results, done_s


@contextlib.contextmanager
def _on(device: torch.device, stream):
    """The current device and stream of a band's step (nothing on the CPU)."""
    if stream is None:
        yield
    else:
        with torch.cuda.device(device), torch.cuda.stream(stream):
            yield
