"""Profiling and observability: device traces and per-frame timing.

Port of ``raytrace_tpu/runtime/profiling.py``.  The reference has host
wall-clocks only (std::chrono around the frame loop); ``device_trace``
records a trace of the card through ``torch.profiler`` (CUPTI), where the
JAX package wraps ``jax.profiler``, and ``FrameStats`` is the JAX class as
it is.  While ``device_trace`` runs, the program's spans
(``ops/launches.py``) record too: the trace shows their ``rt.*`` ranges
(the render call, each band's set-up, each grid or paged launch and its
count, compaction and step, the scene's generation and tables) as host
ranges nested with the torch ops, and ``ops.launches.records()`` returns
their log.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from .renderer import render_device


@contextlib.contextmanager
def device_trace(log_dir: str, device="cuda"):
    """Record a trace around a block and write it into ``log_dir`` as a
    ``*.pt.trace.json`` file that TensorBoard's profiler plugin and Chrome's
    trace viewer read: CPU and CUDA activity on a CUDA device, CPU activity
    only with ``device="cpu"``.  Raises without a CUDA device unless asked
    for the CPU, as the renderer does.  Yields the ``torch.profiler.profile``
    object.

    Usage::
        with device_trace("build/trace"):
            renderer.render_call(100)
    """
    dev = render_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


@dataclass
class FrameStats:
    """Rolling duration_per_frame bookkeeping (ray_trace.cpp:741-748)."""

    durations: List[float] = field(default_factory=list)

    @contextlib.contextmanager
    def frame(self):
        t0 = time.perf_counter()
        yield
        self.durations.append(time.perf_counter() - t0)

    @property
    def duration_per_frame(self) -> float:
        return sum(self.durations) / max(len(self.durations), 1)

    def adaptive_frame_count(self, min_seconds: float = 4.0) -> int:
        """benchmark_frame_count = (min_s + 50*dpf)/dpf (ray_trace.cpp:748)."""
        dpf = self.duration_per_frame
        if dpf <= 0:
            return 1
        return max(1, int((min_seconds + 50.0 * dpf) / dpf))

    def report(self) -> Dict:
        d = self.durations
        return {
            "frames": len(d),
            "duration_per_frame": self.duration_per_frame,
            "min": min(d) if d else 0.0,
            "max": max(d) if d else 0.0,
        }

    def dump(self, path: Optional[str] = None) -> str:
        s = json.dumps(self.report())
        if path:
            with open(path, "w") as f:
                f.write(s + "\n")
        return s
