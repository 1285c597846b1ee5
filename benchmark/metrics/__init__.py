"""Metric readers, one file per metric of ``BENCHMARK.json``.

``<name>.py`` defines ``read(rec)``: the metric's value from a run's
record (``benchmark/run.py`` ``Record``: the window's answers, the spans,
the program's counters, the device trace and the work count), or None
where the run has nothing to read, in which case the metric is left out of
the result line.  Each file also states its ``LAYER``, ``SOURCE`` and
``MOVES`` as ``BENCHMARK.json`` does (for an end-to-end metric ``LAYER``
and ``MOVES`` are None).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(name: str, base: Path = HERE):
    path = Path(base) / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics._{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def window_samples(rec) -> int:
    return sum(a["samples"] for a in rec.answers)


def window_seconds(rec) -> float:
    return rec.window_end - rec.window_start


def sample_rate(rec):
    """Pixel-samples of the window's whole images over the window."""
    return window_samples(rec) / window_seconds(rec) if rec.answers else None


def kernel_seconds(rec, symbol: str) -> float:
    return sum(s for n, s in rec.trace["kernels"].items() if symbol in n)


def roofline(rec, symbol: str):
    """Percent of the least time the work count needs at the card's float32
    peak, over the kernel's device time in the traced answer."""
    if rec.trace is None or rec.traced_ops is None or rec.peak is None:
        return None
    t = kernel_seconds(rec, symbol)
    if t <= 0:
        return None
    return 100.0 * rec.traced_ops / rec.peak["fp32_flops_per_s"] / t


def mfu(rec):
    """Percent of the cards' float32 peak: the traced answer's work count
    over the traced window's length times the peak."""
    if rec.trace is None or rec.traced_ops is None or rec.peak is None:
        return None
    peak = rec.peak["fp32_flops_per_s"] * rec.n_devices
    return 100.0 * rec.traced_ops / peak / rec.trace["window_s"]


def idle_share(rec):
    if rec.trace is None or not rec.trace["devices"]:
        return None
    return 100.0 * (1.0 - rec.trace["busy_s"] / rec.trace["window_s"])
