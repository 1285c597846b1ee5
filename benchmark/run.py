"""Run one cell of ``BENCHMARK.json`` once and print one JSON result line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up (imports, the card, the kernels' build
or load, the scene and its tables, the balance probe, the warm-up) is timed
from this module's first line to the window's start (``setup_s``).  The
window runs the cell's traffic for ``--seconds`` (the answer running at the
end runs to its end); ``--trace 1`` also records a device trace over a
sub-window and reports the per-layer metrics instead of the end-to-end
ones.  After the window the program's state is freed and the plain
reference judges a seeded sample of the answers (``benchmark/check.py``).

Exits 2, printing no result, without enough CUDA devices; exits 3 if JAX
or the JAX package was imported.  Kernel builds stay where the program puts
them, inside the checkout (``build/kernels/<hash>/``).
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "raytrace_tpu")


def forbidden_modules(names=None) -> list:
    """Top-level names of loaded modules that are JAX's or the JAX
    package's, compared whole (``raytrace_tpu_torch`` is not one)."""
    tops = {n.split(".")[0] for n in (list(sys.modules) if names is None else names)}
    return sorted(t for t in tops if t in FORBIDDEN)


@dataclass
class Record:
    """What the metric readers read."""

    setup_s: float
    window_start: float
    window_end: float
    answers: list
    spans: dict
    counters: dict
    trace: Optional[dict]
    traced_ops: Optional[float]
    peak: Optional[dict]
    n_devices: int


def peak_for(kind: str) -> Optional[dict]:
    with open(Path(__file__).resolve().parent / "peaks.json") as f:
        table = json.load(f)
    for row in table.values():
        if row["match"] in kind.lower():
            return row
    return None


def cuda_devices(chips: int):
    """The cell's CUDA devices, or None (with the reason on stderr)."""
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; the benchmark measures the card only", file=sys.stderr)
        return None
    if torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA devices, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return None
    return [torch.device("cuda", i) for i in range(chips)]


def device_info(devices) -> dict:
    import torch

    if devices[0].type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": len(devices), "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(devices[0]),
            "count": len(devices),
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d) for d in devices)}


def traced_work(cell: dict, sess) -> Optional[float]:
    """The work count of the traced answer (one whole image)."""
    from . import workcount
    from .reference import camera, scenes

    cfg, tr = cell["config_data"], cell["traffic_data"]
    if tr["loop"] != "offline":
        return None
    scene = scenes.make_scene(cfg["scene"], sess.scene_time(0))
    rr = tuple(cfg["rr"]) if cfg["mode"] == "fast" else None
    return workcount.image_ops(scene, camera.viewport(cfg["width"], cfg["height"]),
                               cfg["width"], cfg["height"], int(tr["spp"]), cfg["max_depth"],
                               rr, device=sess.devices[0])


def execute(cell: dict, seed: int, seconds: float, trace: bool, devices, t0: float = _T0) -> dict:
    """One run of ``cell`` on ``devices``; returns the result line's dict
    (``check`` last)."""
    from . import check, metrics
    from .loops import Session

    sess = Session(cell, seed, devices, trace=trace)
    sess.setup()
    setup_s = time.perf_counter() - t0
    sess.window(seconds)
    dev = device_info(devices)
    sess.release()
    verdict = check.judge(cell["config_data"], cell["traffic_data"], seed, sess.answers,
                          sess.pixels, devices[0])
    rec = Record(setup_s=setup_s, window_start=sess.window_start, window_end=sess.window_end,
                 answers=sess.answers, spans=dict(sess.spans.durations),
                 counters=sess.counters, trace=sess.trace_summary,
                 traced_ops=traced_work(cell, sess) if sess.trace_summary else None,
                 peak=peak_for(dev["kind"]), n_devices=len(devices))
    out = {}
    for m in cell["per_layer"] if trace else cell["end_to_end"]:
        v = metrics.load(m["name"], Path(cell["base"]) / "metrics").read(rec)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {"correct": bool(verdict["correct"]), "attempted": len(sess.answers),
              "failed": int(verdict["failed"]), "metrics": out, "device": dev}
    if trace and sess.trace_summary is not None:
        dev["busy_s"] = sess.trace_summary["busy_s"]
        dev["window_s"] = sess.trace_summary["window_s"]
        result["breakdown"] = sess.trace_summary["breakdown"]
    result["check"] = verdict["numbers"]
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import spec

    cell = spec.cell(spec.load_benchmark(), args.workload)
    devices = cuda_devices(int(cell["chips"]))
    if devices is None:
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace), devices)
    bad = forbidden_modules()
    if bad:
        print(f"error: modules of JAX or the JAX package were imported: {bad}", file=sys.stderr)
        return 3
    for name, n in result["check"].items():
        print(f"check {name} = {n['value']!r} (limit {n['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
