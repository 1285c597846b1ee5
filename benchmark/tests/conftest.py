"""Fixtures of the benchmark's CPU tests: tiny cells built the way a later
change adds one (files beside copies of the benchmark's, and entries in a
copy of ``BENCHMARK.json``), run on the CPU with the kernels' plain
versions.  Tests marked ``card`` need a CUDA device and skip without one
(decided in the ``card`` fixture, never at import)."""

import dataclasses
import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"

def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def small_profile(monkeypatch):
    """The card profile at a tiny size: 3 samples per call, 2 calls merged."""
    from raytrace_tpu_torch.runtime import chips

    prof = dataclasses.replace(chips.DEFAULT, samples_per_call=3, calls_per_exec=2)
    monkeypatch.setattr(chips, "profile_for", lambda kind=None: prof)
    return prof


@pytest.fixture
def tiny(tmp_path, small_profile):
    """(bench, base): a copy of BENCHMARK.json and of the benchmark's data
    and readers under ``base``, plus tiny cells ``t-off``, ``t-frames``,
    ``t-field`` and ``t-bands`` (two CPU bands) added as files and
    entries, each listed by the metrics of the cell it shrinks."""
    base = tmp_path / "bench"
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(BENCH / d, base / d)
    cfg = json.loads((BENCH / "configs" / "book_final_1080p.json").read_text())
    cfg.update(width=24, height=14, balance_spp=2)
    (base / "configs" / "tiny_book.json").write_text(json.dumps(cfg))
    field = json.loads((BENCH / "configs" / "sphere_field_100k_4k.json").read_text())
    field.update(width=16, height=8)
    field["scene"]["count"] = 2000
    (base / "configs" / "tiny_field.json").write_text(json.dumps(field))
    def limits(name):  # the comparison's tolerance and limit of the cell it shrinks
        chk = json.loads((BENCH / "traffic" / f"{name}.json").read_text())["check"]
        return {k: v for k, v in chk.items() if k in ("tolerance", "floor", "limit")}

    traffic = {
        "tiny_off": {"loop": "offline", "entry": "renderer", "spp": 7, "trace_image": 1,
                     "check": dict(limits("offline_10k"), answers=2, pixels=40)},
        "tiny_bands": {"loop": "offline", "entry": "bands", "spp": 7, "trace_image": 1,
                       "check": dict(limits("offline_10k_bands"), answers=2, pixels=40)},
        "tiny_frames": {"loop": "frames", "spp": 1, "dt": 1 / 60, "t0_span": 600.0,
                        "warmup_frames": 1, "trace_start_s": 0.1, "trace_seconds": 0.2,
                        "check": dict(limits("frames_1spp"), answers=3, pixels=24 * 14)},
    }
    for name, t in traffic.items():
        (base / "traffic" / f"{name}.json").write_text(json.dumps(t))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cells = {"t-off": ("tiny_book", "tiny_off", 1, "book-offline-10k"),
             "t-frames": ("tiny_book", "tiny_frames", 1, "book-anim-1spp"),
             "t-field": ("tiny_field", "tiny_off", 1, "field100k-4k-offline"),
             "t-bands": ("tiny_book", "tiny_bands", 2, "book-offline-10k")}
    for name, (config, tr, chips, like) in cells.items():
        bench["workloads"].append(dict(name=name, config=config, traffic=tr, chips=chips,
                                       why="a tiny CPU cell"))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(name)
    return bench, base


@pytest.fixture
def run_tiny(tiny):
    """run_tiny(name, seed=..., seconds=..., trace=...): one CPU run of a
    tiny cell through ``benchmark.run.execute``; returns the result dict."""
    import time

    import torch

    from benchmark import run, spec

    bench, base = tiny

    def go(name, seed=2**31 + 77, seconds=0.5, trace=False):
        cell = spec.cell(bench, name, base=base)
        return run.execute(cell, seed, seconds, trace, [torch.device("cpu")] * cell["chips"],
                           t0=time.perf_counter())

    return go
