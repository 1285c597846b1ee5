"""The harness on the CPU at a tiny size, with the kernels' plain versions."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import run

REPO = Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", ["t-off", "t-frames", "t-bands"])
@pytest.mark.parametrize("trace", [False, True], ids=["timed", "traced"])
def test_a_run_prints_the_contracts_keys(run_tiny, tiny, name, trace):
    bench, _ = tiny
    res = run_tiny(name, trace=trace)
    keys = list(res)
    assert keys[:5] == KEYS and keys[-1] == "check"
    assert set(keys) == set(KEYS) | {"check"} | ({"breakdown"} if trace else set())
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    wanted = [m for m in bench["per_layer" if trace else "end_to_end"]
              if name in m.get("workloads", [name])]
    assert set(res["metrics"]) <= {m["name"] for m in wanted}
    if not trace:
        assert {m["name"] for m in wanted} == set(res["metrics"])
        assert all(v["value"] > 0 for v in res["metrics"].values())
    else:
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(res["device"])
    assert res["device"]["count"] == cell["chips"]
    for v in res["check"].values():
        assert set(v) == {"value", "limit"}
    json.dumps(res)


def test_a_cell_metric_and_traffic_are_added_as_files_only(run_tiny, tiny):
    """A later change adds a cell with its own traffic file and a per-layer
    metric with its own reader, editing no file that is there."""
    bench, base = tiny
    (base / "traffic" / "tiny_off_5.json").write_text(json.dumps(
        {"loop": "offline", "entry": "renderer", "spp": 5, "trace_image": 1,
         "check": {"answers": 1, "pixels": 16, "tolerance": 1e-5, "floor": 1.0, "limit": 0.05}}))
    (base / "metrics" / "images_seen.dummy.py").write_text(
        'LAYER, SOURCE, MOVES = "Renderer", "program_counter", "samples_per_s"\n\n\n'
        'def read(rec):\n    return float(len(rec.answers))\n')
    bench["workloads"].append(dict(name="t-dummy", config="tiny_book", traffic="tiny_off_5",
                                   chips=1, why="added by files alone"))
    bench["per_layer"].append(dict(name="images_seen.dummy", unit="images", better="higher",
                                   source="program_counter", layer="Renderer",
                                   moves="samples_per_s", workloads=["t-dummy"]))
    next(m for m in bench["end_to_end"] if m["name"] == "samples_per_s")["workloads"].append(
        "t-dummy")
    res = run_tiny("t-dummy", trace=True)
    assert res["correct"] and res["metrics"]["images_seen.dummy"]["value"] >= 2
    res = run_tiny("t-dummy")
    assert set(res["metrics"]) == {"samples_per_s", "setup_s"}


def test_seed_gives_the_same_inputs(tiny):
    from benchmark import loops, spec

    bench, base = tiny
    cell = spec.cell(bench, "t-field", base=base)
    a, b = (loops.Session(cell, 2**31 + 5, ["cpu"]) for _ in range(2))
    c = loops.Session(cell, 2**31 + 6, ["cpu"])
    assert (a.pixels == b.pixels).all() and a.number0 == b.number0
    assert a.number0 != c.number0 and not (a.pixels == c.pixels).all()
    # the configuration fixes the scene: another seed, the same work
    assert (a.program_scene(0.0).centers == c.program_scene(0.0).centers).all()


def test_no_card_means_no_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "book-offline-10k", "--seed", "1", "--seconds", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_too_few_cards_means_no_devices(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert run.cuda_devices(4) is None
    assert "needs 4 CUDA devices" in capsys.readouterr().err


def test_the_jax_check_compares_whole_top_level_names():
    assert run.forbidden_modules(["raytrace_tpu_torch", "raytrace_tpu_torch.ops",
                                  "jaxtyping", "flaxen.x", "numpy"]) == []
    assert run.forbidden_modules(["jax.numpy", "raytrace_tpu.ops", "jaxlib", "flax.linen"]) == \
        ["flax", "jax", "jaxlib", "raytrace_tpu"]


def test_a_benchmark_run_imports_no_jax(tmp_path):
    """In a fresh process: the harness, the reference and the program's
    modules that a run imports leave no JAX module behind."""
    code = ("import sys; import benchmark.run, benchmark.loops, benchmark.check, "
            "benchmark.control, benchmark.workcount, benchmark.reference.tracer; "
            "import raytrace_tpu_torch.runtime.renderer, raytrace_tpu_torch.parallel.sharding, "
            "raytrace_tpu_torch.ops.image; "
            "from benchmark.run import forbidden_modules; print(forbidden_modules())")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_a_checkout_of_the_benchmark_alone_prints_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run exits with another code than 0 and prints nothing."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "book-offline-10k",
                          "--seed", "3", "--seconds", "1"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.card
def test_a_short_run_on_the_card(card):
    res = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "book-anim-1spp",
                          "--seed", "5", "--seconds", "2"], cwd=REPO, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
