"""Port: the JAX system's measurement scripts (``raytrace_tpu_torch/scripts``)
on the CPU at tiny sizes.

Each runs on the kernels' plain versions (``--device cpu``) and prints what
its JAX counterpart under ``scripts/`` prints: the JSON scripts the same
keys, read from the JAX script's source with ``ast`` (the JAX scripts are
not run), plus ``device``, the hardware the numbers were taken on; the
sweeps the same lines, each timing line ending in the device.  Without a
card and without ``--device cpu`` each raises.  Importing them leaves JAX
out.
"""

import ast
import contextlib
import importlib
import io
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from raytrace_tpu_torch.scripts import (balance_msweep, baseline_configs, fast_ab,
                                        measure_f64, spp1_bench, spp1_loop_sweep,
                                        stretch_bench)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu: the plain torch versions, host clock"
NUM = r"-?[0-9.]+(e[-+][0-9]+)?"
SCRIPTS = ("baseline_configs", "stretch_bench", "spp1_loop_sweep", "spp1_bench",
           "balance_msweep", "fast_ab", "measure_f64")


def _jax_json_keys(script):
    """The keys of the dict literal the JAX script passes to json.dumps."""
    tree = ast.parse(open(os.path.join(ROOT, "scripts", f"{script}.py")).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dumps"
                and node.args and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    raise AssertionError(f"no json.dumps dict in scripts/{script}.py")


def _run(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, [ln for ln in buf.getvalue().splitlines() if ln.strip()]


def _env(monkeypatch, **kw):
    for k, v in kw.items():
        monkeypatch.setenv(k, str(v))


def test_baseline_configs_keys(monkeypatch):
    monkeypatch.setattr(baseline_configs, "CONFIGS", {
        1: (dict(samples=1, width=24, height=14, max_depth=8, backend="matmul"), "three"),
        2: (dict(samples=2, width=16, height=8, max_depth=50, backend="mega"), "book"),
        3: (dict(samples=2, width=16, height=8, max_depth=50, backend="grid"), "book"),
    })
    recs, lines = _run(baseline_configs.main, ["--device", "cpu"])
    keys = _jax_json_keys("baseline_configs") | {"device"}
    assert [json.loads(ln) for ln in lines] == recs
    assert [r["config"] for r in recs] == [1, 2, 3]
    assert [r["backend"] for r in recs] == ["matmul", "mega", "grid"]
    for r in recs:
        assert set(r) == keys and r["device"] == CPU and r["nonfinite"] == 0
    # grid == mega bit for bit, so their means agree
    assert recs[1]["mean"] == recs[2]["mean"]


def test_baseline_config_1_renders_on_the_cpu(monkeypatch):
    """Config 1 is the CPU reference math whatever the device asked for."""
    monkeypatch.setattr(baseline_configs, "CONFIGS", {
        1: (dict(samples=1, width=8, height=4, max_depth=8, backend="matmul"), "three")})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rec, _ = _run(baseline_configs.run, 1, "cuda")
    assert rec["device"] == CPU
    with pytest.raises(SystemExit):
        baseline_configs.run(4, "cpu")


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_stretch_bench_keys(monkeypatch, mode):
    _env(monkeypatch, STRETCH_MODE=mode)
    recs, lines = _run(stretch_bench.main, ["--device", "cpu", "100000", "8x4x1"])
    assert [json.loads(ln) for ln in lines] == recs and len(recs) == 1
    rec = recs[0]
    assert set(rec) == _jax_json_keys("stretch_bench") | {"device"}
    assert rec["backend"] == "paged" and rec["mode"] == mode and rec["nonfinite"] == 0
    assert rec["config"] == "8x4x1" and rec["n_spheres"] == 100_000


def test_spp1_loop_sweep_lines(monkeypatch):
    _env(monkeypatch, MS="2,4", REPS=3, SWEEP_ROUNDS=2)
    monkeypatch.setattr(spp1_loop_sweep, "W", 16)
    monkeypatch.setattr(spp1_loop_sweep, "H", 8)
    med, lines = _run(spp1_loop_sweep.main, ["--device", "cpu"])
    assert sorted(med) == [2, 4]
    assert [ln.split(":")[0] for ln in lines[:2]] == ["M=2", "M=4"]
    assert all("warm" in ln for ln in lines[:2])
    assert all(re.fullmatch(rf"round \d: M=2:{NUM}ms M=4:{NUM}ms", ln) for ln in lines[2:4])
    for m, ln in zip((2, 4), lines[4:]):
        assert re.fullmatch(rf"M={m}\s+median {NUM} ms/frame \({NUM} ns/sample\) \({CPU}\)", ln)


def test_spp1_bench_lines(monkeypatch):
    from raytrace_tpu_torch.ops import gridkernel as gk

    _env(monkeypatch, CONFIGS="4x40,4x8", SWEEP_ROUNDS=1)
    monkeypatch.setattr(spp1_bench, "W", 16)
    monkeypatch.setattr(spp1_bench, "H", 8)
    j0, k0 = gk.J_STEPS, gk.K_STEPS
    res, lines = _run(spp1_bench.main, ["--device", "cpu"])
    assert (gk.J_STEPS, gk.K_STEPS) == (j0, k0)  # restored
    # one launch of 40 iterations against several of 8 on the same image
    assert res[(4, 40)][1] == 1 and res[(4, 8)][1] > 1
    assert re.fullmatch(rf"round 0: 4x40={NUM}ms 4x8={NUM}ms", lines[2])
    for (m, k), ln in zip(((4, 40), (4, 8)), lines[3:]):
        assert re.fullmatch(rf"M={m}\s+K={k}\s+{NUM} ms  launches \d+\s+issued its/sample "
                            rf"\s*{NUM} \({CPU}\)", ln)


def test_balance_msweep_lines(monkeypatch):
    _env(monkeypatch, SWEEP_W=16, SWEEP_H=8, SWEEP_SPP=2, SWEEP_ROUNDS=1, PROBE_SPP=2,
         MS="1,2")
    med, lines = _run(balance_msweep.main, ["--device", "cpu"])
    assert sorted(med) == [1, 2]
    assert re.fullmatch(r"probe 2spp @M=1: \d+s", lines[0])
    assert re.fullmatch(rf"M=2: balanced max/mean {NUM} \(strided {NUM}\)", lines[2])
    # every M renders the same image
    assert "bit check M=1 vs M=2: 0/128 px differ, max 0.0" in lines
    assert re.fullmatch(rf"M=2: median {NUM}s  {NUM} ns/sample \({CPU}\)", lines[-1])


def test_fast_ab_lines(monkeypatch):
    _env(monkeypatch, SWEEP_W=16, SWEEP_H=8, SWEEP_SPP=2, SWEEP_ROUNDS=1,
         FAST_RR="1,16,0.05;2,0,0.1")
    med, lines = _run(fast_ab.main, ["--device", "cpu"])
    assert list(med) == ["exact", "fast(1,16,0.05)", "fast(2,0,0.1)"]
    assert re.fullmatch(rf"exact median: {NUM}s \({NUM} ns/sample\) \({CPU}\)", lines[4])
    assert re.fullmatch(rf"fast\(2,0,0.1\)\s+median {NUM}s \({NUM} ns/sample\)  "
                        rf"[-+]{NUM}% \({CPU}\)", lines[7])
    assert re.fullmatch(rf"  gate vs exact: p95_z {NUM}  mean_rel {NUM}  psnr {NUM} dB  "
                        r"matches=(True|False)", lines[8])


def test_measure_f64_lines(monkeypatch):
    _env(monkeypatch, F64_W=16, F64_H=8, F64_SPP=2)
    res, lines = _run(measure_f64.main, ["--device", "cpu"])
    assert re.fullmatch(rf"float32: {NUM}s \({CPU}\)", lines[0])
    assert re.fullmatch(rf"float64: {NUM}s \({CPU}\)", lines[1])
    # one call of 2 spp: the f64 sum is the f32 call's sum, bit for bit
    assert res == dict(max_rel=0.0, mean_rel=0.0, differing_px=0, max_du8=0)
    assert lines[3] == "display u8: differing px=0/128 max|d|=0"


@pytest.mark.parametrize("script", SCRIPTS)
def test_without_a_card_it_raises(monkeypatch, script):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"raytrace_tpu_torch.scripts.{script}")
    argv = ["2"] if script == "baseline_configs" else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)


def test_import_leaves_jax_out():
    mods = ", ".join(["raytrace_tpu_torch.bench", "raytrace_tpu_torch.oracle.cpu_reference"]
                     + [f"raytrace_tpu_torch.scripts.{s}" for s in SCRIPTS])
    code = (f"import sys, {mods}; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'raytrace_tpu' or m.startswith('raytrace_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
