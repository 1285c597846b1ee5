"""Port: the JAX system's card sweeps and hardware validation
(``raytrace_tpu_torch/scripts``: ``hw_validate``, ``stretch_reps``,
``lane_balance``, ``balance_ab``, ``balance_policy_ab``,
``grid_pitchsweep``, ``paged_ksweep``, ``paged_cellsweep``) and the paged
kernel's ``K_AUTO`` switch, on the CPU at tiny sizes.

Each script runs on the kernels' plain versions (``--device cpu``) and
holds what it holds on the card: every pitch and every K renders the same
image bit for bit, balanced == strided and serpentine == LPT images,
``hw_validate``'s one-sample grid == mega and paged == mega on each layout.
``lane_balance``'s policies give ``runtime/balance``'s statistics for the
tables ``build_passign`` deals, and the JAX script's.  ``scaled_k`` follows the JAX package's
rule (``raytrace_tpu/ops/pagedkernel.py``) with ``K_AUTO`` on and off.
Without a card and without ``--device cpu`` every script raises; importing
them leaves JAX out.
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

import numpy as np
import pytest
import torch

import raytrace_tpu.ops.pagedkernel as jpk
from raytrace_tpu_torch.config import RenderConfig
from raytrace_tpu_torch.models.scene import random_sphere_field
from raytrace_tpu_torch.ops import gridkernel, pagedkernel
from raytrace_tpu_torch.ops.trace import LANE_PAD
from raytrace_tpu_torch.runtime.balance import balance_stats, build_passign
from raytrace_tpu_torch.runtime.renderer import Renderer
from raytrace_tpu_torch.scripts import (balance_ab, balance_policy_ab, grid_pitchsweep,
                                        hw_validate, lane_balance, paged_cellsweep,
                                        paged_ksweep, stretch_reps)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu: the plain torch versions, host clock"
NUM = r"-?[0-9.]+(e[-+][0-9]+)?"
SCRIPTS = ("hw_validate", "stretch_reps", "lane_balance", "balance_ab", "balance_policy_ab",
           "grid_pitchsweep", "paged_ksweep", "paged_cellsweep", "straggler_stats",
           "path_stats", "rr_study", "rr_efficiency")
BOOK_SWEEP = dict(SWEEP_W=32, SWEEP_H=18, SWEEP_SPP=2, SWEEP_ROUNDS=1, PROBE_SPP=2)


def _run(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, [ln for ln in buf.getvalue().splitlines() if ln.strip()]


def _env(monkeypatch, **kw):
    for k, v in kw.items():
        monkeypatch.setenv(k, str(v))


# ---- K_AUTO -----------------------------------------------------------------

@pytest.mark.parametrize("auto", [True, False])
def test_scaled_k_follows_the_jax_rule(monkeypatch, auto):
    assert pagedkernel.K_AUTO is True  # the default scales, as before
    monkeypatch.setattr(pagedkernel, "K_AUTO", auto)
    monkeypatch.setattr(jpk, "K_AUTO", auto)
    for k in (5, pagedkernel.K_STEPS, 7):
        monkeypatch.setattr(pagedkernel, "K_STEPS", k)
        monkeypatch.setattr(jpk, "K_STEPS", k)
        for n in (1, 128, 16383, 16384, 49151, 49152, 259_200, 267_840, 1 << 21):
            assert pagedkernel.scaled_k(n) == jpk.scaled_k(n)
            assert pagedkernel.scaled_k(n) == (k if not auto else k * max(1, round(n / 32768)))


def test_k_auto_off_launches_exactly_k_steps(monkeypatch):
    """With K_AUTO off every paged launch runs K_STEPS iterations (the
    render's iteration count is a multiple of it) and the image is the one
    K_AUTO renders."""
    r = Renderer(RenderConfig(samples=2, width=16, height=8, backend="auto", mode="fast"),
                 scene=random_sphere_field(100_000), device="cpu")
    assert r.backend == "paged"
    base, ti0, _ = r.render_call(2, return_iters=True)
    k_auto = pagedkernel.scaled_k(128)
    monkeypatch.setattr(pagedkernel, "K_AUTO", False)
    monkeypatch.setattr(pagedkernel, "K_STEPS", 7)
    img, tile_iters, lane_slots = r.render_call(2, return_iters=True)
    # one block of 128 lanes: each launch adds its K to the tile iterations
    assert r.pixels_per_lane == 1 and ti0 % k_auto == 0
    assert tile_iters % 7 == 0
    assert lane_slots == tile_iters * LANE_PAD
    assert torch.equal(img, base)


# ---- the scripts on the plain versions ---------------------------------------

def test_grid_pitchsweep(monkeypatch):
    _env(monkeypatch, **BOOK_SWEEP, SWEEP_M=2, PITCHES="1.0,2.0,8.0", SWEEP_K=8)
    j0, k0 = gridkernel.J_STEPS, gridkernel.K_STEPS
    med, lines = _run(grid_pitchsweep.main, ["--device", "cpu"])
    assert (gridkernel.J_STEPS, gridkernel.K_STEPS) == (j0, k0)  # restored
    assert sorted(med) == [(1.0, 2), (2.0, 2)]
    assert "pitch 8.0: does not build (skipped)" in lines
    assert "pitch (2.0, 2) vs (1.0, 2): bit-identical=True" in lines
    for p, ln in zip(("1.0", "2.0"), lines[-2:]):
        assert re.fullmatch(rf"pitch \({p}, 2\):\s+{NUM}s\s+{NUM} ns/sample\s+{NUM} "
                            rf"us/tile-iter\s+issued/sample\s+{NUM} \({CPU}\)", ln)


def test_grid_pitchsweep_variants_raise_on_another_image(monkeypatch):
    """A pitch whose image differs makes the sweep raise (here the second
    variant's render is swapped for an image one value off)."""
    from raytrace_tpu_torch.ops import trace

    _env(monkeypatch, **BOOK_SWEEP, SWEEP_M=2, VARIANTS="1.0:2,1.0:1")
    real = trace.render_band
    calls = []

    def render_band(*a, **kw):
        acc, it = real(*a, **kw)
        calls.append(1)
        if len(calls) == 2:
            acc = acc.clone()
            acc[0, 0, 0] += 1.0
        return acc, it

    monkeypatch.setattr(trace, "render_band", render_band)
    with pytest.raises(RuntimeError, match="another image"):
        _run(grid_pitchsweep.main, ["--device", "cpu"])


def test_paged_ksweep(monkeypatch):
    _env(monkeypatch, AB_W=16, AB_H=8, SWEEP_SPP=2, SWEEP_ROUNDS=1, KS="3,10")
    k0, auto0 = pagedkernel.K_STEPS, pagedkernel.K_AUTO
    med, lines = _run(paged_ksweep.main, ["--device", "cpu"])
    assert (pagedkernel.K_STEPS, pagedkernel.K_AUTO) == (k0, auto0)  # restored
    assert sorted(med) == [3, 10]
    assert re.fullmatch(rf"K=3: warm {NUM}s, launches at K=\[3\] over \[128\] lanes "
                        rf"\({CPU}\)", lines[0])
    assert "K=10 image bit-identical to K=3: True" in lines
    assert re.fullmatch(rf"K=10\s+median {NUM}s \({NUM} ns/sample\) \({CPU}\)", lines[-1])


def test_paged_cellsweep(monkeypatch):
    from raytrace_tpu_torch.models import paged_grid

    _env(monkeypatch, AB_W=16, AB_H=8, SWEEP_SPP=1, SWEEP_ROUNDS=1, SCALES="0.85,1.0")
    med, lines = _run(paged_cellsweep.main, ["--device", "cpu"])
    assert paged_grid.CELL_SIZE_SCALE == 1.0  # restored
    assert sorted(med) == [0.85, 1.0] and med[0.85][1] == 1.0
    assert re.fullmatch(rf"scale=0.85: cell={NUM} n_slots=\d+ geom pages=\d+ \(\d+ MB\)",
                        lines[0])
    assert re.fullmatch(rf"scale 1.0 vs 0.85: {NUM}% pixels identical", lines[4])
    assert 0.0 <= med[1.0][1] <= 1.0


@pytest.mark.parametrize("m", [2, 3])
def test_balance_ab_images_equal(monkeypatch, m):
    _env(monkeypatch, **BOOK_SWEEP, SWEEP_M=m)
    med, lines = _run(balance_ab.main, ["--device", "cpu"])
    assert list(med) == ["strided", "balanced"]
    assert "bit check: 0/576 px differ, max 0.0" in lines
    assert re.fullmatch(rf"balanced vs strided: [-+]{NUM}% \({CPU}\)", lines[-1])


def test_balance_policy_ab_images_equal(monkeypatch):
    _env(monkeypatch, **BOOK_SWEEP, SWEEP_M=3)
    med, lines = _run(balance_policy_ab.main, ["--device", "cpu"])
    assert list(med) == ["serpentine", "lpt"]
    assert re.fullmatch(rf"serpentine: in-sample max/mean {NUM}", lines[1])
    assert "bit check: 0/576 px differ, max 0.0" in lines
    assert re.fullmatch(rf"lpt: median {NUM}s  {NUM} ns/sample \({CPU}\)", lines[-2])


def test_balance_interleave_raises_on_another_image(monkeypatch):
    from raytrace_tpu_torch.ops import trace

    real = trace.render_band

    def render_band(*a, passign=None, **kw):
        acc = real(*a, passign=passign, **kw)
        return acc + 1.0 if passign is not None else acc

    _env(monkeypatch, **BOOK_SWEEP, SWEEP_M=2)
    monkeypatch.setattr(trace, "render_band", render_band)
    with pytest.raises(RuntimeError, match="images differ in 576 px"):
        _run(balance_ab.main, ["--device", "cpu"])


@pytest.mark.parametrize("m", [2, 3, 5])
def test_lane_balance_matches_balance_stats(monkeypatch, m):
    _env(monkeypatch, SWEEP_W=32, SWEEP_H=18, SWEEP_SPP=2, SWEEP_M=m)
    res, lines = _run(lane_balance.main, ["--device", "cpu"])
    cost = res["cost"]
    want = {"strided": balance_stats(cost, None, m)["max_over_mean"]}
    for method in ("serpentine", "lpt"):
        want[method] = balance_stats(cost, build_passign(cost, m, LANE_PAD, method=method),
                                     m)["max_over_mean"]
    for name, v in want.items():
        assert res[name]["max/mean"] == pytest.approx(v, rel=1e-12, abs=0)
    assert re.fullmatch(rf"probe 32x18x2spp mode=fast number=1: {NUM}s \({CPU}\)", lines[1])
    assert lines[-1].startswith("predicted issued-iteration saving vs strided (held-out): ")


@pytest.mark.parametrize("m", [1, 4, 7])
def test_lane_balance_stats_match_the_jax_script(m):
    """lane_balance's stats of a build_passign table are the JAX script's
    lane_stats of the same deal made by the JAX package's build_passign
    (and of the strided map)."""
    import importlib.util

    from raytrace_tpu.runtime.balance import build_passign as jax_build_passign

    spec = importlib.util.spec_from_file_location(
        "jax_lane_balance", os.path.join(ROOT, "scripts", "lane_balance.py"))
    jlb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jlb)
    rng = np.random.default_rng(m)
    cost = rng.lognormal(1.0, 0.9, 401)
    n = -(-cost.size // m)
    for method in (None, "serpentine", "lpt"):
        if method is None:
            tab, lane_of = None, np.arange(cost.size) % n
        else:
            tab = build_passign(cost, m, LANE_PAD, method=method)
            jtab = jax_build_passign(cost, m, LANE_PAD, method=method)
            assert np.array_equal(tab, jtab)
            lane_of = np.empty(cost.size, np.int64)
            for row in jtab:
                ok = row < cost.size
                lane_of[row[ok]] = np.nonzero(ok)[0]
        got, want = lane_balance.lane_stats(cost, tab, m), jlb.lane_stats(cost, lane_of, n)
        assert got["p99/mean"] == want["p99/mean"] and got["mean"] == want["mean"]
        assert got["max/mean"] == pytest.approx(want["max/mean"], rel=1e-12, abs=0)


def _jax_json_keys(script):
    tree = ast.parse(open(os.path.join(ROOT, "scripts", f"{script}.py")).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dumps"
                and node.args and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    raise AssertionError(f"no json.dumps dict in scripts/{script}.py")


def test_stretch_reps_json(monkeypatch):
    monkeypatch.delenv("STRETCH_MODE", raising=False)
    rec, lines = _run(stretch_reps.main, ["--device", "cpu", "3", "8x4x1"])
    assert json.loads(lines[-1]) == rec
    assert set(rec) == _jax_json_keys("stretch_reps") | {"device"}
    assert rec["mode"] == "fast" and rec["backend"] == "paged" and rec["device"] == CPU
    assert len(rec["reps"]) == 3 and rec["median"] == sorted(rec["reps"])[1]


def test_hw_validate_small(monkeypatch):
    """Every block at a tiny size, the dense fields cut to 4,200 spheres
    over a smaller square (the grid refuses them, the paged grid holds
    them): the one-sample equalities, pitch 2 == 1 and balanced ==
    strided hold, and on the plain versions the grid's two-sample
    comparisons are exact too."""
    monkeypatch.setattr(hw_validate, "BOOK_W", 16)
    monkeypatch.setattr(hw_validate, "BOOK_H", 8)
    monkeypatch.setattr(hw_validate, "W", 8)
    monkeypatch.setattr(hw_validate, "H", 4)
    for name in ("BOOK_SPP", "VARIED_SPP", "TTAB_SPP", "PITCH_SPP", "BALANCE_SPP"):
        monkeypatch.setattr(hw_validate, name, 2)
    monkeypatch.setattr(hw_validate, "PAGED_SPP", 1)
    monkeypatch.setattr(hw_validate, "PAGED_TEX_SPP", 1)
    monkeypatch.setattr(hw_validate, "PAGED", dict(hw_validate.PAGED, count=4200, extent=8.0))
    out, lines = _run(hw_validate.main, ["--device", "cpu"])
    assert out["one_sample"] == dict.fromkeys(
        ("book grid", "varied grid", "paged-varied paged", "ttab grid", "paged-tex paged"), 0)
    assert out["pitch2_px"] == 0 and out["balanced_px"] == 0
    assert all(st["px"] == 0 for st in out["spp"].values())
    for done in ("HW VALIDATION DONE", "HW VALIDATION (EXTENDED) DONE",
                 "HW VALIDATION (PITCH) DONE", "HW VALIDATION (BALANCE) DONE"):
        assert done in lines
    assert re.fullmatch(rf"book grid 2spp: {NUM}s  {NUM} ns/sample \({CPU}\)", lines[0])


def test_diff_stats():
    a = np.ones((2, 3, 3), np.float32)
    b = a.copy()
    b[1, 2, 0] = 1.5
    st = hw_validate.diff_stats(a, b)
    assert st["px"] == 1 and st["frac"] == 1 / 6 and st["max_rel"] == pytest.approx(1 / 3)


# ---- harness -------------------------------------------------------------------

@pytest.mark.parametrize("script", SCRIPTS)
def test_without_a_card_it_raises(monkeypatch, script):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"raytrace_tpu_torch.scripts.{script}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


def test_import_leaves_jax_out():
    mods = ", ".join(f"raytrace_tpu_torch.scripts.{s}" for s in SCRIPTS)
    code = (f"import sys, {mods}; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'raytrace_tpu' or m.startswith('raytrace_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
