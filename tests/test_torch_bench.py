"""Port: ``python -m raytrace_tpu_torch.bench`` (the JAX bench's JSON line)
on the CPU.

``main()`` runs once at 24x14 x 8 spp, 4 spp per call, a 2-spp probe and a
2-spp balance probe on the kernels' plain versions (``BENCH_DEVICE=cpu``;
the frame loop merges 3 calls here, 65 on the card).  Its last stdout line
must be one JSON object whose keys are those of ``bench.py``'s dict, read
from ``bench.py``'s source with ``ast`` (the JAX bench is not run), with
the port's documented substitutions; its full run's accumulator equals
``Renderer.render`` of the same config, unmerged and unbalanced.  A gate
patched to fail makes ``main()`` return 1 and print no ``value``; without
a card and without ``BENCH_DEVICE`` it raises.
"""

import ast
import contextlib
import io
import json
import os

import pytest
import torch

from raytrace_tpu_torch import RenderConfig, bench
from raytrace_tpu_torch.runtime import renderer as rmod
from raytrace_tpu_torch.runtime import validation

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {"BENCH_DEVICE": "cpu", "BENCH_WIDTH": "24", "BENCH_HEIGHT": "14", "BENCH_SPP": "8",
       "BENCH_SPP_PER_CALL": "4", "BENCH_PROBE_SPP": "2", "BENCH_BALANCE_SPP": "2"}
# the port's JSON against bench.py's: keys added, and renamed in utilization
ADDED = {"spp1_frame_loop_m"}
RENAMED_UTIL = {"gather_rows_per_chunk": "gather_values_per_launch"}
GATES = ("numeric_check", "numeric_check_multitile", "bitident_check", "fast_check",
         "merge_check", "bandsplit_check")


def _jax_bench_keys():
    """(top-level keys, utilization keys) of the dicts bench.py prints."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    top = util = None
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and node.keys and all(
                isinstance(k, ast.Constant) for k in node.keys):
            keys = {k.value for k in node.keys}
            if {"metric", "measured", "utilization"} <= keys:
                top = keys
            elif "gather_floor_frac" in keys:
                util = keys
    return top, util


def _run_main(monkeypatch, env=ENV):
    for k in [k for k in os.environ if k.startswith("BENCH_")]:
        monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(bench, "FRAME_LOOP_CALLS", 3)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main()
    return rc, buf.getvalue().strip().splitlines()


@pytest.fixture(scope="module")
def run():
    """main() once; (rc, stdout lines, the full run's accumulator)."""
    mp = pytest.MonkeyPatch()
    seen = []
    orig = rmod.Renderer.render

    def spy(self, *a, **kw):
        out = orig(self, *a, **kw)
        seen.append(out[0])
        return out

    mp.setattr(rmod.Renderer, "render", spy)
    try:
        rc, lines = _run_main(mp)
    finally:
        mp.undo()
    return rc, lines, seen


def test_last_line_has_the_jax_bench_keys(run):
    rc, lines, _ = run
    assert rc == 0 and lines
    rec = json.loads(lines[-1])
    top, util = _jax_bench_keys()
    assert top and util
    assert set(rec) == top | ADDED
    assert set(rec["utilization"]) == {RENAMED_UTIL.get(k, k) for k in util}


def test_full_run_and_every_gate(run):
    rec = json.loads(run[1][-1])
    assert rec["measured"] == "full" and rec["backend"] == "grid" and rec["mode"] == "fast"
    assert rec["metric"] == "seconds_24x14_8spp" and rec["value"] > 0
    for k in GATES:
        assert rec[k].get("ok", rec[k].get("bit_identical")) is True, (k, rec[k])
    assert rec["spp1_frame_loop_m"] == bench.FRAME_LOOP_M == 16
    assert rec["device"].startswith("cpu")
    util = rec["utilization"]
    # the probe's first launch loads table values; no card rate on the CPU
    assert util["gather_values_per_launch"] > 0 and util["gather_floor_frac"] is None
    assert util["probe_spp"] == 2 and 0 < util["sched_efficiency"] <= 1


def test_accumulator_equals_renderer_render(run):
    accum = run[2][-1]
    cfg = RenderConfig(samples=8, width=24, height=14, mode="fast", samples_per_call=4)
    want, total = rmod.Renderer(cfg, device="cpu").render()
    assert total == 8 and accum.shape == want.shape
    assert torch.equal(accum, want)


@pytest.mark.parametrize("gate", ["golden_check", "bitident_check", "fast_check",
                                  "merge_check", "bandsplit_check"])
def test_a_failing_gate_exits_without_a_time(monkeypatch, gate):
    def stub(name):
        def fn(*a, **kw):
            key = "bit_identical" if name in ("bitident_check", "merge_check",
                                              "bandsplit_check") else "ok"
            return {"stub": name, key: name != gate}
        return fn

    for name in ("golden_check", "bitident_check", "fast_check", "merge_check",
                 "bandsplit_check"):
        monkeypatch.setattr(validation, name, stub(name))
    rc, lines = _run_main(monkeypatch, dict(ENV, BENCH_BALANCE_SPP="0"))
    assert rc == 1
    rec = json.loads(lines[-1])
    assert "value" not in rec and "gates failed" in rec["error"]
    assert not any("value" in json.loads(ln) for ln in lines if ln.startswith("{"))


def test_without_a_card_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("BENCH_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main()


def test_merged_renderer_takes_the_profile_group():
    from raytrace_tpu_torch.runtime.chips import profile_for

    cfg = RenderConfig(samples=8, width=24, height=14, mode="fast", samples_per_call=4)
    r = rmod.Renderer(cfg, device="cpu")
    r.passign, r.balance_stats = {0: "table"}, {0: {}}
    r2 = bench.merged_renderer(r, cfg)
    assert r2.config.calls_per_exec == profile_for().calls_per_exec == 4
    assert r2.passign is r.passign and r2.balance_stats is r.balance_stats


def test_gather_tally_counts_no_launch():
    """The bench's gather tally runs the plain body through
    ``gridkernel.grid_step_work``: the same work and accumulator as a
    counted plain call on the same state, and neither launch count moves."""
    from raytrace_tpu_torch.ops import gridkernel as gk
    from raytrace_tpu_torch.ops import trace

    cfg = RenderConfig(samples=2, width=24, height=14, mode="fast", balance_spp=2)
    r = rmod.Renderer(cfg, device="cpu")
    r.render_call(1)  # builds the balanced table
    counters = (gk.grid_megakernel_step, gk.grid_megakernel_step_plain)
    before = [c.launches for c in counters]
    values, ms = bench.grid_launch_tally(r, 2)
    assert [c.launches for c in counters] == before
    assert values > 0 and ms is None  # no card rate on the CPU

    (kw,) = r.chunks(r.bands[0])
    f, u, scal, vpr, geom = trace.pack_state(
        r.device_scene, kw["vp"], backend="grid", band_h=cfg.height, width=cfg.width, y0=0,
        seed_y0=0, offset_x=0, spp=2, number=0, pixels_per_lane=r.pixels_per_lane,
        passign=r.passign[0])
    step = dict(geom, max_depth=kw["max_depth"], skip_tmax=kw["skip_tmax"], rr=kw["rr"],
                passign=r.passign[0])
    acc_w, acc_p = (trace.home_accum(None, geom["p_total"], "cpu") for _ in range(2))
    work = gk.grid_step_work(scal, vpr, r.device_scene.grid, f, u, acc_w, **step)
    assert [c.launches for c in counters] == before
    work_p = {}
    gk.grid_megakernel_step_plain(scal, vpr, r.device_scene.grid, f, u, acc_p, work=work_p,
                                  **step)
    assert gk.grid_megakernel_step_plain.launches == before[1] + 1
    assert work == work_p and work["table_values"] > 0
    assert torch.equal(acc_w, acc_p)
