"""The readers of the program's spans (``ops/launches.py`` ``records``): a
known value on hand-made records, None where there are none or the program
has no spans, and the metrics in the traced runs of the tiny cells."""

import collections
import json
import math

import pytest

from benchmark import metrics
from benchmark.run import Record
from raytrace_tpu_torch.ops import launches

SPAN_METRICS = {
    "t-off": ("launch_gap_host_us.grid", "tail_time_share.grid"),
    "t-paged": ("launch_gap_host_us.paged", "band_setup_ms.short"),
    "t-frames": ("band_setup_ms.anim", "scene_prepare_ms.anim"),
}


def _rec(t0=0.0, t1=100.0):
    return Record(setup_s=1.0, window_start=t0, window_end=t1, answers=[], spans={},
                  counters={}, trace=None, traced_ops=None, peak=None, n_devices=1)


def _span(name, t0, t1, id_, parent=None, **attrs):
    r = launches.Record(name, attrs)
    r.t0, r.t1, r.id, r.parent = t0, t1, id_, parent
    return r


def _launch(name, t, gap, run, n_live, n_first, id_, parent=1):
    """A launch counted at ``t``, issued ``gap`` later, done ``run`` after."""
    return _span(name, t, t + gap, id_, parent, index=0, n_live=n_live, n_first=n_first, k=8,
                 t_counted=t, t_issued=t + gap, t_done=t + gap + run)


@pytest.fixture
def log(monkeypatch):
    """log(records): the program's span log holds exactly ``records``."""
    def put(recs):
        monkeypatch.setattr(launches, "_LOG", collections.deque(recs))
    return put


@pytest.mark.parametrize("kind", ["grid", "paged"])
def test_launch_gap_is_the_median_host_time_from_count_to_issue(log, kind):
    other = "paged" if kind == "grid" else "grid"
    log([_launch(f"{kind}.launch", 10.0, 10e-6, 1.0, 90, 100, 2),
         _launch(f"{kind}.launch", 12.0, 40e-6, 1.0, 90, 100, 3),
         _launch(f"{kind}.launch", 14.0, 20e-6, 1.0, 90, 100, 4),
         _launch(f"{other}.launch", 16.0, 900e-6, 1.0, 90, 100, 5),
         _launch(f"{kind}.launch", 200.0, 900e-6, 1.0, 90, 100, 6)])  # outside the window
    v = metrics.load(f"launch_gap_host_us.{kind}").read(_rec())
    assert v == pytest.approx(20.0, rel=1e-6)


def test_tail_share_counts_launches_under_97_percent_of_the_first(log):
    log([_launch("grid.launch", 1.0, 1e-4, 3.0, 100, 100, 2),
         _launch("grid.launch", 5.0, 1e-4, 1.0, 97, 100, 3),  # not below 97%
         _launch("grid.launch", 7.0, 1e-4, 4.0, 96, 100, 4),
         _launch("paged.launch", 12.0, 1e-4, 50.0, 1, 100, 5)])
    assert metrics.load("tail_time_share.grid").read(_rec()) == pytest.approx(50.0)


@pytest.mark.parametrize("name", ["band_setup_ms.short", "band_setup_ms.anim"])
def test_band_setup_is_the_median_over_calls_of_their_bands_summed(log, name):
    log([_span("band.setup", 1.000, 1.001, 2, 1), _span("band.setup", 1.002, 1.004, 3, 1),
         _span("renderer.call", 1.0, 1.5, 1),
         _span("band.setup", 2.0, 2.005, 5, 4), _span("renderer.call", 2.0, 2.5, 4),
         _span("band.setup", 3.0, 3.001, 7, 6), _span("renderer.call", 3.0, 3.5, 6),
         _span("band.setup", 4.0, 4.100, 8, None)])  # under no call
    assert metrics.load(name).read(_rec()) == pytest.approx(3.0)


def test_scene_prepare_is_the_median_of_its_spans(log):
    log([_span("scene.prepare", 1.0, 1.002, 2, 1), _span("scene.prepare", 2.0, 2.009, 3, 1),
         _span("scene.prepare", 3.0, 3.004, 4, 1), _span("scene.generate", 4.0, 4.5, 5)])
    assert metrics.load("scene_prepare_ms.anim").read(_rec()) == pytest.approx(4.0)


@pytest.mark.parametrize("name", sorted(n for ns in SPAN_METRICS.values() for n in ns))
def test_no_records_or_no_spans_read_none(log, monkeypatch, name):
    mod = metrics.load(name)
    log([_span("scene.generate", 1.0, 2.0, 1)])
    assert mod.read(_rec()) is None
    log([_launch("grid.launch", 1.0, 1e-4, 3.0, 100, 100, 3, 2),
         _span("renderer.call", 1.0, 5.0, 2), _span("band.setup", 1.0, 1.1, 4, 2),
         _span("scene.prepare", 1.0, 1.1, 5)])
    assert mod.read(_rec(50.0, 60.0)) is None
    monkeypatch.delattr(launches, "records")  # a program without spans
    assert mod.read(_rec()) is None


@pytest.fixture
def paged_cell(tiny):
    """A tiny cell of the field whose spheres lie dense enough for the paged
    tables (the tiny cells' field is sparse enough for the mega kernel),
    listed as the field's cell is."""
    bench, base = tiny
    cfg = json.loads((base / "configs" / "tiny_field.json").read_text())
    cfg["scene"]["extent"] = 7.0
    (base / "configs" / "tiny_paged.json").write_text(json.dumps(cfg))
    bench["workloads"].append(dict(name="t-paged", config="tiny_paged", traffic="tiny_off",
                                   chips=1, why="a tiny CPU cell on the paged tables"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "field100k-4k-offline" in m.get("workloads", []):
            m["workloads"].append("t-paged")


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_the_traced_tiny_runs_report_the_span_metrics(run_tiny, paged_cell, cell):
    res = run_tiny(cell, trace=True)
    assert res["correct"]
    for name in SPAN_METRICS[cell]:
        v = res["metrics"][name]["value"]
        assert math.isfinite(v) and v >= 0, name
        if name.startswith("tail_time_share"):
            assert v <= 100.0
