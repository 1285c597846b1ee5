"""The animated 100k field's cell (``field100k-4k-anim``): its configuration
and cell through ``spec.py``, its own span readers on hand-made records (and
None without them), and a tiny traced run of the field's frames on the CPU
that reports them and the book's animated cell's span readers."""

import collections
import json
import math

import pytest

from benchmark import metrics, spec
from benchmark.run import Record
from raytrace_tpu_torch.ops import launches

CELL = "field100k-4k-anim"
SPAN_READERS = ("paged_build_ms.field_anim", "paged_build_syncs.field_anim",
                "scene_upload_ms.field_anim")
# the book's animated cell's readers, which read this cell's frames too
SHARED = ("scene_host_ms.anim", "scene_prepare_ms.anim", "band_setup_ms.anim",
          "device_idle_share.anim")


def _rec(t0=0.0, t1=100.0, trace=None):
    return Record(setup_s=1.0, window_start=t0, window_end=t1, answers=[], spans={},
                  counters={}, trace=trace, traced_ops=None, peak=None, n_devices=1)


def _span(name, t0, t1, id_, parent=None, **attrs):
    r = launches.Record(name, attrs)
    r.t0, r.t1, r.id, r.parent = t0, t1, id_, parent
    return r


@pytest.fixture
def log(monkeypatch):
    def put(recs):
        monkeypatch.setattr(launches, "_LOG", collections.deque(recs))
    return put


def test_the_cell_and_its_configuration_parse():
    cell = spec.cell(spec.load_benchmark(), CELL)
    cfg, tr = cell["config_data"], cell["traffic_data"]
    assert cell["config"] == "sphere_field_100k_4k_anim" and cell["chips"] == 1
    assert cfg["scene"] == {"kind": "sphere_field", "count": 100000, "extent": 50.0, "seed": 0}
    assert (cfg["width"], cfg["height"], cfg["max_depth"], cfg["mode"], cfg["backend"]) == \
        (3840, 2160, 50, "fast", "auto")
    assert cfg["reduced"] == ["chips"]
    assert tr["loop"] == "frames" and tr["spp"] == 1
    assert {m["name"] for m in cell["end_to_end"]} == {"frame_ms_p95", "setup_s"}
    assert {m["name"] for m in cell["per_layer"]} == set(SPAN_READERS + SHARED)
    # the field's still cell reads the same deployment
    still = json.loads(open(spec.HERE / "configs" / "sphere_field_100k_4k.json").read())
    for k in ("width", "height", "max_depth", "mode", "rr", "backend"):
        assert cfg[k] == still[k], k
    assert {k: v for k, v in still["scene"].items() if k != "time"} == cfg["scene"]


def test_the_readers_on_hand_made_records(log):
    log([_span("scene.generate", 1.0, 1.020, 1), _span("renderer.set_scene", 1.02, 1.030, 2),
         _span("scene.upload", 1.020, 1.021, 3, 2, bytes=100, devices=1),
         _span("scene.prepare", 1.021, 1.029, 4, 2, route="device", tables="paged"),
         _span("paged.build", 1.022, 1.026, 5, 4, route="device", syncs=5),
         _span("scene.generate", 2.0, 2.030, 6), _span("renderer.set_scene", 2.03, 2.040, 7),
         _span("scene.upload", 2.030, 2.033, 8, 7, bytes=100, devices=1),
         _span("paged.build", 2.034, 2.040, 9, 7, route="device", syncs=5),
         _span("scene.generate", 3.0, 3.010, 10), _span("renderer.set_scene", 3.01, 3.012, 11),
         _span("scene.upload", 3.010, 3.012, 12, 11, bytes=100, devices=1),
         _span("paged.build", 3.010, 3.011, 13, 11, route="device", syncs=7)])
    read = {n: metrics.load(n).read(_rec()) for n in SPAN_READERS}
    assert read["paged_build_ms.field_anim"] == pytest.approx(4.0)
    assert read["paged_build_syncs.field_anim"] == 5
    assert read["scene_upload_ms.field_anim"] == pytest.approx(2.0)


@pytest.mark.parametrize("name", SPAN_READERS)
def test_no_records_or_no_spans_read_none(log, monkeypatch, name):
    mod = metrics.load(name)
    log([_span("renderer.call", 1.0, 2.0, 1)])
    assert mod.read(_rec()) is None
    log([_span("scene.generate", 1.0, 1.02, 1), _span("renderer.set_scene", 1.02, 1.03, 2),
         _span("paged.build", 1.02, 1.03, 3, 2, syncs=1),
         _span("scene.upload", 1.02, 1.03, 4, 2)])
    assert mod.read(_rec(50.0, 60.0)) is None  # outside the window
    monkeypatch.delattr(launches, "records")  # a program without spans
    assert mod.read(_rec()) is None


@pytest.fixture
def field_frames(tiny):
    """A tiny cell of the field's frames, dense enough for the paged tables,
    listed as the animated field's cell is."""
    bench, base = tiny
    cfg = json.loads((base / "configs" / "tiny_field.json").read_text())
    cfg["scene"]["extent"] = 7.0
    cfg["scene"].pop("time")
    (base / "configs" / "tiny_field_anim.json").write_text(json.dumps(cfg))
    bench["workloads"].append(dict(name="t-field-frames", config="tiny_field_anim",
                                   traffic="tiny_frames", chips=1, why="a tiny CPU cell"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("t-field-frames")


def test_the_traced_tiny_run_reports_the_span_metrics(run_tiny, field_frames):
    res = run_tiny("t-field-frames", trace=True)
    assert res["correct"]
    for name in SPAN_READERS + SHARED[:3]:
        v = res["metrics"][name]["value"]
        assert math.isfinite(v) and v >= 0, name
    # the tables' build reads five scalars from its device (here the CPU)
    assert res["metrics"]["paged_build_syncs.field_anim"]["value"] == 5
