"""The readers of the four-card cell's per-layer metrics: the cards' span
ratio, the band dispatcher's spans (``bands.call``, ``bands.band``,
``parallel/devices.py`` ``run_in_turns``) on hand-made records, None where
there are none or the program has no spans, and a tiny cell of four CPU
bands, listed as ``book-offline-10k-gpus4`` is, whose traced run reports
them."""

import collections
import json
import math

import pytest

from benchmark import metrics
from benchmark.run import Record
from raytrace_tpu_torch.ops import launches

SPAN_READERS = ("band_wait_share.gpus4", "turn_host_share.gpus4")


def _rec(t0=0.0, t1=100.0, counters=None):
    return Record(setup_s=1.0, window_start=t0, window_end=t1, answers=[], spans={},
                  counters=counters or {}, trace=None, traced_ops=None, peak=None, n_devices=4)


def _span(name, t0, t1, id_, parent=None, **attrs):
    r = launches.Record(name, attrs)
    r.t0, r.t1, r.id, r.parent = t0, t1, id_, parent
    return r


def _call(id_, t0, t1, band_ends, host_s):
    """A ``bands.call`` from ``t0`` to ``t1`` whose bands end at
    ``band_ends``, and its ``bands.band`` spans."""
    out = [_span("bands.call", t0, t1, id_, None, spp=1, n_calls=1, n_bands=len(band_ends),
                 devices=len(band_ends), host_step_s=host_s, idle_passes=3)]
    for j, end in enumerate(band_ends):
        out.append(_span("bands.band", t0, end, id_ * 10 + j, id_, device=j, y0=270 * j,
                         rows=270, steps=5))
    return out


@pytest.fixture
def log(monkeypatch):
    def put(recs):
        monkeypatch.setattr(launches, "_LOG", collections.deque(recs))
    return put


def test_band_wait_share_is_the_cards_time_after_their_band(log):
    # call 1: 10 s, bands end 1, 2, 0 and 0 s before its end; call 2: 2 s,
    # every band at its end; a band under another span and a call outside
    # the window count for nothing
    log(_call(1, 10.0, 20.0, [19.0, 18.0, 20.0, 20.0], 4.0)
        + _call(2, 30.0, 32.0, [32.0] * 4, 1.0)
        + [_span("bands.band", 40.0, 41.0, 99, 98, device=0, y0=0, rows=270, steps=1),
           _span("bands.balance", 40.0, 42.0, 98)]
        + _call(3, 200.0, 210.0, [201.0] * 4, 9.0))
    got = metrics.load("band_wait_share.gpus4").read(_rec())
    assert got == pytest.approx(100.0 * 3.0 / (4 * 10.0 + 4 * 2.0))


def test_turn_host_share_is_the_step_time_over_the_calls(log):
    log(_call(1, 10.0, 20.0, [20.0] * 4, 4.0) + _call(2, 30.0, 32.0, [32.0] * 4, 1.0)
        + [_span("bands.call", 40.0, 41.0, 7)])  # no host_step_s: not a call of bands
    got = metrics.load("turn_host_share.gpus4").read(_rec())
    assert got == pytest.approx(100.0 * 5.0 / 12.0)


def test_band_imbalance_short_reads_as_band_imbalance_gpus4():
    rec = _rec()
    rec.trace = {"devices": {0: dict(first_us=0.0, last_us=10.0),
                             1: dict(first_us=1.0, last_us=7.0),
                             2: dict(first_us=0.0, last_us=8.0)}}
    got = metrics.load("band_imbalance.short").read(rec)
    assert got == metrics.load("band_imbalance.gpus4").read(rec) == pytest.approx(10.0 / 8.0)
    rec.trace = {"devices": {0: dict(first_us=0.0, last_us=10.0)}}  # one card
    assert metrics.load("band_imbalance.short").read(rec) is None
    assert metrics.load("band_imbalance.short").read(_rec()) is None  # not traced


def test_lane_max_mean_reads_the_bands_counter():
    mod = metrics.load("lane_max_mean.gpus4")
    assert mod.read(_rec(counters={"balance_max_over_mean": 1.25})) == 1.25
    assert mod.read(_rec()) is None  # a program whose bands keep no tables


@pytest.mark.parametrize("name", SPAN_READERS)
def test_no_records_or_no_spans_read_none(log, monkeypatch, name):
    mod = metrics.load(name)
    log([_span("grid.launch", 1.0, 2.0, 1)])
    assert mod.read(_rec()) is None
    log(_call(1, 10.0, 20.0, [20.0] * 4, 4.0))
    assert mod.read(_rec(50.0, 60.0)) is None
    monkeypatch.delattr(launches, "records")  # a program without spans
    assert mod.read(_rec()) is None


@pytest.fixture
def four_bands(tiny):
    """``t-bands4``: the tiny book over four CPU bands, listed wherever the
    four-card cell is."""
    bench, base = tiny
    tr = json.loads((base / "traffic" / "tiny_bands.json").read_text())
    (base / "traffic" / "tiny_bands4.json").write_text(json.dumps(tr))
    bench["workloads"].append(dict(name="t-bands4", config="tiny_book", traffic="tiny_bands4",
                                   chips=4, why="a tiny CPU cell of four bands"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "book-offline-10k-gpus4" in m.get("workloads", []):
            m["workloads"].append("t-bands4")
    return bench


def test_the_traced_four_band_run_reports_the_band_metrics(run_tiny, four_bands):
    res = run_tiny("t-bands4", trace=True)
    assert res["correct"] and res["device"]["count"] == 4
    for name in SPAN_READERS + ("lane_max_mean.gpus4",):
        v = res["metrics"][name]["value"]
        assert math.isfinite(v) and v >= 0, name
    assert 0 <= res["metrics"]["band_wait_share.gpus4"]["value"] <= 100
    assert 0 < res["metrics"]["turn_host_share.gpus4"]["value"] <= 100
    assert res["metrics"]["lane_max_mean.gpus4"]["value"] >= 1.0
    # the CPU's trace has no device events: the cards' imbalance reads nothing
    assert "band_imbalance.short" not in res["metrics"]
    res = run_tiny("t-bands4")
    assert res["correct"] and set(res["metrics"]) == {"samples_per_s.short", "setup_s"}
