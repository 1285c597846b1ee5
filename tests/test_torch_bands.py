"""Port: ``MultiChipRenderer`` at its configuration's operating point, on
the CPU.

Four bands of one repeated CPU device render the book at 64x48 with
balanced lane tables (``balance_spp``), one table per chunk of every band,
built on the band's device from the bands' probes stepped together: the
image is ``Renderer``'s whole image bit for bit, and the benchmark's plain
reference gives the same sums at seeded pixels.  The tables are
``Renderer``'s for the same rows; without ``balance_spp`` the bands take the
strided map; calls merged into one dispatch equal the calls one at a time.
The band dispatcher's spans (``bands.call``, ``bands.band``,
``bands.gather``, ``bands.balance``) record only under the profiler.
"""

import time

import numpy as np
import pytest
import torch

from raytrace_tpu_torch import RenderConfig
from raytrace_tpu_torch.models.scene import generate_random_scene
from raytrace_tpu_torch.ops import launches
from raytrace_tpu_torch.ops.trace import LANE_PAD
from raytrace_tpu_torch.parallel.sharding import MultiChipRenderer
from raytrace_tpu_torch.runtime.renderer import Renderer

torch.set_num_threads(1)

CPU4 = ["cpu"] * 4
W, H, SPP, DEPTH = 64, 48, 4, 8
RR = (1, 16, 0.05)


def _cfg(**kw):
    base = dict(samples=SPP, width=W, height=H, max_depth=DEPTH, backend="grid", mode="fast",
                rr_params=RR, balance_spp=2, samples_per_call=2, calls_per_exec=1, chips=4)
    base.update(kw)
    return RenderConfig(**base)


@pytest.fixture(scope="module")
def scene():
    return generate_random_scene(0.0)


@pytest.fixture(scope="module")
def balanced(scene):
    """(renderer, image): four balanced bands, two calls of 2 spp."""
    r = MultiChipRenderer(_cfg(), scene=scene, devices=CPU4)
    return r, r.render()[0]


@pytest.fixture(scope="module")
def whole(scene):
    return Renderer(_cfg(), scene=scene, device="cpu").render()[0]


def test_balanced_bands_equal_the_whole_image(balanced, whole):
    r, img = balanced
    assert r._passign is not None and img.shape == (H, W, 3)
    assert torch.equal(img, whole)


def test_balanced_bands_equal_the_plain_reference(balanced):
    """64 seeded pixels against ``benchmark/reference``'s tracer, under the
    book cells' tolerance (1e-5 of the value, floored at 1): none off."""
    from benchmark.check import off_share
    from benchmark.reference import camera, scenes, tracer

    _, img = balanced
    rng = np.random.default_rng(2**31 + 18)
    flat = rng.choice(W * H, size=64, replace=False)
    pix = np.stack([flat % W, flat // W], axis=1)
    numbers = np.tile(np.arange(2, dtype=np.int64), (len(pix), 1))
    ref = tracer.render_pixels(scenes.make_scene({"kind": "book", "time": 0.0}, 0.0),
                               camera.viewport(W, H), pix, numbers, [2, 2], DEPTH, RR)
    got = img[pix[:, 1], pix[:, 0]]
    assert off_share(got.numpy(), ref.numpy(), 1e-5, 1.0) == 0.0


def test_each_table_lives_on_its_band_device_at_its_chunk_shape(balanced):
    r, _ = balanced
    assert len(r._passign) == 4
    for i, tables in enumerate(r._passign):
        (y0,) = tables  # one chunk a band at this size
        assert y0 == i * r.band_h
        tab = tables[y0]
        assert tab.device == r.devices[i] and tab.dtype == torch.int32
        m = 1  # 12 rows x 64 over the CPU's lane target
        assert tuple(tab.shape) == (m, -(-(r.band_h * W) // LANE_PAD) * LANE_PAD)


def test_balance_stats_has_one_entry_per_table(balanced):
    r, _ = balanced
    assert set(r.balance_stats) == {(i, y0) for i, t in enumerate(r._passign) for y0 in t}
    for s in r.balance_stats.values():
        assert set(s) == {"max_over_mean", "lanes", "issued_per_sample"}
        assert s["max_over_mean"] >= 1.0 and s["lanes"] == r.band_h * W


def test_tables_are_the_renderers_for_the_same_rows(balanced, scene):
    """The bands' probes, stepped together, measure the costs
    ``Renderer.enable_balance`` measures band by band: equal tables."""
    r, _ = balanced
    one = Renderer(_cfg(), scene=scene, device="cpu")
    one.chunk_rows = r.band_h
    one.enable_balance()
    for i, tables in enumerate(r._passign):
        for y0, tab in tables.items():
            assert torch.equal(tab, one._passign[y0])
            assert one.balance_stats[y0] == r.balance_stats[(i, y0)]


def test_no_balance_spp_takes_the_strided_map(scene, whole, monkeypatch):
    from raytrace_tpu_torch.parallel import sharding

    seen = []
    orig = sharding.render_band_steps

    def steps(*a, **k):
        seen.append(k["passign"])
        return (yield from orig(*a, **k))

    monkeypatch.setattr(sharding, "render_band_steps", steps)
    r = MultiChipRenderer(_cfg(balance_spp=0), scene=scene, devices=CPU4)
    img, _ = r.render()
    assert r._passign is None and r.balance_stats is None
    assert len(seen) == 8 and all(p is None for p in seen)
    assert torch.equal(img, whole)


def test_merged_calls_equal_calls_one_at_a_time(scene, balanced):
    _, one_at_a_time = balanced
    r = MultiChipRenderer(_cfg(calls_per_exec=4), scene=scene, devices=CPU4)
    calls = []
    orig = r.render_call

    def call(spp, number=0, accum=None, n_calls=None, spp_last=None):
        calls.append((spp, number, n_calls, spp_last))
        return orig(spp, number, accum, n_calls=n_calls, spp_last=spp_last)

    r.render_call = call
    merged, total = r.render()
    assert calls == [(2, 0, 2, 2)] and total == SPP
    assert torch.equal(merged, one_at_a_time)


def _by_name(recs):
    out = {}
    for rec in recs:
        out.setdefault(rec.name, []).append(rec)
    return out


def test_band_spans_nest_under_the_call(scene):
    r = MultiChipRenderer(_cfg(samples_per_call=1), scene=scene, devices=CPU4)
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        r.render_call(1, number=5)
    spans = _by_name(launches.records(t0))
    (bal,) = spans["bands.balance"]
    assert bal.parent is None and bal.attrs["probe_spp"] == 2 and bal.attrs["tables"] == 4
    (call,) = spans["bands.call"]
    assert call.parent is None
    assert {k: call.attrs[k] for k in ("spp", "n_calls", "n_bands", "devices")} == \
        dict(spp=1, n_calls=1, n_bands=4, devices=1)
    assert 0.0 < call.attrs["host_step_s"] <= call.t1 - call.t0
    assert call.attrs["idle_passes"] == 0  # the CPU's steps are done when they return
    bands = [b for b in spans["bands.band"] if b.parent == call.id]
    assert sorted(b.attrs["y0"] for b in bands) == [0, 12, 24, 36]
    for b in bands:
        assert b.attrs["device"] is None and b.attrs["rows"] == 12 and b.attrs["steps"] >= 1
        assert call.t0 <= b.t0 <= b.t1 <= call.t1
    (gather,) = spans["bands.gather"]
    assert gather.parent == call.id and gather.attrs["bytes"] == H * W * 3 * 4
    setups = [s for s in spans["band.setup"] if s.parent == call.id]
    grid = [s for s in spans["grid.launch"] if s.parent == call.id]
    assert len(setups) == 4 and len(grid) >= 4
    assert all(g.attrs["device"] is None for g in grid)
    # the probes' spans lie under the balance span, not under the call
    assert {s.parent for s in spans["band.setup"]} == {call.id, bal.id}


def test_band_spans_record_nothing_with_the_profiler_off(scene):
    r = MultiChipRenderer(_cfg(samples_per_call=1), scene=scene, devices=CPU4)
    t0 = time.perf_counter()
    r.render_call(1)
    assert not launches.recording() and launches.records(t0) == []


def test_each_band_keeps_its_stream_across_calls(monkeypatch):
    """``run_in_turns``' streams: one per band, distinct for bands of one
    card, the same on every call (the caching allocator keeps its blocks
    per stream), none on the CPU."""
    from raytrace_tpu_torch.parallel import devices as pdev

    made = []

    def stream(dev):
        made.append(dev)
        return object()

    monkeypatch.setattr(pdev, "_STREAMS", {})
    monkeypatch.setattr(torch.cuda, "Stream", stream)
    c0, c1 = torch.device("cuda", 0), torch.device("cuda", 1)
    first = pdev.band_streams([c0, c0, c1, torch.device("cpu")])
    assert first[3] is None and len({id(s) for s in first[:3]}) == 3
    assert pdev.band_streams([c0, c0, c1, torch.device("cpu")]) == first
    assert pdev.band_streams([c1, c0]) == [first[2], first[0]]
    assert made == [c0, c0, c1]
