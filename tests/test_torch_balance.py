"""Port: balanced pixel->lane tables (runtime/balance.py) and the renderer's
use of them.

The numpy of ``build_passign`` and ``balance_stats`` is a copy of the JAX
package's, so both give equal outputs on seeded inputs (tables compared
entry for entry, statistics exactly).  The cost map comes from the port's
grid kernel in iterstats mode; against the JAX package's
``measure_cost_map`` (its Pallas kernel in interpret mode, whose XLA:CPU
float noise moves a few paths) the counts are equal on >= 97% of pixels and
the mean within 1% (measured: see ROADMAP section 3).  Within the port the
balanced render equals the unbalanced one bit for bit: every pixel still
renders whole, on one lane, its samples in order.
"""

import numpy as np
import pytest
import torch

from raytrace_tpu.models.scene import generate_random_scene as j_book
from raytrace_tpu.ops import trace as jtrace
from raytrace_tpu.runtime import balance as jbal
from raytrace_tpu.runtime.renderer import reference_camera as j_camera
from raytrace_tpu.utils.compare import compare_accums as j_compare
from raytrace_tpu_torch import RenderConfig, generate_random_scene
from raytrace_tpu_torch.ops import trace
from raytrace_tpu_torch.runtime import balance
from raytrace_tpu_torch.runtime.renderer import Renderer, reference_camera
from raytrace_tpu_torch.utils.compare import compare_accums

torch.set_num_threads(1)

W, H, SPP = 48, 27, 2
P = W * H
FAST = (1, 16, 0.05)


@pytest.mark.parametrize("method", ["lpt", "serpentine"])
@pytest.mark.parametrize("m, tile", [(1, 128), (2, 128), (3, 4096), (64, 128)])
def test_build_passign_equals_jax(method, m, tile):
    rng = np.random.default_rng(m * 7 + tile)
    for cost in (rng.random(P), rng.lognormal(1.0, 0.8, (H, W)), np.ones(P)):
        tab = balance.build_passign(cost, m, tile, method=method)
        ref = jbal.build_passign(cost, m, tile, method=method)
        assert tab.dtype == ref.dtype == np.int32 and np.array_equal(tab, ref)
        flat = tab.ravel()
        assert np.array_equal(np.sort(flat[flat < P]), np.arange(P))  # each pixel once
        for t in (None, tab):
            assert balance.balance_stats(cost, t, m) == jbal.balance_stats(cost, t, m)
    with pytest.raises(ValueError):
        balance.build_passign(cost, m, tile, method="nope")


def test_compare_accums_equals_jax():
    rng = np.random.default_rng(2)
    a = rng.random((72, 128, 3)).astype(np.float32) * 4
    b = a + rng.normal(0, 0.05, a.shape).astype(np.float32)
    for tile, spp in ((8, 2), (16, 4), (2, 1)):
        assert compare_accums(a, b, spp, spp, tile=tile) == j_compare(a, b, spp, spp, tile=tile)
    assert compare_accums(a, a, 2, 2).matches() and compare_accums(a, a, 2, 2).psnr_db == 99.0


def _band_kwargs(ds, vp, **kw):
    return dict(scene=ds, vp=vp, band_h=H, width=W, y0=0, seed_y0=0, offset_x=0,
                number=0, max_depth=8, backend="grid", pixels_per_lane=2,
                skip_tmax=True, rr=FAST, **kw)


def test_cost_map_matches_jax():
    """The iterstats probe's counts (2 spp, fast mode, depth 8, M=2) against
    the JAX package's probe: equal on >= 97% of pixels, the mean within 1%."""
    ds = trace.device_scene_from_numpy(trace.prepare_scene(generate_random_scene(0.0)), "cpu")
    cost = balance.measure_cost_map(
        _band_kwargs(ds, trace.viewport_arrays(reference_camera(), W, H)), SPP)
    jds = jtrace.prepare_scene(j_book(0.0))
    jkw = _band_kwargs(jds, jtrace.viewport_arrays(j_camera(), W, H))
    jkw.update(y0=np.int32(0), seed_y0=np.int32(0), offset_x=np.int32(0),
               number=np.uint32(0))
    ref = np.asarray(jbal.measure_cost_map(jkw, SPP))
    assert cost.shape == ref.shape == (H, W)
    assert (cost >= SPP).all() and cost.mean() / SPP > 1.0
    same = float((cost == ref).mean())
    assert same >= 0.97, f"{same:.2%} of pixels count the same"
    assert abs(cost.mean() - ref.mean()) / ref.mean() < 0.01


def _cfg(**kw):
    return RenderConfig(**dict(dict(samples=SPP, width=W, height=H, max_depth=8,
                                    backend="grid", mode="fast", pixels_per_lane=2), **kw))


def test_renderer_balance_equals_unbalanced():
    """``balance_spp=2`` probes, builds a table per band and renders the
    unbalanced image bit for bit, with chunking (bands of 10 rows) too."""
    base = Renderer(_cfg(), device="cpu").render_call(SPP)
    r = Renderer(_cfg(balance_spp=2), device="cpu")
    assert torch.equal(r.render_call(SPP), base)
    assert set(r.balance_stats) == {0} and r.passign[0].dtype == torch.int32
    assert r.passign[0].shape == (2, -(-(P // 2) // trace.LANE_PAD) * trace.LANE_PAD)
    stats = r.balance_stats[0]
    assert stats["lanes"] == P // 2 and stats["max_over_mean"] >= 1.0
    assert 1.0 <= stats["issued_per_sample"] <= 30.0
    banded = Renderer(_cfg(balance_spp=2), device="cpu")
    banded.chunk_rows = 10
    assert torch.equal(banded.render_call(SPP), base)
    assert sorted(banded.passign) == [0, 10, 20]


def test_enable_balance_off_grid_and_render_band_options_raise():
    r = Renderer(_cfg(backend="mega"), device="cpu")
    with pytest.raises(ValueError, match="grid-backend"):
        r.enable_balance(2)
    ds = r.device_scene
    kw = _band_kwargs(ds, r.vp, spp=1)
    kw.pop("scene"), kw.pop("vp")
    tab = balance.build_passign(np.ones(P), 2, trace.LANE_PAD)
    for backend in ("mega", "bruteforce"):
        for extra in (dict(passign=tab), dict(n_calls=2), dict(spp_last=1),
                      dict(ablate=("iterstats",))):
            with pytest.raises(ValueError, match="grid-backend"):
                trace.render_band(ds, r.vp, **dict(kw, backend=backend), **extra)
    with pytest.raises(ValueError, match="passign"):  # a table of the wrong shape
        trace.render_band(ds, r.vp, **kw, passign=tab[:, :128])


def test_render_call_return_iters():
    """``return_iters``: the launches' iterations over blocks of 128 lanes
    and over lane slots (lane_slots == 128 tile_iters), the image unchanged,
    and the busy iterations the probe counted fit in the slots."""
    r = Renderer(_cfg(balance_spp=2), device="cpu")
    acc, tile_iters, lane_slots = r.render_call(SPP, return_iters=True)
    assert torch.equal(acc, r.render_call(SPP))
    assert tile_iters > 0 and lane_slots == tile_iters * trace.LANE_PAD
    busy = r.balance_stats[0]["issued_per_sample"] * P * SPP
    assert busy <= lane_slots, (busy, lane_slots)
