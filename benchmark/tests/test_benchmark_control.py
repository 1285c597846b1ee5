"""The comparison fails what it must: the control (the reference in
bfloat16 in the program's place) and runs whose timed path is broken
underneath, at a tiny size on the CPU, the harness's look for a card
skipped."""

import pytest
import torch

from benchmark import control, spec


@pytest.mark.parametrize("name", ["t-off", "t-frames"])
def test_the_control_is_not_correct(tiny, name):
    bench, base = tiny
    cell = spec.cell(bench, name, base=base)
    for seed in (11, 2**31 + 12, 13):
        v = control.control_reading(cell, seed, torch.device("cpu"))
        assert not v["correct"]
        assert v["numbers"]["px_off"]["value"] > v["numbers"]["px_off"]["limit"]


def _unchanged(mp):
    """A render call that returns its state (the carried sum) unchanged."""
    from raytrace_tpu_torch.parallel.sharding import MultiChipRenderer
    from raytrace_tpu_torch.runtime.renderer import Renderer

    for cls in (Renderer, MultiChipRenderer):
        orig = cls.render_call

        def call(self, spp, number=0, accum=None, *a, _orig=orig, **k):
            out = _orig(self, spp, number, accum, *a, **k)
            return torch.zeros_like(out) if accum is None else torch.as_tensor(accum)

        mp.setattr(cls, "render_call", call)


def _half(mp):
    """Half of each band's rows left out."""
    from raytrace_tpu_torch.ops import trace
    from raytrace_tpu_torch.parallel import sharding

    orig = trace.render_band_steps

    def steps(*a, **k):
        out = yield from orig(*a, **k)
        out = out.clone()
        out[out.shape[0] // 2:] = 0.0
        return out

    mp.setattr(trace, "render_band_steps", steps)
    mp.setattr(sharding, "render_band_steps", steps)


def _altered(mp):
    """Every answer altered where it is produced: the grid and paged steps
    add a little to the sums they accumulate."""
    from raytrace_tpu_torch.ops import gridkernel, pagedkernel

    for mod, name in ((gridkernel, "grid_megakernel_step_plain"),
                      (pagedkernel, "paged_megakernel_step_plain")):
        orig = getattr(mod, name)

        def step(*a, _orig=orig, **k):
            out = _orig(*a, **k)
            a[5].add_(1e-3)  # the home-order accumulator, in place
            return out

        step.launches = 0
        mp.setattr(mod, name, step)


def _late_scene(mp):
    """The frame loop's state a frame stale: ``set_scene`` takes effect one
    frame late, so each frame renders the scene of the frame before it."""
    from raytrace_tpu_torch.runtime.renderer import Renderer

    orig = Renderer.set_scene

    def late(self, scene):
        prev = getattr(self, "_handed", None)
        self._handed = scene
        orig(self, scene if prev is None else prev)

    mp.setattr(Renderer, "set_scene", late)


def _scene_kept(mp):
    """``set_scene`` ignored after the warm-up's first frame: every frame of
    the window renders that frame's scene."""
    from raytrace_tpu_torch.runtime.renderer import Renderer

    orig = Renderer.set_scene

    def once(self, scene):
        self._handed = getattr(self, "_handed", 0) + 1
        if self._handed <= 2:  # the constructor's call, then the warm-up's
            orig(self, scene)

    mp.setattr(Renderer, "set_scene", once)


def _no_exchange(mp):
    """The bands' results not gathered: the first band stands for all."""
    from raytrace_tpu_torch.parallel import sharding

    orig = sharding.run_in_turns

    def turns(devices, steps):
        results, done = orig(devices, steps)
        return [torch.zeros_like(r) if i else r for i, r in enumerate(results)], done

    mp.setattr(sharding, "run_in_turns", turns)


@pytest.mark.parametrize("fault,cells", [
    (_unchanged, ["t-off", "t-bands"]),
    (_half, ["t-off", "t-frames", "t-bands"]),
    (_altered, ["t-off", "t-frames"]),
    (_no_exchange, ["t-bands"]),
    (_late_scene, ["t-frames"]),
    (_scene_kept, ["t-frames"]),
], ids=["state-unchanged", "half-left-out", "answer-altered", "exchange-left-out",
        "scene-a-frame-late", "scene-never-replaced"])
def test_a_broken_timed_path_is_not_correct(run_tiny, monkeypatch, fault, cells):
    fault(monkeypatch)
    for name in cells:
        res = run_tiny(name)
        assert res["correct"] is False, name
        assert res["check"]["px_off"]["value"] > res["check"]["px_off"]["limit"]


def test_a_scene_a_frame_late_is_not_correct(tiny):
    """``control.late_scene_reading``, the fault's reading at a cell's size,
    fails the comparison at the tiny size too."""
    bench, base = tiny
    cell = spec.cell(bench, "t-frames", base=base)
    for seed in (11, 2**31 + 12, 13):
        v = control.late_scene_reading(cell, seed, torch.device("cpu"))
        assert not v["correct"]
        assert v["numbers"]["px_off"]["value"] > v["numbers"]["px_off"]["limit"]
