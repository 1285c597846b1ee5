"""The plain reference against the program at tiny sizes on the CPU: its
scenes, its viewport and its sums, bit for bit (the program's plain
versions are held bit-equal to its CUDA kernels by the repository's own
card tests)."""

import numpy as np
import pytest
import torch

from benchmark.reference import camera, scenes, tracer


def _program_scene(kind, t, seed):
    from raytrace_tpu_torch.models.scene import generate_random_scene, random_sphere_field

    if kind == "book":
        return generate_random_scene(t)
    return random_sphere_field(1500, seed=seed, t=t)


@pytest.mark.parametrize("kind,t,seed", [("book", 0.0, 0), ("book", 123.456, 0),
                                         ("field", 0.0, 2**32 - 5), ("field", 2.5, 17)])
def test_scenes_equal_the_programs(kind, t, seed):
    p = _program_scene(kind, t, seed)
    r = scenes.book_scene(t) if kind == "book" else scenes.sphere_field(1500, seed, t=t)
    n = int(p.n_spheres)
    assert len(r.radii) == n
    for f in ("centers", "radii", "material", "texture", "color0", "color1", "attr"):
        assert np.array_equal(getattr(p, f)[:n], getattr(r, f)), f


def test_viewport_equals_the_programs():
    from raytrace_tpu_torch.ops.trace import viewport_arrays
    from raytrace_tpu_torch.runtime.renderer import reference_camera

    for w, h in ((1920, 1080), (3840, 2160), (24, 14)):
        p = viewport_arrays(reference_camera(), w, h)
        r = camera.viewport(w, h)
        for pk, rk in (("horizontal", "horizontal"), ("vertical", "vertical"),
                       ("upper_left", "upper_left"), ("cam_up", "up"),
                       ("cam_right", "right"), ("look_from", "look_from")):
            assert np.array_equal(getattr(p, pk), r[rk]), pk


@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("kind,backend", [("book", "grid"), ("book", "mega"), ("field", "auto")])
def test_sums_equal_the_programs_bit_for_bit(kind, backend, mode, small_profile):
    from raytrace_tpu_torch.config import RenderConfig
    from raytrace_tpu_torch.runtime.renderer import Renderer

    w, h = 20, 12
    ps = _program_scene(kind, 0.7, 9)
    rs = scenes.book_scene(0.7) if kind == "book" else scenes.sphere_field(1500, 9, t=0.7)
    cfg = RenderConfig(samples=3, width=w, height=h, backend=backend, mode=mode)
    r = Renderer(cfg, scene=ps, device="cpu")
    merged = r.backend == "grid"
    acc = r.render_call(3, number=2**31 + 9, n_calls=2 if merged else None,
                        spp_last=2 if merged else None)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pix = np.stack([xx.ravel(), yy.ravel()], 1)
    nums = np.tile([2**31 + 9, 2**31 + 10] if merged else [2**31 + 9], (len(pix), 1))
    ref = tracer.render_pixels(rs, camera.viewport(w, h), pix, nums, [3, 2] if merged else [3],
                               50, cfg.rr)
    assert torch.equal(acc.reshape(-1, 3), ref)


def test_the_control_dtype_runs_and_differs():
    sc = scenes.book_scene(0.0)
    pix = np.array([[5, 5], [10, 7], [3, 11]])
    nums = np.zeros((3, 1), np.int64)
    f32 = tracer.render_pixels(sc, camera.viewport(16, 12), pix, nums, [4], 50, (1, 16, 0.05))
    bf16 = tracer.render_pixels(sc, camera.viewport(16, 12), pix, nums, [4], 50, (1, 16, 0.05),
                                dtype=torch.bfloat16)
    assert bf16.dtype == torch.bfloat16 and torch.isfinite(bf16.float()).all()
    assert not torch.equal(bf16.float(), f32)


def test_tonemap_equals_the_programs():
    from raytrace_tpu_torch.ops.image import accum_to_u8

    x = torch.rand(500, 3, generator=torch.Generator().manual_seed(3)) * 3.0
    assert torch.equal(tracer.tonemap_u8(x, 2), accum_to_u8(x, 2))
