"""Port: renderer and public API (runtime/renderer.py, api.py).

``raytrace_tpu_torch.ray_trace`` must reproduce the oracle golden through the
public entry point (u8 within one level on all but 3 pixels, the chaos
budget of tests/test_golden_fullscene.py), keep chunking, progressive calls,
the call merge (``calls_per_exec``) and balanced lanes (``balance_spp``)
exact, run every backend, checkpoint and resume (the cases of
tests/test_runtime.py), split row bands over devices for ``gpu_count`` /
``chips`` above 1 with the single-device image, refuse every option the port
does not run yet by name, run on the CPU only when asked to, and never
import jax.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import raytrace_tpu_torch
from raytrace_tpu.ops.image import accum_to_u8 as j_accum_to_u8
from raytrace_tpu_torch import RenderConfig
from raytrace_tpu_torch.models.scene import three_sphere_scene
from raytrace_tpu_torch.ops import (gridkernel, megakernel, pagedkernel,
                                    pallas_intersect, trace)
from raytrace_tpu_torch.ops.image import accum_to_u8
from raytrace_tpu_torch.runtime.renderer import Renderer, reference_camera
from raytrace_tpu_torch.utils.png import encode_png

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "golden_fullscene_24x14_2spp_d12.npy")


def test_ray_trace_matches_golden_and_writes_png(tmp_path, capsys):
    out = tmp_path / "r.png"
    before = gridkernel.grid_megakernel_step_plain.launches
    img = raytrace_tpu_torch.ray_trace(samples=2, width=24, height=14, max_depth=12,
                                       store_render_result=True, out_path=str(out),
                                       device="cpu")
    assert gridkernel.grid_megakernel_step_plain.launches > before  # auto -> grid
    assert "duration_per_frame:" in capsys.readouterr().out
    ref = np.asarray(j_accum_to_u8(np.load(GOLDEN), 2))
    assert img.shape == (14, 24, 3) and img.dtype == np.uint8
    off = int((np.abs(img.astype(int) - ref.astype(int)).max(axis=2) > 1).sum())
    assert off <= 3, f"{off} pixels off by more than one level"
    assert out.read_bytes() == encode_png(img)


def test_accum_to_u8_matches_jax():
    acc = np.random.default_rng(0).uniform(0, 3, (7, 5, 3)).astype(np.float32)
    ref = np.asarray(j_accum_to_u8(acc, 2))
    assert np.array_equal(accum_to_u8(acc, 2), ref)
    assert np.array_equal(accum_to_u8(torch.from_numpy(acc), 2).numpy(), ref)


@pytest.mark.parametrize("backend", ["grid", "bruteforce"])
def test_chunk_rows_invariant(backend):
    cfg = RenderConfig(samples=1, width=32, height=18, max_depth=6, backend=backend)
    whole = Renderer(cfg, device="cpu").render_call(1)
    r = Renderer(cfg, device="cpu")
    r.chunk_rows = 5  # bands of 5, 5, 5, 3 rows
    assert torch.equal(r.render_call(1), whole)


def test_progressive_samples_per_call():
    cfg = RenderConfig(samples=3, width=24, height=14, max_depth=6, samples_per_call=2)
    r = Renderer(cfg, device="cpu")
    acc, total = r.render()
    assert total == 3
    one = r.render_call(2, number=0)
    assert torch.equal(acc, r.render_call(1, number=1, accum=one))
    seen = []
    r.render(on_chunk=lambda a, done: seen.append(done))
    assert seen == [2, 3]


@pytest.mark.parametrize("bands", [None, 2], ids=["renderer", "two_bands"])
def test_float64_accumulation(bands):
    """``accum_dtype="float64"`` sums the calls in float64, on one device
    and over row bands (``MultiChipRenderer`` on two CPU bands): the bands'
    sum is the single device's bit for bit."""
    from raytrace_tpu_torch.parallel.sharding import MultiChipRenderer

    cfg = RenderConfig(samples=2, width=16, height=9, max_depth=6, samples_per_call=1)
    f64 = dataclasses.replace(cfg, accum_dtype="float64")
    acc32, _ = Renderer(cfg, device="cpu").render()
    want, _ = Renderer(f64, device="cpu").render()
    r = (Renderer(f64, device="cpu") if bands is None
         else MultiChipRenderer(f64, devices=["cpu"] * bands))
    acc64, _ = r.render()
    assert acc64.dtype == torch.float64
    assert torch.equal(acc64, want)
    assert torch.allclose(acc64, acc32.double(), rtol=1e-6, atol=1e-6)


def test_mega_backend_and_three_sphere_scene_resolve_to_mega():
    sc = three_sphere_scene()  # no small-sphere field: no grid tables
    r = Renderer(RenderConfig(samples=1, width=16, height=9, max_depth=4), scene=sc,
                 device="cpu")
    assert r.backend == "mega"
    before = megakernel.megakernel_step_plain.launches
    r.render_call(1)
    assert megakernel.megakernel_step_plain.launches > before


def test_gpu_count_and_chips_split_row_bands():
    """``ray_trace(gpu_count=2)`` and ``render_image(chips=...)`` go through
    the row bands: on the CPU one device, one band; over an explicit device
    list, one band per entry; the image is the single device's."""
    kw = dict(samples=1, width=16, height=9, max_depth=4, device="cpu")
    one = raytrace_tpu_torch.ray_trace(**kw)
    assert np.array_equal(raytrace_tpu_torch.ray_trace(gpu_count=2, **kw), one)
    cfg = RenderConfig(samples=1, width=16, height=9, max_depth=4, chips=3)
    assert np.array_equal(raytrace_tpu_torch.render_image(cfg, device="cpu"), one)
    assert np.array_equal(
        raytrace_tpu_torch.render_image(cfg, device="cpu", devices=["cpu"] * 3), one)


@pytest.mark.parametrize("backend", ["paged", "pallas", "matmul"])
def test_ray_trace_backends_on_cpu(backend):
    """Each spec backend renders the book scene through ``ray_trace`` on the
    CPU through its kernel's plain version, close to the grid render: the
    image differs from it only on fp-chaotic pixels.  ``paged`` asked for by
    name on the book scene, which the flat grid holds and which has no paged
    tables, raises as the JAX driver does."""
    kw = dict(samples=2, width=24, height=14, max_depth=8, device="cpu")
    if backend == "paged":
        with pytest.raises(ValueError, match="paged backend requires"):
            raytrace_tpu_torch.ray_trace(backend=backend, **kw)
        return
    counter = {"pallas": pallas_intersect.intersect_shade_pallas_plain,
               "matmul": None}[backend]
    before = counter.launches if counter else 0
    img = raytrace_tpu_torch.ray_trace(backend=backend, **kw)
    if counter:
        assert counter.launches > before
    ref = raytrace_tpu_torch.ray_trace(backend="grid", **kw)
    close = (np.abs(img.astype(int) - ref.astype(int)).max(axis=2) <= 1).mean()
    assert close > 0.85, close


def test_render_image_dense_field_on_cpu():
    """The dense-scene entry point: ``render_image`` of a 2000-sphere field
    resolves to ``paged`` and renders the same image as ``mega``."""
    from raytrace_tpu_torch.models.scene import random_sphere_field

    scene = random_sphere_field(2000, seed=1, extent=7.0)
    cfg = RenderConfig(samples=2, width=24, height=14, max_depth=5)
    before = pagedkernel.paged_megakernel_step_plain.launches
    img = raytrace_tpu_torch.render_image(cfg, scene=scene, device="cpu")
    assert pagedkernel.paged_megakernel_step_plain.launches > before
    mega = raytrace_tpu_torch.render_image(dataclasses.replace(cfg, backend="mega"),
                                           scene=scene, device="cpu")
    assert img.shape == (14, 24, 3) and np.array_equal(img, mega)


def test_cuda_is_the_default_device():
    """Without a CUDA device the entry points raise unless asked for the
    CPU; they never fall back to it on their own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    cfg = RenderConfig(samples=1, width=8, height=4, max_depth=2)
    for call in (lambda: raytrace_tpu_torch.ray_trace(samples=1, width=8, height=4),
                 lambda: raytrace_tpu_torch.render_image(cfg),
                 lambda: Renderer(cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert Renderer(cfg, device="cpu").device.type == "cpu"


def test_out_of_slice_config_and_band_options_raise():
    # chips > 1: the Renderer renders on its one device, as JAX's does
    cfg = RenderConfig(samples=1, width=8, height=4, max_depth=2)
    assert torch.equal(Renderer(dataclasses.replace(cfg, chips=2), device="cpu").render_call(1),
                       Renderer(cfg, device="cpu").render_call(1))
    ds = trace.device_scene_from_numpy(
        trace.prepare_scene(raytrace_tpu_torch.generate_random_scene(0.0)), "cpu")
    vp = trace.viewport_arrays(reference_camera(), 8, 4)
    base = dict(band_h=4, width=8, y0=0, seed_y0=0, offset_x=0, spp=1, number=0,
                max_depth=2, backend="grid")
    for extra in (dict(ablate=("fuse2",)), dict(ablate=("iterstats", "state2")),
                  dict(grid_steps=(2, 40, False, 1)), dict(grid_steps=(2, 40))):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            trace.render_band(ds, vp, **base, **extra)
    # the call merge, a table and the iterstats probe run on the grid backend
    one = trace.render_band(ds, vp, **base)
    two = trace.render_band(ds, vp, **dict(base, number=1), accum_init=one)
    assert torch.equal(trace.render_band(ds, vp, **base, n_calls=2, spp_last=1), two)
    table = np.full((1, 128), 32, np.int32)
    table[0, :32] = np.arange(32)[::-1]
    assert torch.equal(trace.render_band(ds, vp, **base, passign=table), one)
    probe = trace.render_band(ds, vp, **base, ablate=("iterstats",))
    assert torch.equal(probe[..., 1:], one[..., 1:]) and bool((probe[..., 0] >= 1).all())


def test_ray_trace_balance_spp_runs():
    """``balance_spp`` probes and renders through balanced tables: the image
    of ``ray_trace`` is the unbalanced one."""
    kw = dict(samples=2, width=24, height=14, max_depth=6, mode="fast", device="cpu")
    assert np.array_equal(raytrace_tpu_torch.ray_trace(balance_spp=8, **kw),
                          raytrace_tpu_torch.ray_trace(**kw))


@pytest.mark.parametrize("spc", [1, 2])
def test_calls_per_exec_equals_host_loop(spc):
    """``calls_per_exec=3`` merges up to three progressive calls into one
    dispatch (5 spp: 3 + 2 calls of 1 spp, or 2 + 1 calls of 2, 2 and 1
    spp): the accumulator is the host loop's bit for bit, and ``on_chunk``
    fires once per dispatch."""
    cfg = RenderConfig(samples=5, width=24, height=14, max_depth=6, samples_per_call=spc,
                       mode="fast")
    ref, total = Renderer(cfg, device="cpu").render()
    seen = []
    r = Renderer(dataclasses.replace(cfg, calls_per_exec=3), device="cpu")
    acc, total3 = r.render(on_chunk=lambda a, done: seen.append(done))
    assert total == total3 == 5 and torch.equal(acc, ref)
    assert seen == ([3, 5] if spc == 1 else [5])
    # off the grid backend the calls run one by one
    mega = dataclasses.replace(cfg, backend="mega")
    mega_ref = Renderer(mega, device="cpu").render()[0]
    seen.clear()
    r = Renderer(dataclasses.replace(mega, calls_per_exec=3), device="cpu")
    assert torch.equal(r.render(on_chunk=lambda a, done: seen.append(done))[0], mega_ref)
    assert len(seen) == -(-5 // spc)


def test_set_scene():
    cfg = RenderConfig(samples=1, width=16, height=9, max_depth=4)
    r = Renderer(cfg, device="cpu")
    assert r.backend == "grid"
    r.set_scene(three_sphere_scene())
    assert r.backend == "mega"
    fresh = Renderer(cfg, scene=three_sphere_scene(), device="cpu")
    assert torch.equal(r.render_call(1), fresh.render_call(1))


def _small(w=32, h=18, **kw):
    cfg = RenderConfig(width=w, height=h, max_depth=6, backend="matmul", **kw)
    return Renderer(cfg, scene=three_sphere_scene(), device="cpu")


def test_checkpoint_roundtrip_and_resolution_mismatch(tmp_path):
    r = _small()
    accum = r.render_call(2)
    p = str(tmp_path / "ckpt.npz")
    r.save_state(p, accum, samples_done=2, number=1)
    a2, done, num = r.load_state(p)
    assert np.array_equal(a2, accum.numpy()) and done == 2 and num == 1
    other = Renderer(RenderConfig(width=16, height=9, max_depth=6, backend="matmul"),
                     scene=three_sphere_scene(), device="cpu")
    with pytest.raises(ValueError):
        other.load_state(p)


def test_resumable_render_matches_uninterrupted(tmp_path):
    p = str(tmp_path / "ck.npz")
    full, _ = _small(samples_per_call=2).render_resumable(6)
    r2 = _small(samples_per_call=2)
    acc = r2.render_call(2, number=1, accum=r2.render_call(2, number=0))
    r2.save_state(p, acc, 4, 2)
    resumed, done = _small(samples_per_call=2).render_resumable(6, checkpoint_path=p)
    assert done == 6 and torch.equal(resumed, full)


def test_resumable_retries_then_gives_up(monkeypatch):
    """A failing call is retried without losing the accumulated work, up to
    ``max_retries`` times."""
    calls = {"n": 0}
    orig = Renderer.render_call

    def flaky(self, spp, number=0, accum=None):
        calls["n"] += 1
        if calls["n"] == 2:  # fail once mid-render
            raise RuntimeError("device fault")
        return orig(self, spp, number=number, accum=accum)

    monkeypatch.setattr(Renderer, "render_call", flaky)
    accum, done = _small(samples_per_call=2).render_resumable(4)
    assert done == 4 and calls["n"] == 3
    monkeypatch.setattr(Renderer, "render_call", orig)
    assert torch.equal(accum, _small(samples_per_call=2).render_resumable(4)[0])

    def broken(self, spp, number=0, accum=None):
        raise RuntimeError("boom")

    monkeypatch.setattr(Renderer, "render_call", broken)
    with pytest.raises(RuntimeError):
        _small(samples_per_call=2).render_resumable(4, max_retries=1)


def test_benchmark_frame_loop(capsys):
    dpf, frames = _small(8, 4, samples=1).benchmark(min_seconds=0.0, warmup=0)
    assert dpf > 0 and frames >= 1
    assert "duration_per_frame:" in capsys.readouterr().out


def test_import_leaves_jax_out():
    code = ("import sys, raytrace_tpu_torch; "
            "import raytrace_tpu_torch.parallel.hetero, raytrace_tpu_torch.runtime.production, "
            "raytrace_tpu_torch.runtime.frames, raytrace_tpu_torch.utils.cli; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'raytrace_tpu' or m.startswith('raytrace_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
