"""Port: row bands over several devices (parallel/) and the workload tuner
(runtime/tuner.py), on the CPU.

The tuner is plain Python copied from the JAX package, so its decision
stream equals JAX's ``PyTuner`` over seeded random rounds, and the native
tuner built from ``native/tuner.cpp`` into the port's ``build/`` gives the
same stream.  ``MultiChipRenderer`` and ``HeteroRenderer`` over a device
list (``["cpu"] * 4`` here: four bands of one device, stepped in turns)
render in global-seed mode the single-device ``Renderer``'s image
bit for bit on every kernel backend: the port's plain path has no XLA
noise, so JAX's 1% chaos budget between band shapes does not apply within
the port.  Against the JAX package (``matmul``, XLA:CPU contracting FMAs)
reference banding is held to that budget.  The cases of tests/test_hetero.py
follow, with ``render_band_steps`` replaced by a synthetic device for the
probe and the tuner's convergence: each of its steps first blocks until
its previous launch is done, as the port's drivers block on their host
sync, then issues the next launch and yields it.  Its launches run on a
virtual clock that the dispatch reads in place of ``time``, so the times
the probe and the tuner see are exact, whatever the host's load.
"""

import shutil
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from raytrace_tpu.config import RenderConfig as JConfig
from raytrace_tpu.models.scene import three_sphere_scene as j_three
from raytrace_tpu.parallel.sharding import MultiChipRenderer as JMultiChip
from raytrace_tpu.runtime import tuner as jtuner
from raytrace_tpu_torch import RenderConfig, _build
from raytrace_tpu_torch.models.scene import (generate_random_scene,
                                             random_sphere_field,
                                             three_sphere_scene)
from raytrace_tpu_torch.ops import launches, trace
from raytrace_tpu_torch.parallel import devices as pdev
from raytrace_tpu_torch.parallel import hetero
from raytrace_tpu_torch.parallel.hetero import HeteroRenderer
from raytrace_tpu_torch.parallel.sharding import MultiChipRenderer
from raytrace_tpu_torch.runtime import tuner
from raytrace_tpu_torch.runtime.renderer import Renderer
from raytrace_tpu_torch.runtime.validation import GOLDEN

torch.set_num_threads(1)

CPU4 = ["cpu"] * 4
W, H, SPP = 32, 24, 2


def _cfg(**kw):
    kw.setdefault("samples", SPP)
    kw.setdefault("width", W)
    kw.setdefault("height", H)
    kw.setdefault("max_depth", 6)
    kw.setdefault("backend", "matmul")
    kw.setdefault("chips", 4)
    return RenderConfig(**kw)


# ---- the tuner ---------------------------------------------------------------

def _rounds(n_rounds=200, devices=3, total=1080, seed=7):
    """Seeded tuner inputs: durations and estimates, every fifth round with
    one device 10x slower (the variance branch)."""
    rng = np.random.default_rng(seed)
    out = []
    for r in range(n_rounds):
        est = rng.uniform(0.9, 1.1, devices)
        if r % 5 == 0:
            est[rng.integers(devices)] *= 10.0
        out.append((float(rng.uniform(0.5, 2.0)), [float(e) for e in est]))
    return out


def _stream(t, rounds, total=1080, devices=3):
    """The tuner's decisions over ``rounds``, the split carried as the
    hetero renderer carries it."""
    dist = [total // devices] * devices
    dist[0] += total - sum(dist)
    decisions = []
    for dur, est in rounds:
        t.add_frame(dist, dur, est)
        new = t.get_workload()
        decisions.append(new)
        if new is not None:
            dist = list(new)
    return decisions


def test_pytuner_stream_equals_jax():
    rounds = _rounds()
    seed = 0xDEADBEEF12345678
    port = tuner.PyTuner(total=1080, devices=3, seed=seed)
    ref = jtuner.PyTuner(total=1080, devices=3, seed=seed)
    got, want = _stream(port, rounds), _stream(ref, rounds)
    assert got == want
    assert port.seed == ref.seed
    assert [(f.dist, f.duration, f.est) for f in port.frames] == \
        [(f.dist, f.duration, f.est) for f in ref.frames]
    # every branch ran: redistribution (variance), hill-climb, converged;
    # and the history cap (200 frames added, at most 11 kept)
    redistributed = sum(1 for (_, est), d in zip(rounds, got)
                        if d is not None and max(est) > 5.0)
    assert redistributed >= 30
    assert any(d is None for d in got) and len(port.frames) <= 11


def test_native_tuner_stream_equals_python():
    if shutil.which("g++") is None:
        pytest.skip("g++ is missing: the native tuner cannot be built")
    rounds = _rounds(seed=11)
    seed = 0x9E3779B97F4A7C15
    nt = tuner.make_tuner(1080, 3, seed, native=True)
    assert isinstance(nt, tuner.NativeTuner)
    assert _build.tuner_library().parent.parent == _build.REPO / "build" / "tuner"
    assert _stream(nt, rounds) == _stream(tuner.PyTuner(1080, 3, seed), rounds)
    assert isinstance(tuner.make_tuner(1080, 3, seed), tuner.PyTuner)


def test_native_tuner_build_failure_raises(tmp_path, monkeypatch):
    """A source that does not compile raises; no Python tuner stands in."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is missing")
    bad = tmp_path / "tuner.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_build, "TUNER_SOURCE", bad)
    monkeypatch.setattr(_build, "REPO", tmp_path)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tuner.make_tuner(100, 2, native=True)


# ---- devices and dispatch ----------------------------------------------------

def test_pick_devices(monkeypatch):
    cpu = torch.device("cpu")
    assert pdev.pick_devices(device_type="cpu") == [cpu]
    assert pdev.pick_devices(99, "cpu") == [cpu]  # never over-allocates
    assert pdev.pick_devices(0, "cpu") == []
    with pytest.raises(ValueError, match="unknown device type"):
        pdev.pick_devices(1, "tpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pdev.pick_devices(2)  # no silent fallback to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert pdev.pick_devices() == [torch.device("cuda", i) for i in range(3)]
    assert pdev.pick_devices(2) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert len(pdev.pick_devices(99)) == 3


class _Clock:
    """A virtual clock for the synthetic devices: ``perf_counter`` reads it,
    and ``sleep`` (what ``run_in_turns`` calls while every band's launch is
    in flight) advances it to the end of the next launch in flight, so every
    time the dispatch reads is exact rows x per-row seconds, whatever the
    host's load."""

    def __init__(self):
        self.now = 0.0
        self.ends = []  # end times of the launches issued

    def perf_counter(self):
        return self.now

    def sleep(self, seconds):
        later = [e for e in self.ends if e > self.now]
        self.now = (self.now + seconds) if seconds > 0 else min(later, default=self.now)

    def advance_to(self, t):
        self.now = max(self.now, t)


@pytest.fixture()
def clock(monkeypatch):
    """The virtual clock, read by ``parallel/devices.py`` and
    ``parallel/hetero.py`` in place of ``time``."""
    c = _Clock()
    monkeypatch.setattr(pdev, "time", c)
    monkeypatch.setattr(hetero, "time", c)
    return c


class _Launch:
    """A synthetic launch on a device of its own: done ``seconds`` after it
    was issued on the virtual clock; ``query`` as a CUDA event's."""

    def __init__(self, clock, seconds):
        self.clock = clock
        self.end = clock.now + seconds
        clock.ends.append(self.end)

    def query(self):
        return self.clock.now >= self.end

    def wait(self):  # the driver's blocking host sync
        self.clock.advance_to(self.end)


def _in_flight(clock, seconds, value=None, launches=4):
    """A synthetic band of ``launches`` launches, ``seconds`` in all, then
    ``value``.  Like the port's drivers, each step first blocks until the
    band's previous launch is done, then issues the next and yields it."""
    launch = None
    for _ in range(launches):
        if launch is not None:
            launch.wait()
        launch = _Launch(clock, seconds / launches)
        yield launch
    launch.wait()
    return value


def test_run_in_turns_overlaps_bands_and_raises(clock):
    """Every device's band is in flight at once (four bands of 0.2 s and
    0.05 s in well under their 0.5 s sum), each completion time is its own
    although every step blocks on its band's previous launch (a fast band is
    not held in lockstep with a slow one), and a failing band raises."""
    delays = [0.2, 0.05, 0.2, 0.05]
    t0 = clock.perf_counter()
    out, done = pdev.run_in_turns(CPU4, lambda i: _in_flight(clock, delays[i], i))
    assert out == [0, 1, 2, 3] and clock.perf_counter() - t0 < 0.4
    assert done[1] < done[0] / 2 and done[3] < done[2] / 2

    def work(i):
        yield from _in_flight(clock, 0.01)
        if i == 2:
            raise ValueError("band 2 failed")
        return i

    with pytest.raises(ValueError, match="band 2 failed"):
        pdev.run_in_turns(["cpu"] * 3, work)


def test_launch_counter_exact_under_threads():
    """Eight threads add 5,000 launches each to one counter, with the
    interpreter switching threads as often as it can: no count is lost."""
    def fake_kernel():
        pass

    fake_kernel.launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [launches.count(fake_kernel)
                                                    for _ in range(5000)])
                   for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert fake_kernel.launches == 8 * 5000


# ---- MultiChipRenderer -------------------------------------------------------

@pytest.mark.parametrize("backend, scene_fn, spc", [
    ("grid", lambda: generate_random_scene(0.0), 1),
    ("mega", three_sphere_scene, None),
    ("paged", lambda: random_sphere_field(2000, seed=1, extent=7.0), None),
    ("matmul", three_sphere_scene, None),
])
def test_multichip_equals_single_device(backend, scene_fn, spc):
    """Height 13 over 4 bands (padded to 16, cropped): bit for bit the
    single-device render; ``spc=1`` carries the accumulator between calls."""
    sc = scene_fn()
    cfg = _cfg(width=16, height=13, max_depth=5, backend=backend, samples_per_call=spc)
    r = MultiChipRenderer(cfg, scene=sc, devices=CPU4)
    assert (r.n, r.padded_h, r.band_h, r.backend) == (4, 16, 4, backend)
    multi, total = r.render()
    single, _ = Renderer(cfg, scene=sc, device="cpu").render()
    assert total == SPP and multi.shape == (13, 16, 3)
    assert torch.equal(multi, single)


def test_multichip_shares_one_table_copy_per_device():
    r = MultiChipRenderer(_cfg(), scene=three_sphere_scene(), devices=CPU4)
    assert list(r.device_scenes) == [torch.device("cpu")]


def test_multichip_bruteforce_two_bands_match_golden():
    """Two bands of the spec path against the CPU oracle's 24x14 golden:
    at most 3 of 336 pixels off by more than 1e-4
    (tests/test_golden_fullscene.py's rule)."""
    cfg = RenderConfig(samples=2, width=24, height=14, max_depth=12, backend="bruteforce")
    out, _ = MultiChipRenderer(cfg, devices=["cpu"] * 2).render()
    bad = int((np.abs(out.numpy() - np.load(GOLDEN)).max(axis=2) > 1e-4).sum())
    assert bad <= 3, f"{bad} pixels off"


@pytest.fixture()
def _no_jax_cache():
    """tests/test_multichip.py: serializing multi-device shard_map CPU
    executables for the persistent cache crashes on this jaxlib."""
    prev = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    yield
    jax.config.update("jax_compilation_cache_dir", prev)


def test_reference_banding_against_jax(_no_jax_cache):
    """Reference banding (every band seeded from its own first row): a
    different stream from global seeding, and JAX's own image within the
    chaos budget of its band tests: < 1% of pixels off by more than 0.2."""
    cfg = dict(samples=4, width=32, height=24, max_depth=8, backend="matmul", chips=4)
    port, _ = MultiChipRenderer(RenderConfig(**cfg), scene=three_sphere_scene(),
                                devices=CPU4, reference_banding=True).render()
    ref, _ = JMultiChip(JConfig(**cfg), scene=j_three(), reference_banding=True).render()
    ref = np.asarray(ref)
    bad = (np.abs(port.numpy() - ref).max(axis=2) > 0.2).mean()
    assert bad < 0.01, f"{bad:.3%} pixels differ"
    glob, _ = MultiChipRenderer(RenderConfig(**cfg), scene=three_sphere_scene(),
                                devices=CPU4).render()
    assert not torch.equal(glob, port)


def test_multichip_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiChipRenderer(_cfg())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HeteroRenderer(_cfg())
    # on the CPU, chips=4 picks the one CPU device: one band
    assert MultiChipRenderer(_cfg(), scene=three_sphere_scene(), device="cpu").n == 1


# ---- HeteroRenderer (tests/test_hetero.py) ----------------------------------

def test_hetero_assembles_full_image():
    sc = three_sphere_scene()
    r = HeteroRenderer(_cfg(), scene=sc, devices=CPU4, reference_banding=False)
    accum, frame_s, per_dev = r.render_frame(SPP)
    assert accum.shape == (H, W, 3) and isinstance(accum, np.ndarray)
    assert frame_s > 0 and len(per_dev) == 4 and all(0 < p <= frame_s for p in per_dev)
    single, _ = Renderer(_cfg(chips=1), scene=sc, device="cpu").render(SPP)
    assert np.array_equal(accum, single.numpy())


def test_hetero_reference_banding_differs_but_statistically_matches():
    sc = three_sphere_scene()
    r = HeteroRenderer(_cfg(), scene=sc, devices=CPU4, reference_banding=True)
    accum, _, _ = r.render_frame(SPP)
    single = Renderer(_cfg(chips=1), scene=sc, device="cpu").render(SPP)[0].numpy()
    assert not np.array_equal(accum, single)
    assert abs(accum.mean() - single.mean()) / single.mean() < 0.15


def _patch_synthetic_devices(monkeypatch, clock, renderer, per_row_s):
    """Replace render_band_steps with a zero image in flight for
    rows * per_row_s[device] seconds of the virtual clock (the device found
    by its y0)."""
    def fake(*args, **kw):
        dev = renderer._offsets().index(int(kw["y0"]))
        return _in_flight(clock, int(kw["band_h"]) * per_row_s[dev],
                          torch.zeros((int(kw["band_h"]), renderer.config.width, 3)))

    monkeypatch.setattr(trace, "render_band_steps", fake)


def test_probe_is_per_device_not_serialized(monkeypatch, clock):
    """A fast device listed after a slow one still reports a small busy
    time: each band's time ends with its own band, not with the bands
    before it nor in step with them, though each step blocks on its band's
    previous launch (the reference's per-device probe,
    ray_trace.cpp:609-644)."""
    r = HeteroRenderer(_cfg(chips=2, height=48), scene=three_sphere_scene(),
                       devices=["cpu"] * 2)
    _patch_synthetic_devices(monkeypatch, clock, r, [4e-3, 1e-4])  # device 0 40x slower
    _, _, per_dev = r.render_frame(SPP)
    assert per_dev[1] < per_dev[0] / 2


def test_tuner_converges_on_2x_slow_device(monkeypatch, clock):
    """Per-device probe -> tuner -> re-split moves toward the 2:1 split when
    device 1 is 2x slower per row."""
    r = HeteroRenderer(_cfg(chips=2, height=48), scene=three_sphere_scene(),
                       devices=["cpu"] * 2)
    _patch_synthetic_devices(monkeypatch, clock, r, [1e-3, 2e-3])
    assert r.rows == [24, 24]
    for _ in range(60):
        r.tune_round(SPP, frames=1)
        assert sum(r.rows) == 48 and all(rr >= 1 for rr in r.rows)
    assert r.rows[0] - r.rows[1] >= 8, r.rows  # the optimum is 32:16


@pytest.mark.parametrize("backend, scene_fn", [
    ("grid", lambda: generate_random_scene(0.0)),
    ("paged", lambda: random_sphere_field(2000, seed=1, extent=7.0)),
])
def test_hetero_production_backends(backend, scene_fn):
    """The kernel backends' bands, then a forced uneven re-split: each
    frame bit for bit the single-device render."""
    sc = scene_fn()
    cfg = _cfg(width=24, height=12, backend=backend, chips=2, max_depth=4,
               pixels_per_lane=2)
    r = HeteroRenderer(cfg, scene=sc, devices=["cpu"] * 2, reference_banding=False)
    assert r.backend == backend
    accum, _, per_dev = r.render_frame(1)
    single = Renderer(cfg, scene=sc, device="cpu").render(1)[0].numpy()
    assert accum.shape == (12, 24, 3) and len(per_dev) == 2
    assert np.array_equal(accum, single)
    r.rows = [9, 3]
    assert np.array_equal(r.render_frame(1)[0], single)


def test_tune_round_updates_rows():
    r = HeteroRenderer(_cfg(), scene=three_sphere_scene(), devices=CPU4)
    assert sum(r.rows) == H
    for _ in range(4):
        accum, dpf, new = r.tune_round(SPP, frames=1)
        assert sum(r.rows) == H and dpf > 0 and accum.shape == (H, W, 3)
        assert new is None or list(new) == r.rows
    assert all(rr >= 0 for rr in r.rows)
