"""Port: the animated frame loop, the live viewer and the production loop
(runtime/frames.py, viewer.py, production.py), on the CPU.

The cases of tests/test_compare_frames.py (frame loop), tests/test_viewer.py
and tests/test_production.py, the production loop's bands on
``["cpu"] * 4``; a frame of the loop at time t is bit for bit the render of
``generate_random_scene(t)``; and the ``/state`` the port serves has the
JAX package's keys and first values (its ``LiveViewer`` and
``ProductionLoop`` constructed, not started).
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from raytrace_tpu.config import RenderConfig as JConfig
from raytrace_tpu.runtime.production import ProductionLoop as JProductionLoop
from raytrace_tpu.runtime.viewer import LiveViewer as JLiveViewer
from raytrace_tpu_torch import RenderConfig, generate_random_scene
from raytrace_tpu_torch.runtime.frames import FrameLoop
from raytrace_tpu_torch.runtime.production import ProductionLoop
from raytrace_tpu_torch.runtime.renderer import Renderer
from raytrace_tpu_torch.runtime.viewer import LiveViewer

torch.set_num_threads(1)

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


# ---- frame loop (tests/test_compare_frames.py) -------------------------------

def test_frame_loop_animates():
    cfg = RenderConfig(samples=1, width=32, height=18, max_depth=4, backend="matmul")
    fl = FrameLoop(cfg, time_fn=lambda: 1.0, device="cpu")
    f0 = fl.render_frame(0.0)
    f1 = fl.render_frame(1.3)
    assert f0.shape == (18, 32, 3)
    assert not torch.equal(f0, f1)  # the hero spheres moved


def test_frame_loop_run_prints_dpf(capsys, tmp_path):
    cfg = RenderConfig(samples=1, width=16, height=9, max_depth=4, backend="matmul")
    fl = FrameLoop(cfg, device="cpu")
    dpf, frames = fl.run(frames=2, store_pattern=str(tmp_path / "f{0}.png"), animate=False)
    assert dpf > 0 and frames == 2
    assert (tmp_path / "f0.png").exists() and (tmp_path / "f1.png").exists()
    assert "duration_per_frame" in capsys.readouterr().out


def test_frame_at_t_equals_render_of_scene_at_t():
    """The loop's frame at t (book scene, grid backend) is the render of
    ``generate_random_scene(t)`` bit for bit, and the wall clock drives t
    when none is given."""
    cfg = RenderConfig(samples=1, width=16, height=9, max_depth=5)
    fl = FrameLoop(cfg, time_fn=lambda: 2.5, device="cpu")
    for t in (1.3, None):
        want = Renderer(cfg, scene=generate_random_scene(2.5 if t is None else t),
                        device="cpu").render_call(1)
        assert torch.equal(fl.render_frame(t), want)
    assert fl.renderer.backend == "grid"


def test_frame_loop_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    cfg = RenderConfig(samples=1, width=8, height=4, max_depth=2)
    for make in (lambda: FrameLoop(cfg), lambda: LiveViewer(cfg, port=0),
                 lambda: ProductionLoop(cfg, port=0)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


# ---- live viewer (tests/test_viewer.py) --------------------------------------

def _get(v, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{v.port}{path}", timeout=30) as r:
        return r.status, r.read()


@pytest.fixture()
def viewer():
    cfg = RenderConfig(samples=4, width=32, height=18, max_depth=5, backend="matmul",
                       samples_per_call=2, pixels_per_lane=1)
    v = LiveViewer(cfg, port=0, device="cpu")  # ephemeral port
    v.start_server()
    yield v
    v.stop()


def test_viewer_serves_progressive_frames(viewer):
    t = threading.Thread(target=viewer.render_loop, kwargs={"max_frames": 1}, daemon=True)
    t.start()
    t.join(timeout=300)
    assert not t.is_alive()
    code, body = _get(viewer, "/frame.png")
    assert code == 200 and body[:8] == PNG_SIGNATURE
    state = json.loads(_get(viewer, "/state")[1])
    assert state["samples_done"] == 4
    code, html = _get(viewer, "/")
    assert code == 200 and b"raytrace_tpu" in html


def test_camera_input_changes_view(viewer):
    """Steering the camera restarts the accumulation and renders another
    image."""
    t = threading.Thread(target=viewer.render_loop, kwargs={"max_frames": 2}, daemon=True)
    t.start()
    for _ in range(600):  # wait for frame 0 to converge
        state = json.loads(_get(viewer, "/state")[1])
        if state["samples_done"] == 4 and state["frame"] == 0:
            break
        time.sleep(0.1)
    _, png0 = _get(viewer, "/frame.png")
    req = urllib.request.Request(f"http://127.0.0.1:{viewer.port}/camera",
                                 data=json.dumps({"orbit": [0.8, 0.0]}).encode(),
                                 method="POST")
    assert urllib.request.urlopen(req, timeout=30).status == 200
    t.join(timeout=300)
    assert not t.is_alive()
    _, png1 = _get(viewer, "/frame.png")
    assert png1 != png0
    assert json.loads(_get(viewer, "/state")[1])["camera_pos"] != [13.0, 11.0, -3.0]


# ---- production loop (tests/test_production.py) ------------------------------

W, H, SPP = 32, 24, 2
CFG = dict(samples=SPP, width=W, height=H, max_depth=6, backend="matmul", chips=4,
           pixels_per_lane=1)


class _FakeClock:
    """+2 s per frame, so the animated hero sphere moves between frames."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 2.0
        return self.t


def _capture(loop, frames):
    orig = loop._publish

    def capture(accum, done):
        frames.append(np.array(accum, copy=True))
        orig(accum, done)

    loop._publish = capture


def test_production_loop_animates_on_cpu_bands():
    """Every frame generates the scene anew, renders one band per device,
    feeds the tuner and publishes, in one process."""
    loop = ProductionLoop(RenderConfig(**CFG), port=0, time_fn=_FakeClock(),
                          devices=["cpu"] * 4, device="cpu")
    loop.start_server()
    try:
        frames = []
        _capture(loop, frames)
        t = threading.Thread(target=loop.render_loop, kwargs={"max_frames": 3}, daemon=True)
        t.start()
        t.join(timeout=600)
        assert not t.is_alive()
        assert len(frames) == 3
        assert not np.array_equal(frames[0], frames[1])
        assert not np.array_equal(frames[1], frames[2])
        hr = loop.renderer
        assert len(hr.rows) == 4 and sum(hr.rows) == H
        code, body = _get(loop, "/frame.png")
        assert code == 200 and body[:8] == PNG_SIGNATURE
        state = json.loads(_get(loop, "/state")[1])
        assert state["duration_per_frame"] > 0
        assert sum(state["rows"]) == H and len(state["rows"]) == 4
        assert state["frame"] == 2 and state["resplits"] >= 0
    finally:
        loop.stop()


def test_production_loop_camera_steers_static_scene():
    """animate=False: a static scene renders the same frame until the
    camera input steers the view at a frame boundary."""
    loop = ProductionLoop(RenderConfig(**CFG), port=0, animate=False,
                          devices=["cpu"] * 4, device="cpu")
    loop.start_server()
    try:
        frames = []
        _capture(loop, frames)
        done2 = threading.Event()

        def run():
            loop.render_loop(max_frames=2)
            done2.set()
            loop.render_loop(max_frames=1)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        assert done2.wait(timeout=600)
        loop.orbit(0.8, 0.0)
        t.join(timeout=600)
        assert not t.is_alive()
        assert len(frames) == 3
        assert np.array_equal(frames[0], frames[1])
        assert not np.array_equal(frames[1], frames[2])
        assert json.loads(_get(loop, "/state")[1])["camera_pos"] != [13.0, 11.0, -3.0]
    finally:
        loop.stop()


def test_state_equals_jax():
    """The ``/state`` of a viewer and of a production loop, before any
    frame: the JAX package's keys and values."""
    port_v = LiveViewer(RenderConfig(**CFG), port=0, device="cpu")
    jax_v = JLiveViewer(JConfig(**CFG), port=0)
    assert port_v._state == jax_v._state
    port_p = ProductionLoop(RenderConfig(**CFG), port=0, devices=["cpu"] * 4, device="cpu")
    jax_p = JProductionLoop(JConfig(**CFG), port=0)
    assert port_p._state == jax_p._state
    assert set(jax_p._state) - set(jax_v._state) == {"duration_per_frame", "rows", "resplits"}
