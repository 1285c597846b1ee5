"""Port: the runtime ops (runtime/profiling.py, runtime/chips.py and the
renderer's lane target), on the CPU, held against the JAX package.

``FrameStats`` is the JAX class copied: the same report and adaptive window
on the same durations (tests/test_runtime.py).  ``device_trace`` wraps
``torch.profiler``: on the CPU it writes a Chrome/TensorBoard trace, and its
CUDA default raises without a card, as the renderer does.  ``profile_for``
matches device kinds by substring and falls back to the measured H100 row;
the renderer reads its grid lanes per thread, so a 132-SM H100 still gives
M = 2 at 1920x1080.
"""

import glob
import json
import types

import pytest
import torch

from raytrace_tpu.runtime.profiling import FrameStats as JFrameStats
from raytrace_tpu_torch import RenderConfig, ray_trace
from raytrace_tpu_torch.runtime import chips, profiling
from raytrace_tpu_torch.runtime import renderer as rmod

torch.set_num_threads(1)


@pytest.mark.parametrize("durations", [[], [0.1], [0.25, 0.05, 0.4, 0.125], [0.0]])
def test_frame_stats_equals_jax(durations, tmp_path):
    port, ref = profiling.FrameStats(), JFrameStats()
    port.durations[:] = durations
    ref.durations[:] = durations
    assert port.report() == ref.report()
    assert port.duration_per_frame == ref.duration_per_frame
    for min_s in (4.0, 0.5):
        assert port.adaptive_frame_count(min_s) == ref.adaptive_frame_count(min_s)
    assert port.dump() == ref.dump()
    path = tmp_path / "stats.json"
    port.dump(str(path))
    assert json.loads(path.read_text()) == ref.report()
    with port.frame():
        pass
    assert len(port.durations) == len(durations) + 1 and port.durations[-1] >= 0


def test_device_trace_cpu_writes_a_trace(tmp_path, capsys):
    log_dir = tmp_path / "trace"
    with profiling.device_trace(str(log_dir), device="cpu") as prof:
        ray_trace(samples=1, width=24, height=14, max_depth=4, device="cpu")
    assert "duration_per_frame" in capsys.readouterr().out
    files = glob.glob(str(log_dir / "*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(open(files[0]).read())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert not any(e.get("cat") == "kernel" for e in events)  # CPU activity only
    assert prof.key_averages()


def test_device_trace_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default traces it")
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            with profiling.device_trace(str(tmp_path / "t"), **kw):
                pass
    assert not (tmp_path / "t").exists()


@pytest.mark.parametrize("kind", ["NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe",
                                  "nvidia h100 nvl"])
def test_profile_for_h100(kind):
    p = chips.profile_for(kind)
    assert p is chips.PROFILES[0] and p.kind_substr in kind.lower()
    assert (p.lanes_per_thread, p.samples_per_call, p.calls_per_exec,
            p.block, p.k_steps, p.j_steps) == (4, 2500, 4, 128, 40, 2)
    assert "H100" in p.note and "700" in p.note


def test_profile_for_unknown_and_no_card():
    assert chips.profile_for("NVIDIA A100-SXM4-40GB") is chips.DEFAULT
    assert chips.profile_for("") is chips.DEFAULT
    if not torch.cuda.is_available():
        assert chips.profile_for() is chips.DEFAULT  # a table lookup: no render
    assert len(chips.PROFILES) == 1 and chips.DEFAULT is chips.PROFILES[0]


def test_band_layout_on_an_h100_keeps_m_2(monkeypatch):
    """The renderer's lane target now comes from the profile: 132 SMs x 2048
    thread slots x 4 lanes for the grid backend, 1 lane per slot for the
    others; M = 2 for the 2,073,600 pixels of 1080p, as before."""
    props = types.SimpleNamespace(name="NVIDIA H100 80GB HBM3", multi_processor_count=132,
                                  max_threads_per_multi_processor=2048)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: props)
    dev = torch.device("cuda", 0)
    assert rmod.lanes_target(dev, "grid") == 1_081_344
    assert rmod.lanes_target(dev, "mega") == 270_336
    cfg = RenderConfig(width=1920, height=1080)
    assert rmod.band_layout(cfg, dev, "grid", 1080)[0] == 2
    assert rmod.band_layout(cfg, dev, "mega", 1080)[0] == 8
    assert rmod.lanes_target(torch.device("cpu"), "grid") == rmod.CPU_LANES_TARGET
