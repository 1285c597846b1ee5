"""Port: the C ABI (raytrace_tpu_torch/native/, built by
``_build.abi_library``) and the entry file ``__graft_entry_torch__.py``, on
the CPU.

The cases of tests/test_abi.py: ``ray_trace(2, True, 32, 18, 1)`` through
ctypes writes ``render.png``, here the very PNG the in-process
``ray_trace(..., device="cpu")`` writes; the demo executable warns on
``--bogus``, exits 0 and writes the PNG.  The C signature has no device, so
the CPU is asked for through ``RAYTRACE_TORCH_DEVICE``; without it and
without a card the port's RuntimeError is printed and nothing is written.
The entry file's band step and its multi-device dry run run on the CPU, the
dry run's grid bands bit for bit the single-device render.
"""

import ctypes
import os
import shutil
import subprocess
import sysconfig
from pathlib import Path

import numpy as np
import pytest
import torch

import __graft_entry_torch__ as graft
import raytrace_tpu_torch
from raytrace_tpu_torch import RenderConfig, _build
from raytrace_tpu_torch.models.scene import generate_random_scene
from raytrace_tpu_torch.runtime.renderer import Renderer

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def abi():
    if shutil.which("g++") is None or shutil.which("cc") is None:
        pytest.skip("g++ or cc is missing: the C ABI cannot be built")
    if not (Path(sysconfig.get_paths()["include"]) / "Python.h").exists():
        pytest.skip("Python's headers are missing: the C ABI cannot be built")
    return _build.abi_library()


def _load(path):
    lib = ctypes.CDLL(str(path))
    lib.ray_trace.argtypes = [ctypes.c_uint32, ctypes.c_bool, ctypes.c_uint32,
                              ctypes.c_uint32, ctypes.c_uint32]
    lib.ray_trace.restype = None
    return lib


def test_abi_builds_into_build(abi):
    assert abi["lib"].parent == abi["demo"].parent
    assert abi["lib"].parent.parent == _build.REPO / "build" / "abi"
    assert _build.abi_library() == abi  # cached: no second build


def test_ctypes_ray_trace_writes_the_in_process_png(abi, tmp_path, monkeypatch, capfd):
    monkeypatch.chdir(tmp_path)  # ray_trace writes render.png to the cwd
    monkeypatch.setenv("RAYTRACE_TORCH_DEVICE", "cpu")
    _load(abi["lib"]).ray_trace(2, True, 32, 18, 1)
    assert "duration_per_frame" in capfd.readouterr().out
    raytrace_tpu_torch.ray_trace(2, True, 32, 18, 1, out_path=str(tmp_path / "ref.png"),
                                 device="cpu")
    assert (tmp_path / "render.png").read_bytes() == (tmp_path / "ref.png").read_bytes()


def test_ctypes_without_a_card_prints_the_error(abi, tmp_path, monkeypatch, capfd):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default renders there")
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("RAYTRACE_TORCH_DEVICE", raising=False)
    _load(abi["lib"]).ray_trace(2, True, 32, 18, 1)
    err = capfd.readouterr().err
    assert "RuntimeError: no CUDA device" in err
    assert not (tmp_path / "render.png").exists()


def test_native_demo_exe(abi, tmp_path):
    """exe -> libraytrace_torch.so -> embedded CPython -> the port."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), RAYTRACE_TORCH_DEVICE="cpu")
    res = subprocess.run(
        [str(abi["demo"]), "--samples", "2", "--width", "32", "--height", "18",
         "--store", "--bogus"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "duration_per_frame" in res.stdout
    assert "unknown argument: --bogus" in res.stderr  # main.cpp:49 behaviour
    assert (tmp_path / "render.png").exists()


def test_entry_and_dryrun_on_the_cpu():
    fn, args = graft.entry("cpu")
    out = fn(*args)
    assert out.shape == (32, 64, 3) and out.device.type == "cpu"
    assert bool(torch.isfinite(out).all()) and float(out.sum()) > 0
    assert torch.equal(fn(*args), out)

    res = graft.dryrun_multichip(2, "cpu")
    assert {k: v.shape for k, v in res.items()} == {
        "grid": (8, 32, 3), "paged": (8, 32, 3), "hetero": (12, 32, 3)}
    cfg = RenderConfig(samples=2, width=32, height=8, max_depth=6, backend="grid",
                       pixels_per_lane=2)
    single, _ = Renderer(cfg, scene=generate_random_scene(0.0), device="cpu").render(2)
    assert np.array_equal(res["grid"], single.numpy())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            graft.entry()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            graft.dryrun_multichip(2)
