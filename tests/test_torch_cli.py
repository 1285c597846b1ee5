"""Port: the command line (utils/cli.py, ``python -m raytrace_tpu_torch``).

``parse_args`` gives the JAX CLI's dicts over a list of command lines, with
its ``unknown argument`` line and its errors; ``main(argv, device="cpu")``
writes the PNG ``ray_trace(device="cpu")`` writes, runs ``--checkpoint``
through ``render_resumable``, ``--gpus`` through the row bands (the one CPU
device: one band, the same PNG), ``--frames`` through the frame loop and
``--serve`` through the production loop and ``--autotune`` at the cached
point, and exits 1 with one stderr line for ``--full`` (the block sweep)
on the CPU.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import raytrace_tpu_torch
from raytrace_tpu.utils import cli as jcli
from raytrace_tpu_torch.utils import cli

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARGVS = [
    [],
    ["--store"],
    ["--samples", "16", "--width", "1920", "--height", "1080", "--store", "--out", "r.png"],
    ["--gpus", "2", "--backend", "grid", "--depth", "8", "--time", "0.5"],
    ["--samples-per-call", "4", "--accum", "float64", "--mode", "fast", "--preview"],
    ["--frames", "0", "--checkpoint", "ck.npz", "--balance", "32"],
    ["--autotune", "--full", "--serve", "0"],
    ["--bogus", "--samples", "3", "extra"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=[" ".join(a) or "none" for a in ARGVS])
def test_parse_args_equals_jax(argv, capsys):
    assert cli.parse_args(argv) == jcli.parse_args(argv)
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 2 * argv.count("--bogus") + 2 * argv.count("extra")
    assert all(line.startswith("unknown argument: ") for line in err)


@pytest.mark.parametrize("argv", [["--samples"], ["--width", "wide"], ["--backend", "optix"],
                                  ["--mode", "slow"], ["--time", "x"]])
def test_bad_values_raise_like_jax(argv):
    with pytest.raises(jcli.CLIError) as ref:
        jcli.parse_args(argv)
    with pytest.raises(cli.CLIError) as got:
        cli.parse_args(argv)
    assert str(got.value) == str(ref.value)
    assert cli.main(argv, device="cpu") == 1


def test_help_prints_and_exits_0(capsys):
    assert cli.main(["--help"], device="cpu") == 0
    out = capsys.readouterr().out
    assert out == cli.HELP and "--samples <count>" in out


def test_main_writes_the_png_ray_trace_writes(tmp_path, capsys):
    argv = ["--samples", "2", "--width", "24", "--height", "14", "--depth", "6", "--store",
            "--mode", "fast", "--samples-per-call", "1", "--balance", "2"]
    a, b = tmp_path / "cli.png", tmp_path / "api.png"
    assert cli.main(argv + ["--out", str(a)], device="cpu") == 0
    assert "duration_per_frame:" in capsys.readouterr().out
    raytrace_tpu_torch.ray_trace(samples=2, width=24, height=14, max_depth=6,
                                 store_render_result=True, out_path=str(b),
                                 samples_per_call=1, mode="fast", device="cpu")
    assert a.read_bytes() == b.read_bytes()


def test_checkpoint_runs_render_resumable(tmp_path):
    """``--checkpoint`` renders through ``render_resumable`` (one call per
    sample here) and writes the image of the whole render; a finished
    render leaves the checkpoint of its last call but one."""
    ck, out, ref = tmp_path / "ck.npz", tmp_path / "ck.png", tmp_path / "ref.png"
    base = ["--samples", "3", "--width", "16", "--height", "9", "--depth", "4", "--store",
            "--samples-per-call", "1"]
    assert cli.main(base + ["--checkpoint", str(ck), "--out", str(out)], device="cpu") == 0
    assert cli.main(base + ["--out", str(ref)], device="cpu") == 0
    assert out.read_bytes() == ref.read_bytes()
    z = np.load(ck)
    assert int(z["samples_done"]) == 2 and int(z["number"]) == 2


SMALL = ["--samples", "1", "--width", "16", "--height", "9", "--depth", "4"]


def test_gpus_writes_the_png_of_one_gpu(tmp_path):
    """``--gpus 2`` renders row bands over the devices there are; on the CPU
    that is one band, and the PNG is ``--gpus 1``'s byte for byte."""
    one, two = tmp_path / "one.png", tmp_path / "two.png"
    assert cli.main(SMALL + ["--store", "--out", str(one)], device="cpu") == 0
    assert cli.main(SMALL + ["--store", "--gpus", "2", "--out", str(two)], device="cpu") == 0
    assert one.read_bytes() == two.read_bytes()


def test_frames_store_writes_numbered_pngs(tmp_path, capsys):
    out = tmp_path / "f.png"
    assert cli.main(SMALL + ["--frames", "2", "--store", "--out", str(out)], device="cpu") == 0
    assert (tmp_path / "f_0.png").exists() and (tmp_path / "f_1.png").exists()
    assert "duration_per_frame:" in capsys.readouterr().out


@pytest.mark.parametrize("extra", [["--frames", "1"], ["--gpus", "2", "--frames", "1"]])
def test_serve_runs_the_production_loop(extra, capsys):
    """``--serve`` with ``--frames`` (or ``--gpus`` above 1) runs the
    production loop behind the HTTP server for that many frames, then
    returns 0."""
    assert cli.main(SMALL + ["--serve", "0"] + extra, device="cpu") == 0
    assert "live viewer: http://127.0.0.1:" in capsys.readouterr().out


@pytest.mark.parametrize("argv, rc", [(["--autotune"], 0), (["--autotune", "--full"], 1)])
def test_flags_of_later_modules_exit_1(argv, rc, tmp_path, monkeypatch, capsys):
    """The flags of the autotuner, once a later module's: ``--autotune``
    with a pre-seeded cache renders at the tuned point, and ``--full`` (the
    block sweep) exits 1 on the CPU with the reason, before any sweep."""
    from raytrace_tpu_torch.ops import gridkernel as gk
    from raytrace_tpu_torch.runtime import autotune as at

    cache = tmp_path / "tune.json"
    cache.write_text('{"cpu": {"m": 1, "j": 3, "k": 5, "device_kind": "cpu"}}')
    monkeypatch.setattr(at, "CACHE_PATH", cache)
    monkeypatch.setattr(gk, "J_STEPS", gk.J_STEPS)  # restored after the test
    monkeypatch.setattr(gk, "K_STEPS", gk.K_STEPS)
    assert cli.main(argv + ["--width", "8", "--height", "4", "--depth", "4"],
                    device="cpu") == rc
    out = capsys.readouterr()
    if rc == 0:
        assert (gk.J_STEPS, gk.K_STEPS) == (3, 5) and "duration_per_frame" in out.out
    else:
        err = out.err.strip().splitlines()
        assert len(err) == 1 and "CUDA device" in err[0] and "ROADMAP" not in err[0]
        assert "duration_per_frame" not in out.out


def test_module_entry_point_runs():
    """``python -m raytrace_tpu_torch --help`` in a fresh process."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-m", "raytrace_tpu_torch", "--help", "--nope"],
                         capture_output=True, text=True, env=env, timeout=120)
    assert res.returncode == 0 and res.stdout == cli.HELP
    assert "unknown argument" not in res.stderr  # --help returns first
