"""Port parity: the lane-gather probe of ``scripts/bench_gather.py``.

``raytrace_tpu_torch/scripts/bench_gather.py`` holds the wrappers of the
probe's two kernels (``run``, ``run_base``) and their plain torch versions:
the CPU runs the plain versions, and the CUDA kernels
(``csrc/bench_gather.cu``) are held against them on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 8).  Here the plain versions
are held against the JAX script's own kernel bodies (``_kernel``,
``_kernel_base``) run through ``pl.pallas_call(..., interpret=True)`` with
the script's VMEM specs, at its [16, 1024], on its seeded inputs and on
indices that are negative or wrap int32.

Tolerance: bit-equal, NaN positions equal.  Both sides add the same f32
values in the same order (acc + g from 0; an out-of-range row of axis 0 is
NaN on both), and the baseline's multiply and add are two roundings on both.
"""

import functools
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from raytrace_tpu_torch.scripts import bench_gather as bg

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "scripts_bench_gather", os.path.join(ROOT, "scripts", "bench_gather.py"))
jbg = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jbg)


def _jax(tab, idx, *, iters, axis=None):
    """The JAX script's kernel body (``axis=None``: the baseline's) in
    Pallas interpret mode, with the script's specs."""
    body = (functools.partial(jbg._kernel, iters=iters, axis=axis) if axis is not None
            else functools.partial(jbg._kernel_base, iters=iters))
    out = pl.pallas_call(
        body, out_shape=jax.ShapeDtypeStruct((jbg.R, jbg.T), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True)(tab, idx)
    return np.asarray(out)


def _index(mode):
    """The script's inputs ("rand", "lane"), or "wide": int32 indices over
    the whole range, with some at the top so that ``idx + i`` wraps."""
    tab, idx = bg.inputs()
    if mode != "wide":
        return tab, idx[mode]
    rng = np.random.default_rng(5)
    wide = rng.integers(-2**31, 2**31, size=(bg.R, bg.T), dtype=np.int64).astype(np.int32)
    wide[:, ::7] = np.iinfo(np.int32).max - rng.integers(0, 5, size=(bg.R, 147))
    return tab, wide


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and bool(np.all((a == b) | (np.isnan(a) & np.isnan(b))))


def test_constants_are_the_scripts():
    assert (bg.R, bg.T, bg.ITERS) == (jbg.R, jbg.T, jbg.ITERS)


@pytest.mark.parametrize("iters", [1, 7])
@pytest.mark.parametrize("mode", ["rand", "lane", "wide"])
@pytest.mark.parametrize("axis", [1, 0])
def test_gather_matches_jax(axis, mode, iters):
    tab, idx = _index(mode)
    want = _jax(tab, idx, iters=iters, axis=axis)
    got = bg.run(torch.from_numpy(tab), torch.from_numpy(idx), iters=iters, axis=axis)
    assert _same(got.numpy(), want)
    nan = np.isnan(want).mean()
    # axis 1 stays in range; axis 0 reaches rows >= 16 for most indices
    assert nan == 0.0 if axis == 1 else nan > 0.9


@pytest.mark.parametrize("iters", [1, 7])
def test_base_matches_jax(iters):
    tab, idx = _index("rand")
    want = _jax(tab, idx, iters=iters)
    got = bg.run_base(torch.from_numpy(tab), torch.from_numpy(idx), iters=iters)
    assert _same(got.numpy(), want)


def test_cpu_runs_the_plain_versions_and_counts_them():
    tab, idx = (torch.from_numpy(a) for a in _index("rand"))
    for fn in (bg.run, bg.run_base, bg.run_plain, bg.run_base_plain):
        fn.launches = 0
    out = bg.run(tab, idx, iters=2, axis=1, blocks=3, per_block=True)
    base = bg.run_base(tab, idx, iters=2)
    assert out.shape == (3, bg.R, bg.T) and base.shape == (bg.R, bg.T)
    assert torch.equal(out[2], bg.run_plain(tab, idx, iters=2, axis=1))
    assert (bg.run.launches, bg.run_base.launches) == (0, 0)
    assert (bg.run_plain.launches, bg.run_base_plain.launches) == (2, 1)


def test_wrappers_reject_what_the_kernels_do_not_take():
    tab, idx = (torch.from_numpy(a) for a in _index("rand"))
    with pytest.raises(TypeError):
        bg.run(tab.double(), idx, iters=1, axis=1)
    with pytest.raises(ValueError):
        bg.run(tab[:8], idx[:8], iters=1, axis=1)
    with pytest.raises(ValueError):
        bg.run(tab, idx, iters=1, axis=2)
    with pytest.raises(ValueError):
        bg.run_base(tab, idx, iters=-1)


def test_main_on_cpu_prints_each_case(capsys):
    res = bg.main(["--device", "cpu", "--iters", "4"])
    lines = capsys.readouterr().out.splitlines()
    cases = [ln for ln in lines if ln.startswith("axis=")]
    assert [ln.split(":")[0] for ln in cases] == [
        f"axis={a} idx={m}" for a in (1, 0) for m in bg.INDEX_MODES]
    assert all("correct=True" in ln and "host clock" in ln for ln in cases)
    assert sum(ln.startswith("baseline add loop:") for ln in lines) == 1
    assert all(g["correct"] for g in res["gather"].values())
    assert res["blocks"] == [1] and res["base_ms"][1] > 0


def test_main_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bg.main([])


def test_import_leaves_jax_out():
    code = ("import sys, chip_smoke, raytrace_tpu_torch.scripts.bench_gather; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'raytrace_tpu' or m.startswith('raytrace_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
