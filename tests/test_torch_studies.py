"""Port: the oracle studies (``straggler_stats``, ``path_stats``,
``rr_study``, ``rr_efficiency`` under ``raytrace_tpu_torch/scripts``).

They run the port's numpy oracle on the host and print the numbers the JAX
scripts under ``scripts/`` print for the same arguments: each JAX script
runs here in a subprocess on the CPU, and its stdout equals the port's
line for line, but for the port's last line, which names where the numbers
came from.  The hook on the oracle's ``_closest_hit`` is removed after a
run.
"""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from raytrace_tpu_torch.oracle import cpu_reference as orc
from raytrace_tpu_torch.scripts import (oracle_paths, path_stats, rr_efficiency, rr_study,
                                        straggler_stats)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUDIES = {"straggler_stats": (straggler_stats, ["8", "1"]),
           "path_stats": (path_stats, ["8", "1"]),
           "rr_study": (rr_study, ["4", "2"]),
           "rr_efficiency": (rr_efficiency, ["4", "2"])}


def _port(mod, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = mod.main(argv + ["--device", "cpu"])
    return out, buf.getvalue().splitlines()


@pytest.mark.parametrize("name", sorted(STUDIES))
def test_prints_the_jax_scripts_numbers(name):
    mod, argv = STUDIES[name]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", f"{name}.py"), *argv],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr
    _, lines = _port(mod, argv)
    assert lines[-1] == "(numpy oracle on the host CPU; device cpu: the plain torch " \
                        "versions, host clock)"
    assert lines[:-1] == res.stdout.splitlines()
    assert len(lines) > 2


@pytest.mark.parametrize("name", ["straggler_stats", "path_stats"])
def test_hook_is_removed(name):
    mod, _ = STUDIES[name]
    before = orc._closest_hit
    _port(mod, ["2", "1"])
    assert orc._closest_hit is before


def test_path_stats_counts():
    stats, _ = _port(path_stats, ["6", "2"])
    assert stats["samples"] == 12
    assert stats["segments"] >= stats["samples"] and stats["cells"] >= 0


def test_exact_policies_agree():
    """rr_study's baseline and rr_efficiency's exact policy replay the same
    paths on the same pixels: the same mean cost."""
    study, _ = _port(rr_study, ["3", "2"])
    eff, _ = _port(rr_efficiency, ["3", "2"])
    assert eff["exact"][0] == study["baseline"][0].mean()


def test_march_rule():
    """A ray that misses the grid box marches no cell; one straight down
    onto the ground inside it marches one."""
    march = oracle_paths.BookMarch()
    up = np.array([0.0, 1.0, 0.0])
    assert march.cells(np.array([0.0, 50.0, 0.0]), up, oracle_paths.BIG) == 0
    x, z = 3.3, 2.2  # no hero sphere there
    o, d = np.array([x, 50.0, z]), np.array([0.0, -1.0, 0.0])
    assert march.glob_t(o, d) > 40 and march.segment_cells(o, d) == 1
