"""Port: the kernel autotuner (runtime/autotune.py) and the grid kernel's
block resolution (_build.py), on the CPU, held against the JAX package.

The cases of tests/test_autotune.py run in-process with ``device="cpu"``
(the grid kernel's plain version) at 48x27 x 1 spp, depth 4: the sweep and
its cache, the fast-mode keys and the exact-row fallback, ``apply_tuned``,
``default_candidates`` (equal to JAX's) and ``--autotune`` with a
pre-seeded cache.  The image is the same bits for any (M, J, K).  The
block sweep needs a card and refuses the CPU; which block a build takes
(env over the cache over 128) and its library's hash are checked without
compiling.
"""

import json

import pytest
import torch

from raytrace_tpu.runtime import autotune as jat
from raytrace_tpu_torch import _build
from raytrace_tpu_torch.ops import gridkernel as gk
from raytrace_tpu_torch.runtime import autotune as at
from raytrace_tpu_torch.utils import cli

torch.set_num_threads(1)

SMALL = dict(width=48, height=27, spp=1, rounds=1, max_depth=4, save=False, verbose=False,
             device="cpu")


def test_autotune_sweep_and_cache(tmp_path):
    cache = tmp_path / "tune.json"
    res = at.autotune(candidates=[(2, 1, 4), (2, 2, 4)], **SMALL)
    assert res["m"] == 2 and res["j"] in (1, 2) and res["k"] == 4
    assert set(res["candidates"]) == {"2x1x4", "2x2x4"}
    assert res["ns_per_sample"] > 0 and res["device_kind"] == "cpu"
    assert (res["mode"], res["width"], res["height"], res["spp"]) == ("exact", 48, 27, 1)
    assert (gk.J_STEPS, gk.K_STEPS) == (2, 40)  # restored after every candidate
    at.save_tuned(res, path=cache)
    data = json.loads(cache.read_text())
    assert res["device_kind"] in data

    # load round-trips by device kind; unknown kinds miss
    got = at.load_tuned(res["device_kind"], path=cache)
    assert got["m"] == res["m"]
    assert at.load_tuned("no-such-card", path=cache) is None


def test_autotune_fast_mode_cache(tmp_path):
    """mode="fast" sweeps under RR and caches per (device kind, mode);
    load_tuned(mode="fast") prefers the fast row and falls back to the
    exact row when only that exists."""
    cache = tmp_path / "tune.json"
    res = at.autotune(candidates=[(2, 1, 4), (2, 2, 4)], mode="fast", **SMALL)
    assert res["mode"] == "fast"
    at.save_tuned(res, path=cache)
    data = json.loads(cache.read_text())
    assert f"{res['device_kind']}|fast" in data
    assert res["device_kind"] not in data  # exact key untouched

    got = at.load_tuned(res["device_kind"], path=cache, mode="fast")
    assert got["mode"] == "fast" and got["m"] == res["m"]
    assert at.load_tuned(res["device_kind"], path=cache) is None

    exact = dict(res, mode="exact")
    cache2 = tmp_path / "tune2.json"
    at.save_tuned(exact, path=cache2)
    fb = at.load_tuned(res["device_kind"], path=cache2, mode="fast")
    assert fb is not None and fb["mode"] == "exact"


def test_apply_tuned_sets_kernel_globals():
    j0, k0 = gk.J_STEPS, gk.K_STEPS
    try:
        out = at.apply_tuned({"m": 2, "j": 1, "k": 7})
        assert out["m"] == 2
        assert gk.J_STEPS == 1 and gk.K_STEPS == 7
    finally:
        gk.J_STEPS, gk.K_STEPS = j0, k0
    if not torch.cuda.is_available():
        assert at.apply_tuned() is None  # no card: no tune to look up


@pytest.mark.parametrize("seed", [(64, 2, 40), (2, 2, 40), (1, 1, 5), (128, 3, 8)])
def test_default_candidates_equal_jax(seed):
    cands = at.default_candidates(*seed)
    assert cands == jat.default_candidates(*seed)
    assert cands[0] == seed and len(cands) == len(set(cands))


def test_candidates_render_the_same_bits(monkeypatch):
    """Every (M, J, K) renders the same accumulator, bit for bit, and the
    sweep raises when two candidates' hashes differ."""
    band = at._BookBand(48, 27, 2, "fast", 6, torch.device("cpu"))
    ref = band.run(2, 2, 40)
    for c in [(1, 1, 5), (3, 3, 7), (8, 2, 40)]:
        assert torch.equal(band.run(*c), ref), c
    res = at.autotune(candidates=[(1, 2, 40), (3, 1, 5)], **SMALL)
    assert res["acc_hash"] == at.accum_hash(
        at._BookBand(48, 27, 1, "exact", 4, torch.device("cpu")).run(2, 2, 40))
    digests = iter(["a", "b"])
    monkeypatch.setattr(at, "accum_hash", lambda acc: next(digests))
    with pytest.raises(RuntimeError, match="images differ"):
        at.autotune(candidates=[(1, 2, 40), (3, 1, 5)], **SMALL)


def test_cli_autotune_flag(tmp_path, monkeypatch, capsys):
    """--autotune with a pre-seeded cache applies the tuned point (no sweep)
    and renders the image the render without it renders."""
    cache = tmp_path / "tune.json"
    cache.write_text(json.dumps({"cpu": {"m": 2, "j": 1, "k": 4, "device_kind": "cpu"}}))
    monkeypatch.setattr(at, "CACHE_PATH", cache)
    monkeypatch.setattr(at, "autotune", lambda **kw: pytest.fail("swept"))
    tuned, plain = tmp_path / "tuned.png", tmp_path / "plain.png"
    argv = ["--samples", "1", "--width", "48", "--height", "27", "--depth", "4", "--store"]
    j0, k0 = gk.J_STEPS, gk.K_STEPS
    try:
        assert cli.main(["--autotune"] + argv + ["--out", str(tuned)], device="cpu") == 0
        assert gk.J_STEPS == 1 and gk.K_STEPS == 4
    finally:
        gk.J_STEPS, gk.K_STEPS = j0, k0
    assert cli.main(argv + ["--out", str(plain)], device="cpu") == 0
    assert tuned.read_bytes() == plain.read_bytes()
    assert capsys.readouterr().out.count("duration_per_frame") == 2


def test_sweep_block_needs_a_card(monkeypatch):
    """The block sweep refuses the CPU, and a list without block 128 (the
    reference image) before it builds anything."""
    with pytest.raises(RuntimeError, match="CUDA device"):
        at.sweep_block(device="cpu")
    monkeypatch.setattr(at, "cuda_device", lambda device: torch.device("cuda", 0))
    with pytest.raises(ValueError, match="block 128"):
        at.sweep_block(blocks=(64, 256))


def test_grid_block_resolution_and_hash(tmp_path, monkeypatch):
    """RAYTRACE_TORCH_GRID_BLOCK over the cache's block for the card's kind
    over 128; each block has a library of its own; no compiler runs."""
    kind = "NVIDIA H100 80GB HBM3"
    cache = tmp_path / "tune.json"
    monkeypatch.setattr(at, "CACHE_PATH", cache)
    monkeypatch.delenv(_build.GRID_BLOCK_ENV, raising=False)
    assert _build.resolve_grid_block(kind) == _build.DEFAULT_GRID_BLOCK == 128
    at.save_tuned({"m": 2, "j": 2, "k": 40, "device_kind": kind, "mode": "fast",
                   "block": 256})
    assert at.cached_block(kind) == 256
    assert _build.resolve_grid_block(kind) == 256
    assert _build.resolve_grid_block("NVIDIA H200") == 128  # another card's row
    at.save_tuned({"m": 2, "j": 2, "k": 40, "device_kind": kind, "block": 64})
    assert _build.resolve_grid_block(kind) == 64  # the exact row first
    monkeypatch.setenv(_build.GRID_BLOCK_ENV, "128")
    assert _build.resolve_grid_block(kind) == 128
    monkeypatch.setenv(_build.GRID_BLOCK_ENV, "96")
    with pytest.raises(ValueError, match="multiple of 32 dividing 1024"):
        _build.resolve_grid_block(kind)

    hashes = {b: _build.source_hash(b) for b in (64, 128, 256)}
    assert len(set(hashes.values())) == 3
    assert _build.build_dir(256).name == hashes[256]
    assert _build.source_hash(128) == hashes[128]  # stable
