"""Port parity: the grid kernel's section-cost probes (``ablate``).

The JAX package's ``gridkernel.ABLATE`` switches and the port's ``freeze``
(ops/gridkernel.py ``SWITCHES``; the paged kernel's are in
test_torch_probes_paged.py).  On the CPU the step wrapper runs the plain
version: the duplication switches (``global2`` ... ``camera2``) compute the
same function, so a render under any of them, through ``render_band`` and
through ``Renderer`` with ``gridkernel.ABLATE`` set, is the base image bit
for bit; each removal switch (``cut_*``) is held against the JAX
``grid_megakernel_step`` in Pallas interpret mode with the same ``ablate``,
one launch from the same packed state, by test_torch_gridkernel.py's rule
(the discrete state bit-equal on >= 97% of lanes; XLA:CPU's FMAs and rsqrt
leave the rest to float noise); ``freeze`` (no JAX counterpart on this
kernel) pins the march.  The Mosaic switches and ``grid_steps`` still raise.
The CUDA variants are held against these plain versions on the card
(chip_smoke.py phase 11, tests/test_torch_cuda.py).  The three probe scripts
run on the CPU at a tiny size and print the JAX scripts' lines.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from raytrace_tpu.ops import gridkernel as jgrid
from raytrace_tpu_torch import RenderConfig, _build
from raytrace_tpu_torch.models.scene import generate_random_scene
from raytrace_tpu_torch.ops import gridkernel, pagedkernel, trace
from raytrace_tpu_torch.runtime.renderer import Renderer, reference_camera

torch.set_num_threads(1)

CSRC = Path(_build.__file__).resolve().parent / "csrc"
CUTS = [a for a in gridkernel.SWITCHES if a.startswith("cut_")]
DISCRETE_F_ROWS = [jgrid.R_FX, jgrid.R_FY, jgrid.R_THR, jgrid.R_THR + 1, jgrid.R_THR + 2]
PORT_TO_JAX = list(range(gridkernel.R_CUR)) + [jgrid.R_CUR + i for i in range(3)]
MOSAIC = ("fuse2", "fuse4", "vmajor", "pad8", "state2", "nodual", "noskipdead",
          "teaalways", "flushflat", "redot", "distinctwalk", "fusedlid", "fusedovf")
W, H = 24, 14


@pytest.fixture(scope="module")
def book():
    return trace.prepare_scene(generate_random_scene(0.0))


@pytest.mark.parametrize("kernel", ["grid", "paged"])
def test_switch_bits_match_the_cuda_source(kernel):
    """Bit i of a variant's mask is ``SWITCHES[i]`` in the Python module
    and the CUDA source alike."""
    mod = gridkernel if kernel == "grid" else pagedkernel
    text = (CSRC / f"{kernel}kernel.cu").read_text()
    bits = {int(b): name.lower() for name, b in
            re.findall(r"constexpr bool (\w+) = RT_ABLATE & \(1u << (\d+)\);", text)}
    assert bits == dict(enumerate(mod.SWITCHES))


def test_one_library_per_switch_set():
    """The production build has no switch define and keeps its hash; a
    variant builds only the kernel it varies, under a hash of its own."""
    assert _build._defines("gridkernel.cu", 128) == ["-DRT_GRID_BLOCK=128"]
    assert _build._defines("pagedkernel.cu", 128) == []
    assert _build._defines("gridkernel.cu", 128, grid=5) == ["-DRT_GRID_BLOCK=128",
                                                             "-DRT_ABLATE=5"]
    assert _build._defines("pagedkernel.cu", 128, grid=5, paged=3) == ["-DRT_ABLATE=3"]
    assert _build.variant_sources() == _build.SOURCES
    assert _build.variant_sources(grid=1) == ("gridkernel.cu",)
    assert _build.variant_sources(paged=1) == ("pagedkernel.cu",)
    hashes = {_build.source_hash(128, g, p) for g, p in ((0, 0), (1, 0), (2, 0), (0, 1), (1, 1))}
    assert len(hashes) == 5
    assert gridkernel.switch_mask(("freeze", "cut_tea")) == (1 << 16) | (1 << 7)
    assert gridkernel.switch_mask(()) == 0


def _render(book_np, **kw):
    ds = trace.device_scene_from_numpy(book_np, "cpu")
    vp = trace.viewport_arrays(reference_camera(), W, H)
    return trace.render_band(ds, vp, band_h=H, width=W, y0=0, seed_y0=0, offset_x=0,
                             spp=2, number=0, max_depth=8, backend="grid",
                             pixels_per_lane=2, skip_tmax=True, **kw)


@pytest.mark.parametrize("switch", gridkernel.DUPLICATIONS)
def test_duplication_leaves_the_image(book, switch, monkeypatch):
    """A duplication switch renders the base image bit for bit, through
    ``render_band`` and through ``Renderer`` reading ``gridkernel.ABLATE``."""
    base = _render(book)
    assert torch.equal(_render(book, ablate=(switch,)), base)
    cfg = RenderConfig(samples=2, width=W, height=H, max_depth=8, backend="grid")
    want = Renderer(cfg, device="cpu").render_call(2)
    seen = []
    orig = gridkernel.grid_megakernel_step

    def spy(*a, **kw):
        seen.append(kw["ablate"])
        return orig(*a, **kw)

    monkeypatch.setattr(gridkernel, "grid_megakernel_step", spy)
    monkeypatch.setattr(gridkernel, "ABLATE", frozenset({switch}))
    assert torch.equal(Renderer(cfg, device="cpu").render_call(2), want)
    assert seen and all(s == (switch,) for s in seen)


def _jax_layout(f, acc, m_slots, n_lanes):
    """The JAX f32 grid state rows from the port's state and home-order
    accumulator (lane k is lane0 k; test_torch_gridkernel.py's map)."""
    f = f.numpy()
    out = np.zeros((jgrid.f_rows(m_slots), f.shape[1]), np.float32)
    out[PORT_TO_JAX] = f
    pix = np.arange(m_slots)[:, None] * n_lanes + np.arange(n_lanes)[None, :]
    acc_pad = np.zeros((m_slots * n_lanes + 1, 3), np.float32)
    acc_pad[: acc.shape[0]] = acc.numpy()
    out[jgrid.R_ACC : jgrid.R_ACC + 3 * m_slots, :n_lanes] = (
        acc_pad[pix.reshape(-1)].reshape(m_slots, n_lanes, 3)
        .transpose(0, 2, 1).reshape(3 * m_slots, n_lanes))
    return out


def _state(book_np, spp=2):
    """A packed book-scene state: one JAX TILE of lanes, M=3, 64x48."""
    ds = trace.device_scene_from_numpy(book_np, "cpu")
    vp = trace.viewport_arrays(reference_camera(), 64, 48)
    f, u, scal, vpr, geom = trace.pack_state(
        ds, vp, backend="grid", band_h=48, width=64, y0=0, seed_y0=0, offset_x=0,
        spp=spp, number=0, pixels_per_lane=3, lane_pad=jgrid.TILE)
    return ds, f, u, scal, vpr, dict(geom, max_depth=12, skip_tmax=True, j_steps=2)


# Two cuts leave garbage that XLA's float noise reaches (ROADMAP queue 3):
# under cut_shade the throughput is a product of ray directions, which
# XLA's rsqrt normalizes differently in the last bit (the u32 rows and pixel
# coords measured 99.9%, the throughput 18.0%), so its rule leaves the
# throughput out; under cut_resolve every attribute is the winner's id, so a
# grid winner is glass of eta 1/id, whose refraction test XLA's noise
# flips (measured 91.4%).  Measured shares of the others: cut_tea 97.4%,
# cut_globals 99.7%, cut_init, cut_fetch, cut_quad 99.9%, cut_sin 98.6%,
# cut_camera 99.4%.
SHARE = {"cut_resolve": 0.90}
NO_THROUGHPUT = ("cut_shade",)


@pytest.mark.parametrize("switch", CUTS)
def test_removal_matches_jax_interpret(book, switch):
    """One launch of K_STEPS iterations with the removal switch, from the
    same packed state: the discrete state (u32 rows, pixel coords,
    throughput) bit-equal to the JAX step's on >= 97% of lanes (see
    ``SHARE`` and ``NO_THROUGHPUT``), and on those lanes the winner key bit
    for bit."""
    ds, f, u, scal, vpr, kw = _state(book)
    kw = dict(kw, k_steps=gridkernel.K_STEPS)
    n = kw["n_lanes"]
    acc0 = trace.home_accum(None, kw["p_total"], "cpu")
    f0 = _jax_layout(f, acc0, 3, n)
    u12 = np.zeros((12, f.shape[1]), np.uint32)  # JAX rows 8-11: call merge
    u12[:8] = u.numpy()[:8].view(np.uint32)
    u12[jgrid.U_CALL] = u.numpy()[gridkernel.U_CALL].view(np.uint32)
    u12[jgrid.U_PEND] = 1
    g = book.grid
    fj, uj = jgrid.grid_megakernel_step(
        scal.numpy(), vpr.numpy(), g.gscal, g.gtab, g.gttab, g.ctab, g.atab, f0, u12,
        None, None, interpret=True, five=False, n_slots=4, ablate=(switch,), **kw)
    fj = np.asarray(fj)[:, :n]
    uj = np.asarray(uj)[[*range(8), jgrid.U_CALL]].view(np.int32)[:, :n]
    acc = acc0.clone()
    fp, up = gridkernel.grid_megakernel_step(scal, vpr, ds.grid, f, u, acc,
                                             ablate=(switch,), **kw)
    fp = _jax_layout(fp, acc, 3, n)[:, :n]
    up = up.numpy()[[*range(8), gridkernel.U_CALL]][:, :n]
    rows = DISCRETE_F_ROWS[:2] if switch in NO_THROUGHPUT else DISCRETE_F_ROWS
    same = (up == uj).all(axis=0) & (fp[rows] == fj[rows]).all(axis=0)
    assert same.mean() >= SHARE.get(switch, 0.97), \
        f"{switch}: discrete state equal on {same.mean():.2%}"
    assert np.array_equal(fp[jgrid.R_BKEY, same], fj[jgrid.R_BKEY, same])
    # the switch did something: the state is not the base launch's
    fb, ub = gridkernel.grid_megakernel_step(scal, vpr, ds.grid, f, u, acc0.clone(), **kw)
    assert not (torch.equal(fb, torch.from_numpy(fp)) and torch.equal(ub, u))


def test_freeze_pins_the_march(book):
    """``freeze``: a lane that was marching keeps its cell, its march rows,
    ``alive`` and every other row but its winner (t_best, bkey), and on
    lanes that all march the accumulator stays as it was; a lane whose
    segment ended runs on as without the switch for that iteration."""
    ds, f, u, scal, vpr, kw = _state(book, spp=1_000_000)
    acc = trace.home_accum(None, kw["p_total"], "cpu")
    f1, u1 = gridkernel.grid_megakernel_step(scal, vpr, ds.grid, f, u, acc,
                                             k_steps=gridkernel.K_STEPS, **kw)
    live = trace.live_lanes(u1[gridkernel.U_ALIVE])
    f1, u1 = trace.gather_lanes(f1, u1, live)
    march = u1[gridkernel.U_MARCH] != 0
    assert 0.02 < float(march.float().mean()) < 1.0
    acc1 = acc.clone()
    f2, u2 = gridkernel.grid_megakernel_step(scal, vpr, ds.grid, f1, u1, acc1,
                                             k_steps=8, ablate=("freeze",), **kw)
    keep = [r for r in range(gridkernel.F_ROWS) if r not in (gridkernel.R_TB, gridkernel.R_BKEY)]
    assert torch.equal(u2[:, march], u1[:, march])
    assert torch.equal(f2[keep][:, march], f1[keep][:, march])
    assert (f2[gridkernel.R_TB, march] <= f1[gridkernel.R_TB, march]).all()
    # only marching lanes: nothing flushes, and a second launch changes nothing
    fm, um = trace.gather_lanes(f1, u1, torch.nonzero(march).reshape(-1))
    acc2 = acc.clone()
    f3, u3 = gridkernel.grid_megakernel_step(scal, vpr, ds.grid, fm, um, acc2,
                                             k_steps=8, ablate=("freeze",), **kw)
    f4, u4 = gridkernel.grid_megakernel_step(scal, vpr, ds.grid, f3, u3, acc2,
                                             k_steps=8, ablate=("freeze",), **kw)
    assert torch.equal(acc2, acc)
    assert torch.equal(u3, um) and torch.equal(f4, f3) and torch.equal(u4, u3)


@pytest.mark.parametrize("backend", ["grid", "paged"])
def test_mosaic_switches_and_grid_steps_raise(book, backend):
    """The Mosaic switches raise ``NotImplementedError`` naming ROADMAP,
    in a render and at the step; ``grid_steps`` too; ``freeze`` is refused
    in a render (its march never ends), and a switch of the other kernel
    is refused."""
    ds = trace.device_scene_from_numpy(book, "cpu")
    vp = trace.viewport_arrays(reference_camera(), 8, 4)
    base = dict(band_h=4, width=8, y0=0, seed_y0=0, offset_x=0, spp=1, number=0,
                max_depth=2, backend="grid")
    step = gridkernel.grid_megakernel_step if backend == "grid" else \
        pagedkernel.paged_megakernel_step
    for token in MOSAIC:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            trace.render_band(ds, vp, **dict(base, backend=backend), ablate=(token,))
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            step(None, None, None, None, None, None, m_slots=1, n_lanes=1, p_total=1,
                 width=1, max_depth=1, ablate=(token,))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trace.render_band(ds, vp, **base, grid_steps=(2, 40))
    with pytest.raises(ValueError, match="never ends"):
        trace.render_band(ds, vp, **base, ablate=("freeze",))
    other = "cut_gsel" if backend == "grid" else "fetch2"
    with pytest.raises(ValueError, match="switches"):
        trace.render_band(ds, vp, **dict(base, backend=backend), ablate=(other,))


def test_grid_ablate_script(monkeypatch, capsys):
    """``python -m raytrace_tpu_torch.scripts.grid_ablate --device cpu`` at
    16x8 x 2 spp: every duplication renders base's image (it raises if
    not) and the JAX script's lines print."""
    from raytrace_tpu_torch.scripts import grid_ablate

    for k, v in dict(SWEEP_W="16", SWEEP_H="8", SWEEP_SPP="2", SWEEP_ROUNDS="1").items():
        monkeypatch.setenv(k, v)
    ablate0 = gridkernel.ABLATE
    med = grid_ablate.main(["--device", "cpu"])
    assert gridkernel.ABLATE == ablate0
    assert list(med) == grid_ablate.VARIANTS.split(",")
    out = capsys.readouterr().out
    assert "base median:" in out and "ns/sample" in out and "round 0:" in out
    assert all(re.search(rf"^{v} +median .* delta ", out, re.M) for v in gridkernel.DUPLICATIONS)
    assert "not measured (CPU)" in out and "cpu" in out
    monkeypatch.setenv("ABLATE_VARIANTS", "base,cut_tea")
    with pytest.raises(ValueError, match="duplications"):
        grid_ablate.main(["--device", "cpu"])


def test_grid_iterbench_script(monkeypatch, capsys):
    """``grid_iterbench --device cpu`` at 32x16, M=2, two launches a round:
    every removal under ``freeze`` runs, and the JAX script's lines print."""
    from raytrace_tpu_torch.scripts import grid_iterbench

    monkeypatch.setattr(grid_iterbench, "W", 32)
    monkeypatch.setattr(grid_iterbench, "H", 16)
    monkeypatch.setattr(grid_iterbench, "M", 2)
    for k, v in dict(INVOKES="2", ROUNDS="1", SWEEP_MODE="fast").items():
        monkeypatch.setenv(k, v)
    med = grid_iterbench.main(["--device", "cpu"])
    assert list(med) == grid_iterbench.VARIANTS.split(",")
    out = capsys.readouterr().out
    assert re.search(r"base median: .*us per tile-iteration, \d+ tiles x 80 iterations", out)
    assert all(re.search(rf"^{v} +median .* delta ", out, re.M) for v in CUTS if v != "cut_sin")
