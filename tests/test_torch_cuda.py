"""The CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA device and skips without one.  This file
imports no JAX (the GPU machine has none), so it runs there without the
repository's conftest, which imports jax:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Each test packs a state, takes one launch of the kernel and one call of its
plain version from it, and requires every state row to be bit-equal
(NaN == NaN): the kernels and the plain versions run the same IEEE op
sequence (nvcc --fmad=false, no fast math; CUDA's sinf on both sides).
The cases cover what the smoke run does not: for the grid kernel the
cell-major records of the 5-value slot layout, the textured field's
``tattrs`` and pitch 2's wider 4-value cells, on the driver's compacted live
lanes with its home-order accumulator, and the compacted driver itself; its
call merge, balanced table and iterstats instance;
fast mode, a carried accumulator and tables larger than one 512-row block;
for the paged kernel all four instances of its template (varied-height and
textured page layouts) on the driver's sorted and compacted lanes, its
home-order accumulator and the sort key it emits; for the fused intersect
kernel the valid-prefix scan, a table of several shared-memory chunks and
one whose valid rows are not a prefix; for the gather probe and its loop
baseline (``scripts/bench_gather.py``'s two kernels) every block's slice,
at one block per SM and at three, on indices that are negative or wrap
int32 too, and on both of the probe's axis-1 paths, alone and in one
launch; for the section-cost probes (one library per switch set), every
grid duplication == the production kernel and ``freeze`` with each removal
== the plain version, on every grid table layout and all four paged
template instances; for the paged tables built on the card, the 100k field's
whole DeviceScene at 50 frame times against the host's, the split
(``hot_slots=-1``), textured and varied-height tables against the CPU build,
and every wait of the build and of a frame's ``set_scene`` counted.
"""

import warnings

import pytest
import torch

from raytrace_tpu_torch import RenderConfig
from raytrace_tpu_torch.models.paged_grid import build_paged_grid
from raytrace_tpu_torch.models.scene import (CHECKERED, generate_random_scene,
                                             random_sphere_field, three_sphere_scene)
from raytrace_tpu_torch.ops import (gridkernel, intersect, megakernel, pagedkernel,
                                    pallas_intersect, trace)
from raytrace_tpu_torch.runtime.renderer import Renderer, reference_camera
from raytrace_tpu_torch.scripts import bench_gather

RR = (1, 16, 0.05)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda", 0)


def _textured_field():
    sc = random_sphere_field(60, seed=3, extent=8.0)
    sc.texture[10:20] = CHECKERED
    sc.color1[10:20] = (0.9, 0.1, 0.1)
    return sc


SCENES = {
    "book": (generate_random_scene, 1.0),
    "book_pitch2": (generate_random_scene, 2.0),
    "tall_field": (lambda t: random_sphere_field(60, seed=3, extent=8.0, y_range=(0.2, 2.5)), 1.0),
    "textured_field": (lambda t: _textured_field(), 1.0),
}


def _launch_pair(kern, plain, f, u):
    out_k = kern(f, u)
    out_p = plain(f, u)
    torch.cuda.synchronize()
    return out_k, out_p


def _assert_same(out_k, out_p):
    (fk, uk), (fp, up) = out_k, out_p
    assert torch.equal(uk, up)
    same = (fk == fp) | (torch.isnan(fk) & torch.isnan(fp))
    assert bool(same.all()), f"{int((~same.all(dim=0)).sum())} lanes differ"


def _state(ds, backend, *, w=128, h=72, m=2, spp=2, accum=None):
    vp = trace.viewport_arrays(reference_camera(), w, h)
    return trace.pack_state(ds, vp, backend=backend, band_h=h, width=w, y0=0,
                            seed_y0=0, offset_x=0, spp=spp, number=3,
                            accum_init=accum, pixels_per_lane=m)


@pytest.mark.gpu
@pytest.mark.parametrize("rr", [None, RR], ids=["exact", "fast"])
@pytest.mark.parametrize("name", list(SCENES))
def test_grid_kernel_matches_plain(cuda, name, rr):
    """Four launches along one render on the driver's compacted live lanes
    (lane0 != lane once lanes died), each compared with the plain version:
    the state and the home-order accumulator."""
    make, pitch = SCENES[name]
    ds = trace.device_scene_from_numpy(trace.prepare_scene(make(0.0), grid_pitch=pitch), cuda)
    assert ds.grid is not None
    f, u, scal, vpr, geom = _state(ds, "grid")
    acc = trace.home_accum(torch.rand((72, 128, 3), device=cuda), geom["p_total"], cuda)
    acc0 = acc.clone()
    kw = dict(geom, max_depth=50, skip_tmax=True, rr=rr, k_steps=10)
    for _ in range(4):
        f, u = trace.gather_lanes(f, u, trace.live_lanes(u[gridkernel.U_ALIVE]))
        acc_k, acc_p = acc.clone(), acc.clone()
        out_k = gridkernel.grid_megakernel_step(scal, vpr, ds.grid, f, u, acc_k, **kw)
        out_p = gridkernel.grid_megakernel_step_plain(scal, vpr, ds.grid, f, u, acc_p, **kw)
        torch.cuda.synchronize()
        _assert_same(out_k, out_p)
        assert torch.equal(acc_k, acc_p)
        (f, u), acc = out_k, acc_k
    assert not torch.equal(acc, acc0)  # pixels were flushed


VARIANTS = ("merged", "balanced", "iterstats")


@pytest.mark.gpu
@pytest.mark.parametrize("rr", [None, RR], ids=["exact", "fast"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_grid_kernel_variants_match_plain(cuda, variant, rr):
    """The call merge (n_calls=3, a shorter last call), a balanced table
    (a seeded permutation of the pixels) and the iterstats instance, each
    four launches along one book-scene render on the driver's compacted live
    lanes with a carried accumulator: state and accumulator == the plain
    version's on every lane and pixel."""
    from raytrace_tpu_torch.runtime.balance import build_passign

    w, h, m = 128, 72, 2
    ds = trace.device_scene_from_numpy(trace.prepare_scene(generate_random_scene(0.0)), cuda)
    vp = trace.viewport_arrays(reference_camera(), w, h)
    extra, step = {}, {}
    if variant == "merged":
        extra = dict(n_calls=3, spp_last=1)
    elif variant == "balanced":
        g = torch.Generator().manual_seed(5)
        tab = build_passign(torch.rand(w * h, generator=g).numpy(), m, trace.LANE_PAD)
        extra = dict(passign=torch.from_numpy(tab).to(cuda))
        step = dict(passign=extra["passign"])
    else:
        step = dict(iterstats=True)
    f, u, scal, vpr, geom = trace.pack_state(
        ds, vp, backend="grid", band_h=h, width=w, y0=0, seed_y0=0, offset_x=0,
        spp=2, number=3, pixels_per_lane=m, **extra)
    acc = trace.home_accum(torch.rand((h, w, 3), device=cuda), geom["p_total"], cuda)
    acc0 = acc.clone()
    kw = dict(geom, max_depth=50, skip_tmax=True, rr=rr, k_steps=10, **step)
    for _ in range(4):
        f, u = trace.gather_lanes(f, u, trace.live_lanes(u[gridkernel.U_ALIVE]))
        acc_k, acc_p = acc.clone(), acc.clone()
        out_k = gridkernel.grid_megakernel_step(scal, vpr, ds.grid, f, u, acc_k, **kw)
        out_p = gridkernel.grid_megakernel_step_plain(scal, vpr, ds.grid, f, u, acc_p, **kw)
        torch.cuda.synchronize()
        _assert_same(out_k, out_p)
        assert torch.equal(acc_k, acc_p)
        (f, u), acc = out_k, acc_k
    assert not torch.equal(acc, acc0)  # chunks were flushed
    if variant == "merged":
        assert int(u[gridkernel.U_CALL].max()) > 0  # lanes reached a later call


@pytest.mark.gpu
@pytest.mark.parametrize("rr", [None, RR], ids=["exact", "fast"])
@pytest.mark.parametrize("name", ["book", "three_sphere", "field2000"])
def test_megakernel_matches_plain(cuda, name, rr):
    scene = {"book": lambda: generate_random_scene(0.0),
             "three_sphere": three_sphere_scene,
             # 2048-row table: more than one 512-row block
             "field2000": lambda: random_sphere_field(2000, seed=1, extent=7.0)}[name]()
    ds = trace.device_scene_from_numpy(trace.prepare_scene(scene), cuda)
    accum = torch.rand((72, 128, 3), device=cuda)
    f, u, scal, vpr, geom = _state(ds, "mega", accum=accum)
    atab = ds.table[:, 8:24].T.contiguous()
    # the kernel scans the valid prefix, the plain version every row
    n_valid = int(ds.valid.sum())
    kw = dict(geom, max_depth=50, skip_tmax=False, rr=rr)
    step_k = lambda f_, u_: megakernel.megakernel_step(scal, vpr, ds.table, atab, f_, u_,
                                                        n_valid=n_valid, **kw)
    step_p = lambda f_, u_: megakernel.megakernel_step_plain(scal, vpr, ds.table, atab, f_, u_, **kw)
    for _ in range(3):
        out_k, out_p = _launch_pair(step_k, step_p, f, u)
        _assert_same(out_k, out_p)
        f, u = out_k


@pytest.mark.gpu
def test_renders_match_plain_renders(cuda):
    """A whole band through ``render_band``: kernel image == plain-version
    image (the same host loop runs the CPU plain path)."""
    ds_np = trace.prepare_scene(generate_random_scene(0.0))
    vp = trace.viewport_arrays(reference_camera(), 64, 36)
    kw = dict(band_h=36, width=64, y0=0, seed_y0=0, offset_x=0, spp=2,
              number=0, max_depth=12, pixels_per_lane=3, skip_tmax=True)
    for backend in ("grid", "mega"):
        on_gpu = trace.render_band(trace.device_scene_from_numpy(ds_np, cuda), vp,
                                   backend=backend, **kw).cpu()
        on_cpu = trace.render_band(trace.device_scene_from_numpy(ds_np, "cpu"), vp,
                                   backend=backend, **kw)
        diff = (on_gpu != on_cpu).any(dim=2)
        # CUDA's sinf and torch's CPU sin may differ by an ulp, which can
        # flip a checker sign at a zero crossing (the known chaos class)
        assert int(diff.sum()) <= 3, f"{backend}: {int(diff.sum())} px differ"


@pytest.mark.gpu
def test_wrapper_counts_and_checks(cuda):
    ds = trace.device_scene_from_numpy(trace.prepare_scene(generate_random_scene(0.0)), cuda)
    f, u, scal, vpr, geom = _state(ds, "grid", w=32, h=18, m=1)
    acc = trace.home_accum(None, geom["p_total"], cuda)
    kw = dict(geom, max_depth=8, skip_tmax=True)
    before = gridkernel.grid_megakernel_step.launches
    plain_before = gridkernel.grid_megakernel_step_plain.launches
    gridkernel.grid_megakernel_step(scal, vpr, ds.grid, f, u, acc, **kw)
    assert gridkernel.grid_megakernel_step.launches == before + 1
    assert gridkernel.grid_megakernel_step_plain.launches == plain_before
    with pytest.raises(TypeError):
        gridkernel.grid_megakernel_step(scal, vpr, ds.grid, f.double(), u, acc, **kw)
    with pytest.raises(ValueError):
        gridkernel.grid_megakernel_step(scal, vpr, ds.grid, f[:, ::2], u[:, ::2], acc, **kw)
    with pytest.raises(ValueError):
        gridkernel.grid_megakernel_step(scal, vpr, ds.grid, f, u, acc[1:], **kw)


def _field(y_range=None, textured=False):
    sc = random_sphere_field(2000, seed=1, extent=7.0, y_range=y_range)
    if textured:
        sc.texture[50:200] = CHECKERED
        sc.color1[50:200] = (0.9, 0.2, 0.1)
    return sc


FIELDS = {
    "dense": {},
    "varied": dict(y_range=(0.2, 2.0)),
    "dense_textured": dict(textured=True),
    "varied_textured": dict(y_range=(0.2, 2.0), textured=True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("rr", [None, RR], ids=["exact", "fast"])
@pytest.mark.parametrize("name", list(FIELDS))
def test_paged_kernel_matches_plain(cuda, name, rr):
    """Each (five, textured) instance of the kernel's template, on the
    driver's sorted and compacted live lanes (lane0 != lane, fewer lanes
    than the band has): the state, the accumulator and the emitted key row
    (== ``_rebucket_key`` of the new state) equal the plain version's."""
    ds = trace.device_scene_from_numpy(trace.prepare_scene(_field(**FIELDS[name])), cuda)
    assert ds.paged is not None
    f, u, scal, vpr, geom = _state(ds, "paged")
    acc = trace.home_accum(torch.rand((72, 128, 3), device=cuda), geom["p_total"], cuda)
    kw = dict(geom, max_depth=50, skip_tmax=True, rr=rr, k_steps=10)
    key = trace._rebucket_key(f, u, ds.paged.gscal)
    acc0 = acc.clone()
    for _ in range(4):
        f, u = trace.gather_lanes(f, u, trace.live_order(key))
        acc_k, acc_p = acc.clone(), acc.clone()
        fk, uk, key = pagedkernel.paged_megakernel_step(scal, vpr, ds.paged, f, u, acc_k, **kw)
        fp, up, key_p = pagedkernel.paged_megakernel_step_plain(
            scal, vpr, ds.paged, f, u, acc_p, **kw)
        torch.cuda.synchronize()
        _assert_same((fk, uk), (fp, up))
        assert torch.equal(key, key_p)
        assert torch.equal(key, trace._rebucket_key(fk, uk, ds.paged.gscal))
        assert torch.equal(acc_k, acc_p)
        f, u, acc = fk, uk, acc_k
    assert not torch.equal(acc, acc0)  # pixels were flushed
    assert f.shape[1] < geom["n_lanes"]  # dead lanes were dropped


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["book_prefix", "book", "field2000", "field2000_holes"])
def test_intersect_kernel_matches_plain(cuda, name):
    """Seeded rays (a count that no block size divides); the book table
    scanned over its valid prefix or whole, the 2048-row table (two
    shared-memory chunks) whole, and the same with every third row invalid,
    whose valid rows are no prefix.  The plain version scans every row."""
    scene = (generate_random_scene(0.0) if name.startswith("book")
             else random_sphere_field(2000, seed=1, extent=7.0))
    table = torch.from_numpy(intersect.sphere_table(scene)).to(cuda)
    if name.endswith("holes"):
        table[::3, 4] = 0.0
    n_valid = int(scene.n_spheres) if name.endswith("prefix") else None
    g = torch.Generator().manual_seed(3)
    o = (torch.randn((50_001, 3), generator=g) * 4 + torch.tensor([0.0, 3.0, 0.0])).to(cuda)
    d = torch.randn((50_001, 3), generator=g).to(cuda)
    d = d / d.norm(dim=1, keepdim=True)
    before = pallas_intersect.intersect_shade_pallas.launches
    tk, hk, ak = pallas_intersect.intersect_shade_pallas(o, d, table, n_valid=n_valid)
    tp, hp, ap = pallas_intersect.intersect_shade_pallas_plain(o, d, table)
    torch.cuda.synchronize()
    assert pallas_intersect.intersect_shade_pallas.launches == before + 1
    assert bool(hk.any()) and bool((~hk).any())
    assert torch.equal(tk, tp) and torch.equal(hk, hp) and torch.equal(ak, ap)


@pytest.mark.gpu
def test_paged_and_pallas_renders_match_plain_renders(cuda):
    """Whole bands: the paged kernel on the dense field and the fused
    intersect kernel on the book scene, each against the same render on the
    CPU through the plain versions."""
    cases = (("paged", trace.prepare_scene(_field()), 48, 27),
             ("pallas", trace.prepare_scene(generate_random_scene(0.0)), 24, 14))
    for backend, ds_np, w, h in cases:
        vp = trace.viewport_arrays(reference_camera(), w, h)
        kw = dict(band_h=h, width=w, y0=0, seed_y0=0, offset_x=0, spp=2,
                  number=0, max_depth=12, pixels_per_lane=2, skip_tmax=True,
                  backend=backend)
        on_gpu = trace.render_band(trace.device_scene_from_numpy(ds_np, cuda), vp, **kw).cpu()
        on_cpu = trace.render_band(trace.device_scene_from_numpy(ds_np, "cpu"), vp, **kw)
        diff = (on_gpu != on_cpu).any(dim=2)
        assert int(diff.sum()) <= 3, f"{backend}: {int(diff.sum())} px differ"


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["grid", "mega", "paged"])
def test_bands_on_one_card_equal_the_whole(cuda, backend):
    """Four row bands of one card, stepped in turns, each on a stream of its
    own (MultiChipRenderer, and HeteroRenderer after an uneven re-split),
    against the single-device render: 0 px differ, and every launch was a
    kernel's."""
    from raytrace_tpu_torch import RenderConfig
    from raytrace_tpu_torch.parallel.hetero import HeteroRenderer
    from raytrace_tpu_torch.parallel.sharding import MultiChipRenderer
    from raytrace_tpu_torch.runtime.renderer import Renderer

    scene = {"grid": generate_random_scene(0.0), "mega": three_sphere_scene(),
             "paged": _field()}[backend]
    cfg = RenderConfig(samples=2, width=64, height=37, max_depth=8, backend=backend,
                       samples_per_call=1)
    plain = {"grid": gridkernel.grid_megakernel_step_plain,
             "mega": megakernel.megakernel_step_plain,
             "paged": pagedkernel.paged_megakernel_step_plain}[backend]
    before = plain.launches
    whole = Renderer(cfg, scene=scene, device=cuda).render()[0]
    bands = MultiChipRenderer(cfg, scene=scene, devices=[cuda] * 4).render()[0]
    assert torch.equal(bands, whole)
    hr = HeteroRenderer(cfg, scene=scene, devices=[cuda] * 4, reference_banding=False)
    hr.rows = [20, 1, 0, 16]
    one = Renderer(cfg, scene=scene, device=cuda).render_call(2).cpu().numpy()
    assert (hr.render_frame(2)[0] == one).all()
    assert plain.launches == before


def _gather_inputs(mode, dev):
    """The probe's seeded table and ``mode``'s indices: "rand", "lane",
    "wide" (the whole int32 range, some at the top so that idx + i wraps),
    "wide-lane" (the same per lane, broadcast over the rows: the record
    path), "mixed" (record-path and row-path warps in one launch) or
    "lane-row" (per-lane indices that every warp reads on the row path)."""
    tab, idx = bench_gather.check_inputs(mode)
    return torch.from_numpy(tab).to(dev), torch.from_numpy(idx).to(dev)


def _blocks_equal(out, ref):
    same = (out == ref[None]) | (torch.isnan(out) & torch.isnan(ref[None]))
    return bool(same.all())


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["rand", "lane", "wide", "wide-lane", "mixed",
                                  "lane-row"])
@pytest.mark.parametrize("axis", [1, 0])
def test_gather_probe_matches_plain(cuda, axis, mode):
    """The gather kernel == its plain version on every block's slice (one
    block per SM, and three) at 1, 7 and 2048 iterations, on both axis-1
    paths (the record path for warps whose lanes broadcast one index over
    the rows, the row path for the others); one launch counted per call."""
    tab, idx = _gather_inputs(mode, cuda)
    for iters in (1, 7, bench_gather.ITERS):
        ref = bench_gather.run_plain(tab, idx, iters=iters, axis=axis)
        for blocks in (None, 3):
            before = bench_gather.run.launches
            out = bench_gather.run(tab, idx, iters=iters, axis=axis, blocks=blocks,
                                   per_block=True)
            torch.cuda.synchronize()
            assert bench_gather.run.launches == before + 1
            assert out.shape[0] == (blocks or torch.cuda.get_device_properties(
                cuda).multi_processor_count)
            assert _blocks_equal(out, ref)
        assert torch.equal(bench_gather.run(tab, idx, iters=iters, axis=axis).isnan(),
                           ref.isnan())


@pytest.mark.gpu
def test_gather_baseline_matches_plain(cuda):
    tab, idx = _gather_inputs("rand", cuda)
    for iters in (1, 7, bench_gather.ITERS):
        ref = bench_gather.run_base_plain(tab, idx, iters=iters)
        for blocks in (None, 3):
            out = bench_gather.run_base(tab, idx, iters=iters, blocks=blocks, per_block=True)
            torch.cuda.synchronize()
            assert _blocks_equal(out, ref)


def _frozen_pair(step, plain, sets, f, u, acc, kw):
    """Each switch set of ``sets``: one launch of the variant and one call of
    the plain version from (f, u), state and accumulator bit-equal."""
    for sw in sets:
        acc_k, acc_p = acc.clone(), acc.clone()
        out_k = step(f, u, acc_k, sw)
        out_p = plain(f, u, acc_p, sw)
        torch.cuda.synchronize()
        _assert_same(out_k[:2], out_p[:2])
        assert torch.equal(acc_k, acc_p), sw
        for k_, p_ in zip(out_k[2:], out_p[2:]):
            assert torch.equal(k_, p_), sw


@pytest.mark.gpu
@pytest.mark.parametrize("rr", [None, RR], ids=["exact", "fast"])
@pytest.mark.parametrize("name", list(SCENES))
def test_grid_probe_variants(cuda, name, rr):
    """The grid kernel's section-cost probes on every table layout: each
    duplication's launch == the production kernel's (state and
    accumulator), ``freeze`` and each removal under it == the plain version,
    from a state one launch in."""
    make, pitch = SCENES[name]
    ds = trace.device_scene_from_numpy(trace.prepare_scene(make(0.0), grid_pitch=pitch), cuda)
    f, u, scal, vpr, geom = _state(ds, "grid")
    acc = trace.home_accum(None, geom["p_total"], cuda)
    kw = dict(geom, max_depth=50, skip_tmax=True, rr=rr, k_steps=10)
    f, u = gridkernel.grid_megakernel_step(scal, vpr, ds.grid, f, u, acc, **kw)
    f, u = trace.gather_lanes(f, u, trace.live_lanes(u[gridkernel.U_ALIVE]))

    def step(fs, us, a, sw):
        return gridkernel.grid_megakernel_step(scal, vpr, ds.grid, fs, us, a, ablate=sw, **kw)

    def plain(fs, us, a, sw):
        return gridkernel.grid_megakernel_step_plain(scal, vpr, ds.grid, fs, us, a,
                                                     ablate=sw, **kw)

    _frozen_pair(step, lambda fs, us, a, sw: step(fs, us, a, ()),
                 [(d,) for d in gridkernel.DUPLICATIONS], f, u, acc, kw)
    _frozen_pair(step, plain, [("freeze",)] + [("freeze", c) for c in gridkernel.SWITCHES
                                               if c.startswith("cut_")], f, u, acc, kw)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(FIELDS))
def test_paged_probe_variants(cuda, name):
    """The paged kernel's ``freeze`` and each removal under it, on all four
    template instances, == the plain version (state, accumulator and key)
    from the driver's sorted lanes one launch in."""
    ds = trace.device_scene_from_numpy(trace.prepare_scene(_field(**FIELDS[name])), cuda)
    f, u, scal, vpr, geom = _state(ds, "paged")
    acc = trace.home_accum(None, geom["p_total"], cuda)
    kw = dict(geom, max_depth=50, skip_tmax=True, k_steps=5)
    f, u, key = pagedkernel.paged_megakernel_step(scal, vpr, ds.paged, f, u, acc, **kw)
    f, u = trace.gather_lanes(f, u, trace.live_order(key))

    def call(fn):
        return lambda fs, us, a, sw: fn(scal, vpr, ds.paged, fs, us, a, ablate=sw, **kw)

    _frozen_pair(call(pagedkernel.paged_megakernel_step),
                 call(pagedkernel.paged_megakernel_step_plain),
                 [("freeze",)] + [("freeze", c) for c in pagedkernel.SWITCHES
                                  if c.startswith("cut_")], f, u, acc, kw)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _pack_pair(ds, backend, w, h, **kw):
    """The band's set-up by the kernel route and by the plain version from
    the same scene on the card: every output (and the paged first key),
    compared bit for bit; the kernel's count moves by one."""
    vp = trace.viewport_arrays(reference_camera(), w, h + kw.get("y0", 0))
    kw = dict(dict(backend=backend, band_h=h, width=w, y0=0, seed_y0=0, offset_x=0,
                   spp=2, number=4100000001, first_key=backend == "paged"), **kw)
    before = trace.pack_state.launches
    out_k = trace.pack_state(ds, vp, **kw)
    out_p = trace.pack_state_plain(ds, vp, **kw)
    torch.cuda.synchronize()
    assert trace.pack_state.launches == before + 1
    assert out_k[4] == out_p[4]
    for name, a, b in zip(("fstate", "ustate", "scal", "vpr", "geom", "key"), out_k, out_p):
        if name != "geom":
            bad = (_bits(a) != _bits(b)).reshape(a.shape[0], -1).any(dim=0)
            assert not bool(bad.any()), f"{name}: {int(bad.sum())} lanes differ"
    return out_k


PACK_CASES = {
    # name: (scene, backend, width, height, pack_state keywords)
    "grid_m1": ("book", "grid", 128, 72, dict(pixels_per_lane=1)),
    "grid_m2": ("book", "grid", 1920, 1080, dict(pixels_per_lane=2)),
    "grid_m16": ("book", "grid", 256, 144, dict(pixels_per_lane=16)),
    "grid_m1_passign": ("book", "grid", 128, 72, dict(pixels_per_lane=1, passign=True)),
    "grid_m2_passign": ("book", "grid", 1920, 1080, dict(pixels_per_lane=2, passign=True)),
    # the 1-spp frame's call: 65 merged calls of 1 spp under its M = 16 table
    "grid_m16_frame": ("book", "grid", 1920, 1080, dict(pixels_per_lane=16, passign=True,
                                                        spp=1, n_calls=65, spp_last=1)),
    "grid_band_offset_spp0": ("book", "grid", 200, 40, dict(y0=24, seed_y0=24, offset_x=56,
                                                            spp=0, pixels_per_lane=2)),
    "paged_m2": ("field2000", "paged", 128, 72, dict(pixels_per_lane=2)),
    "paged_m31_field4k": ("field100k", "paged", 3840, 2160, dict(pixels_per_lane=31)),
    "paged_band_offset": ("field2000", "paged", 200, 40, dict(y0=24, seed_y0=24,
                                                              offset_x=56, pixels_per_lane=3)),
    "mega_m2_accum": ("book", "mega", 128, 72, dict(pixels_per_lane=2, accum_init=True)),
    "mega_m16_accum": ("three", "mega", 256, 144, dict(pixels_per_lane=16, accum_init=True)),
}
PACK_SCENES = {
    "book": lambda: generate_random_scene(0.0),
    "three": three_sphere_scene,
    "field2000": lambda: random_sphere_field(2000, seed=1, extent=7.0),
    "field100k": lambda: random_sphere_field(100_000),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(PACK_CASES))
def test_pack_state_kernel_matches_plain(cuda, name):
    """The band set-up kernel == ``pack_state_plain`` on every lane and row:
    grid with and without a balanced table at M = 1, 2 and 16 (the 1-spp
    frame's merged call and table included), paged at the field's 4K M = 31
    and at M = 2 with the first sort key, mega with a carried accumulator,
    and a band below the top with an x offset and no samples."""
    from raytrace_tpu_torch.runtime.balance import build_passign

    scene, backend, w, h, extra = PACK_CASES[name]
    ds = trace.device_scene_from_numpy(trace.prepare_scene(PACK_SCENES[scene]()), cuda)
    kw = dict(extra)
    m = kw["pixels_per_lane"]
    if kw.pop("passign", False):
        cost = torch.rand(w * h, generator=torch.Generator().manual_seed(m)).numpy()
        kw["passign"] = torch.from_numpy(build_passign(cost, m, trace.LANE_PAD)).to(cuda)
    if kw.pop("accum_init", False):
        kw["accum_init"] = torch.rand((h, w, 3), device=cuda)
    f, u, *_ = _pack_pair(ds, backend, w, h, **kw)
    n_alive = int(u[megakernel.U_ALIVE].sum())  # the row of every layout
    assert n_alive == (0 if kw.get("spp", 2) == 0 else -(-w * h // m))


# 50 frame times: the ends of the cell's 600-s range and 48 frames of 1/60 s
FIELD_TIMES = (0.0, 599.983) + tuple(317.41 + i / 60 for i in range(48))


def _field100k(t=0.0, kind="plain"):
    sc = random_sphere_field(100_000, seed=0, extent=50.0, t=t,
                             y_range=(0.1, 2.0) if kind == "heights" else None)
    if kind == "textured":
        sc.texture[4::3] = CHECKERED
        sc.color1[4::3] = (0.9, 0.2, 0.4)
    return sc


def _same_bits(a, b):
    if a is None or b is None:
        return a is None and b is None
    a, b = torch.as_tensor(a).to(b.device), b
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("t", FIELD_TIMES)
def test_the_field_prepared_on_the_card_equals_the_host_scene(cuda, t):
    """``prepare_scene_device`` (the animated field's route) == the host's
    ``prepare_scene`` uploaded, field by field and byte for byte: CUDA's
    float32 divisions and reductions fix the same lattice as the CPU's."""
    scene = _field100k(t)
    want = trace.device_scene_from_numpy(trace.prepare_scene(scene), cuda)
    got = trace.prepare_scene_device(trace.scene_to_device(scene, cuda)[0])
    assert got.paged is not None
    for f in trace.DeviceScene._fields:
        a, b = getattr(want, f), getattr(got, f)
        if f == "paged":
            for g in type(a)._fields:
                assert _same_bits(getattr(a, g), getattr(b, g)), g
        else:
            assert _same_bits(a, b), f


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["hot", "textured", "heights"])
def test_paged_tables_built_on_the_card_equal_the_cpu_build(cuda, kind):
    scene = _field100k(2.5, kind)
    kw = {"hot_slots": -1} if kind == "hot" else {}
    want = build_paged_grid(scene, intersect.sphere_table(scene), **kw)
    on = trace.scene_to_device(scene, cuda)[0]
    got = build_paged_grid(on, intersect.sphere_table_device(on)[0], **kw)
    assert want is not None and got is not None
    assert (got.govf is not None) == (kind == "hot")
    assert (got.has_tex is not None) == (kind == "textured")
    assert (got.has_cy is not None) == (kind == "heights")
    for g in type(want)._fields:
        assert _same_bits(getattr(want, g), getattr(got, g)), g


def _waits(fn):
    """(fn's result, the times the host waited for the card inside it, the
    warnings caught), the waits as CUDA's sync debug mode reports them."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    said = [str(w.message) for w in caught]
    return out, sum(m.startswith("called a synchronizing CUDA operation") for m in said), said


@pytest.mark.gpu
@pytest.mark.parametrize("hot", [None, -1], ids=["whole", "split"])
def test_the_paged_build_counts_every_wait(cuda, hot):
    on = trace.scene_to_device(_field100k(1.0), cuda)[0]
    table = intersect.sphere_table_device(on)[0]
    _waits(lambda: build_paged_grid(on, table, hot_slots=hot))  # warm-up, the mode's too
    stats = {}
    _, waits, said = _waits(lambda: build_paged_grid(on, table, hot_slots=hot, stats=stats))
    assert waits == stats["syncs"] == (6 if hot == -1 else 5), said


@pytest.mark.gpu
def test_a_frames_set_scene_waits_only_for_the_build(cuda):
    """A frame's scene swap of the 100k field: the scene's arrays go up
    without a wait and the host waits only for the build's five reads."""
    r = Renderer(RenderConfig(samples=1, width=64, height=32, max_depth=4, backend="auto"),
                 scene=_field100k(0.0), device=cuda)
    r.set_scene(_field100k(1 / 60))
    scene = _field100k(2 / 60)
    _, waits, said = _waits(lambda: r.set_scene(scene))
    assert r.backend == "paged" and waits == 5, said
