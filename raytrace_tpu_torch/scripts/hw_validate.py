"""Card validation of the grid and paged kernels' general layouts, and a
book-scene timing probe.

Port of ``scripts/hw_validate.py``: its seven blocks at its scenes and
sizes, each rendered with ``render_band`` on the card (the grid, paged and
brute-force kernels) or with the kernels' plain versions on the CPU:

1. the book scene (4-value cells) at 1920x1080 x 400 spp on the grid
   kernel, timed;
2. a 250-sphere field at varied heights (the 5-value cell layout), grid vs
   brute force at 640x360 x 64 spp, timed;
3. a 20,000-sphere varied field (the paged 5-value layout), paged vs brute
   force at 640x360 x 8 spp, timed;
4. a 60-sphere field with checkered field spheres (the grid's ``ttab``),
   grid vs brute force at 8 spp;
5. the 20,000-sphere varied field with checkered spheres (paged
   ``has_tex``), paged vs brute force at 4 spp;
6. the book scene's grid at pitch 2 vs pitch 1 at 16 spp;
7. the balanced pixel->lane table vs the strided map at 16 spp, fast.

The JAX script only prints how many pixels differ.  This one holds:

- on one-sample calls (every layout of blocks 1-5): grid == brute force
  and paged == brute force bit for bit.  Within a sample both run the
  same f32 operations in the same order; only the sum over samples may be
  grouped differently (the brute-force kernel adds ``(acc + s1) + s2``,
  the grid path ``acc + (s1 + s2)``);
- pitch 2 == pitch 1 and balanced == strided bit for bit at the script's
  spp (the same kernel on the same samples in the same order).

It raises at the first of them that fails.  At the script's spp it prints
each comparison's share of differing pixels, the relative difference of
the image means and the largest relative difference of a pixel value.
Times are host-clock walls of one ``render_band`` ended by copying the
image to the host; every timing line names the card and its power limit
(``nvidia-smi``), or the CPU.

Run ``python -m raytrace_tpu_torch.scripts.hw_validate [--device cpu]``: on
the GPU unless given ``--device cpu`` (it raises without one).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

# the JAX script's images (the book probe's and the others'), their pixels
# per lane, and spp
BOOK_W, BOOK_H, BOOK_M = 1920, 1080, 64
W, H, M = 640, 360, 16
BOOK_SPP, VARIED_SPP, PAGED_SPP, TTAB_SPP, PAGED_TEX_SPP, PITCH_SPP, BALANCE_SPP = (
    400, 64, 8, 8, 4, 16, 16)
# the fields: the varied grid field, the paged fields, the textured grid field
VARIED = dict(count=250, seed=3, extent=11.0, y_range=(0.2, 2.5))
PAGED = dict(count=20_000, seed=1, extent=25.0, y_range=(0.2, 2.0))
TTAB = dict(count=60, seed=3, extent=8.0)


def varied_field():
    """Block 2's scene: 250 spheres at varied heights (the 5-value grid
    layout)."""
    from ..models.scene import random_sphere_field

    return random_sphere_field(**VARIED)


def ttab_field():
    """Block 4's scene: the 60-sphere field with spheres 10-19 checkered
    (the grid's ``ttab``)."""
    from ..models.scene import CHECKERED, random_sphere_field

    sct = random_sphere_field(**TTAB)
    sct.texture[10:20] = CHECKERED
    sct.color1[10:20] = (0.9, 0.1, 0.1)
    return sct


def paged_field(textured=False):
    """Blocks 3 and 5: the 20,000-sphere varied field (the paged 5-value
    layout), with spheres 50-499 checkered when ``textured`` (paged
    ``has_tex``)."""
    from ..models.scene import CHECKERED, random_sphere_field

    sp = random_sphere_field(**PAGED)
    if textured:
        sp.texture[50:500] = CHECKERED
        sp.color1[50:500] = (0.9, 0.2, 0.1)
    return sp


def diff_stats(a, b) -> dict:
    """Share of pixels differing in any channel, relative difference of the
    means and the largest relative difference of one value."""
    d = np.abs(a - b)
    scale = np.maximum(np.abs(a), np.abs(b))
    rel = np.where(scale > 0, d / np.where(scale > 0, scale, 1), 0)
    return {"frac": float((d.max(axis=2) > 0).mean()),
            "mean_rel": float(abs(a.mean() - b.mean()) / abs(a.mean())),
            "max_rel": float(rel.max()),
            "px": int((d.max(axis=2) > 0).sum())}


def main(argv=None) -> dict:
    """Run the blocks; returns {"one_sample": {layout: differing px},
    "spp": {layout: diff_stats}, "pitch2_px", "balanced_px", "times":
    {label: seconds}}."""
    from ..models.grid import build_grid
    from ..models.scene import generate_random_scene
    from ..ops.intersect import sphere_table
    from ..ops.trace import (LANE_PAD, device_scene_from_numpy, prepare_scene,
                             render_band, viewport_arrays)
    from ..runtime.balance import build_passign, measure_cost_map
    from ..runtime.renderer import reference_camera, render_device
    from .bench_gather import card_label

    ap = argparse.ArgumentParser(prog="python -m raytrace_tpu_torch.scripts.hw_validate",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = render_device(args.device)
    card = card_label(device)
    cam = reference_camera()
    vps = {(w, h): viewport_arrays(cam, w, h) for w, h in ((W, H), (BOOK_W, BOOK_H))}
    out = {"one_sample": {}, "spp": {}, "times": {}}

    def to_dev(host):
        return device_scene_from_numpy(host, device)

    def render(ds, backend, w, h, spp, m=M, **kw):
        t0 = time.perf_counter()
        img = render_band(ds, vps[(w, h)], band_h=h, width=w, y0=0, seed_y0=0,
                          offset_x=0, spp=spp, number=0, max_depth=50, backend=backend,
                          pixels_per_lane=m, skip_tmax=True, **kw).cpu().numpy()
        return img, time.perf_counter() - t0

    def one_sample(label, ds, backend, w, h, m=M):
        """``backend`` == brute force bit for bit on a one-sample call."""
        a, _ = render(ds, "mega", w, h, 1, m)
        b, _ = render(ds, backend, w, h, 1, m)
        n = diff_stats(a, b)["px"]
        out["one_sample"][label] = n
        print(f"{label} 1 spp: {backend} vs mega {n}/{w*h} px differ", flush=True)
        if n or not np.array_equal(a, b):
            raise RuntimeError(f"{label}: {backend} != mega on a one-sample call "
                               f"({n} px differ)")

    def versus(label, backend, a, b, ta=None, tb=None, ns=None):
        """Print mega's image ``a`` against ``backend``'s ``b`` (and their
        times over ``ns`` samples)."""
        st = out["spp"][label] = diff_stats(a, b)
        times = ""
        if ta is not None:
            times = (f"mega {ta:.3f}s ({ta/ns*1e9:.1f} ns/s)  {backend} "
                     f"{tb:.3f}s ({tb/ns*1e9:.1f} ns/s)  ")
        print(f"{label} {times}diff-frac {st['frac']:.5f}  mean-rel {st['mean_rel']:.2e}  "
              f"max-rel {st['max_rel']:.2e} ({card})", flush=True)

    # 1) the book scene, the 4-value grid layout
    book_sc = generate_random_scene(0.0)
    book_host = prepare_scene(book_sc)
    book = to_dev(book_host)
    render(book, "grid", BOOK_W, BOOK_H, 4, m=BOOK_M)  # warm
    _, t = render(book, "grid", BOOK_W, BOOK_H, BOOK_SPP, m=BOOK_M)
    out["times"]["book grid"] = t
    print(f"book grid {BOOK_SPP}spp: {t:.3f}s  "
          f"{t/(BOOK_W*BOOK_H*BOOK_SPP)*1e9:.3f} ns/sample ({card})", flush=True)
    one_sample("book grid", book, "grid", BOOK_W, BOOK_H, m=BOOK_M)

    # 2) varied-height grid (the 5-value layout) vs mega
    host = prepare_scene(varied_field())
    if host.grid is None or host.grid.has_cy is None:
        raise RuntimeError("the varied field did not build the 5-value grid layout")
    ds = to_dev(host)
    print("varied grid n_slots:", host.grid.has_cy.shape[1], flush=True)
    one_sample("varied grid", ds, "grid", W, H)
    for be in ("mega", "grid"):
        render(ds, be, W, H, 4)  # warm
    a, ta = render(ds, "mega", W, H, VARIED_SPP)
    b, tb = render(ds, "grid", W, H, VARIED_SPP)
    versus("varied grid", "grid", a, b, ta, tb, W * H * VARIED_SPP)

    # 3) paged five layout vs mega (dense varied field)
    host = prepare_scene(paged_field())
    if host.paged is None or host.paged.has_cy is None:
        raise RuntimeError("the dense varied field did not build the paged 5-value layout")
    dp = to_dev(host)
    one_sample("paged-varied paged", dp, "paged", W, H)
    for be in ("mega", "paged"):
        render(dp, be, W, H, 2)  # warm
    a, ta = render(dp, "mega", W, H, PAGED_SPP)
    b, tb = render(dp, "paged", W, H, PAGED_SPP)
    versus("paged-varied paged", "paged", a, b, ta, tb, W * H * PAGED_SPP)
    print("HW VALIDATION DONE", flush=True)

    # 4) textured field spheres (the grid's ttab)
    host = prepare_scene(ttab_field())
    if host.grid is None or host.grid.ttab is None:
        raise RuntimeError("the textured field did not build the grid's ttab")
    dt = to_dev(host)
    one_sample("ttab grid", dt, "grid", W, H)
    a, _ = render(dt, "mega", W, H, TTAB_SPP)
    b, _ = render(dt, "grid", W, H, TTAB_SPP)
    versus("ttab grid", "grid", a, b)

    # 5) textured + varied paged (has_tex)
    host = prepare_scene(paged_field(textured=True))
    if host.paged is None or host.paged.has_tex is None:
        raise RuntimeError("the textured dense field did not build the paged has_tex layout")
    dpt = to_dev(host)
    one_sample("paged-tex paged", dpt, "paged", W, H)
    a, _ = render(dpt, "mega", W, H, PAGED_TEX_SPP)
    b, _ = render(dpt, "paged", W, H, PAGED_TEX_SPP)
    versus("paged-tex paged", "paged", a, b)
    print("HW VALIDATION (EXTENDED) DONE", flush=True)

    # 6) pitch 2 (8-slot 4-value cells) must equal pitch 1 bit for bit
    g2 = build_grid(book_sc, sphere_table(book_sc), pitch=2.0)
    ds_p2 = to_dev(book_host._replace(grid=g2))
    a, _ = render(book, "grid", W, H, PITCH_SPP)
    b, _ = render(ds_p2, "grid", W, H, PITCH_SPP)
    n = out["pitch2_px"] = diff_stats(a, b)["px"]
    print(f"pitch2 grid-vs-pitch1 differing px: {n} / {W * H}", flush=True)
    if n or not np.array_equal(a, b):
        raise RuntimeError(f"pitch 2 renders another image than pitch 1 ({n} px)")
    print("HW VALIDATION (PITCH) DONE", flush=True)

    # 7) the balanced pixel->lane table must match the strided map bit for
    #    bit (an assignment moves no sample between pixels)
    kwb = dict(scene=book, vp=vps[(W, H)], band_h=H, width=W, y0=0, seed_y0=0,
               offset_x=0, spp=BALANCE_SPP, number=0, max_depth=50, backend="grid",
               pixels_per_lane=M, skip_tmax=True, rr=(1, 16, 0.05))
    cost = measure_cost_map(kwb, 8)
    tab = build_passign(cost, M, LANE_PAD)
    a = render_band(**kwb).cpu().numpy()
    b = render_band(**kwb, passign=tab).cpu().numpy()
    n = out["balanced_px"] = diff_stats(a, b)["px"]
    print(f"balanced-vs-strided diff px: {n} / {W * H}", flush=True)
    if n or not np.array_equal(a, b):
        raise RuntimeError(f"the balanced table renders another image ({n} px)")
    print("HW VALIDATION (BALANCE) DONE", flush=True)
    return out


if __name__ == "__main__":
    main()
