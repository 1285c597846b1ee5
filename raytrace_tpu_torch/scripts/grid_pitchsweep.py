"""Grid cell-pitch sweep on the card (interleaved rounds, medians).

Port of ``scripts/grid_pitchsweep.py``.  Coarser cells trade DDA march
steps for more candidate quadratics per cell.  Each pitch's grid is
``models/grid.build_grid(scene, table, pitch=p, max_slots=16)`` on the book
scene (a pitch above ~2 needs more than 8 slots); a pitch whose grid does
not build prints "does not build (skipped)" and is left out, never rendered
on another backend.  Every pitch must render the same image bit for bit
(the delta-enlarged registration makes the winner set pitch-independent):
the script raises if one differs.

Each variant is a (pitch, J) pair; J (DDA cells per wavefront iteration)
and K (iterations per launch) are the grid kernel's module values
``gridkernel.J_STEPS`` / ``K_STEPS``, set for each render and restored
after.  Times are host-clock walls of one ``render_band`` of the whole
image ended by copying it to the host.  The per-iteration figures come
from ``render_band``'s ``return_iters``, which counts only the live lanes
it launches, in blocks of 128 (``trace.LANE_PAD``):

  us/tile-iter   the median wall over the tile iterations, one tile
                 iteration being one iteration of one 128-lane block
  issued/sample  the lane slots those iterations issued (tile iterations
                 x 128) over width x height x spp

Every timing line names the card and its power limit (``nvidia-smi``), or
the CPU.

Run ``[PITCHES=1.0,1.5,2.0,3.0] [SWEEP_W=1920] [SWEEP_H=1080]
[SWEEP_SPP=400] [SWEEP_ROUNDS=5] [SWEEP_J=2] [SWEEP_K=40] [SWEEP_M=64]
python -m raytrace_tpu_torch.scripts.grid_pitchsweep [--device cpu]``, or
``VARIANTS=1.0:2,2.0:1,2.0:2`` (explicit pitch:J pairs) in place of
PITCHES: on the GPU unless given ``--device cpu`` (it raises without one).
The card's operating point is SWEEP_M=2.
"""

from __future__ import annotations

import argparse
import os
import statistics
import time

# the JAX script's pitches, the slot cap every pitch's grid is built with,
# and its spp
PITCHES, MAX_SLOTS, SPP = "1.0,1.5,2.0,3.0", 16, 400


def main(argv=None) -> dict:
    """Run the sweep; returns {(pitch, J): median seconds}."""
    import numpy as np

    from ..models.grid import build_grid
    from ..models.scene import generate_random_scene
    from ..ops import gridkernel as gk
    from ..ops.intersect import sphere_table
    from ..ops.trace import device_scene_from_numpy, prepare_scene, render_band, viewport_arrays
    from ..runtime.renderer import reference_camera, render_device
    from .bench_gather import card_label

    ap = argparse.ArgumentParser(prog="python -m raytrace_tpu_torch.scripts.grid_pitchsweep",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = render_device(args.device)
    w = int(os.environ.get("SWEEP_W", 1920))
    h = int(os.environ.get("SWEEP_H", 1080))
    spp = int(os.environ.get("SWEEP_SPP", SPP))
    rounds = int(os.environ.get("SWEEP_ROUNDS", 5))
    j_default = int(os.environ.get("SWEEP_J", 2))
    k = int(os.environ.get("SWEEP_K", 40))
    m = int(os.environ.get("SWEEP_M", 64))
    if "VARIANTS" in os.environ:
        pairs = [(float(v.split(":")[0]), int(v.split(":")[1]))
                 for v in os.environ["VARIANTS"].split(",")]
    else:
        pairs = [(float(p), j_default) for p in
                 os.environ.get("PITCHES", PITCHES).split(",")]
    card = card_label(device)

    sc = generate_random_scene(0.0)
    vp = viewport_arrays(reference_camera(), w, h)
    table = sphere_table(sc)
    host = prepare_scene(sc)

    variants, grids, scenes = {}, {}, {}
    for p, j in pairs:
        if p not in grids:
            grids[p] = build_grid(sc, table, pitch=p, max_slots=MAX_SLOTS)
        g = grids[p]
        if g is None:
            print(f"pitch {p}: does not build (skipped)", flush=True)
            continue
        if p not in scenes:
            scenes[p] = device_scene_from_numpy(host._replace(grid=g), device)
        n_slots = (g.has_cy.shape[1] if g.has_cy is not None
                   else g.slots4.shape[1] if g.slots4 is not None else 4)
        print(f"pitch {p} j {j}: ctab {g.ctab.shape} n_slots {n_slots} "
              f"gtab rows {int((g.gtab[:, 4] >= 0).sum())}", flush=True)
        variants[(p, j)] = scenes[p]

    def run(ds, j):
        j0, k0 = gk.J_STEPS, gk.K_STEPS
        gk.J_STEPS, gk.K_STEPS = j, k
        try:
            acc, (tile_iters, lane_slots) = render_band(
                ds, vp, band_h=h, width=w, y0=0, seed_y0=0, offset_x=0, spp=spp,
                number=0, max_depth=50, backend="grid", pixels_per_lane=m,
                skip_tmax=True, return_iters=True)
            return acc.cpu().numpy(), tile_iters, lane_slots
        finally:
            gk.J_STEPS, gk.K_STEPS = j0, k0

    imgs, meta = {}, {}
    for v, ds in variants.items():
        t0 = time.perf_counter()
        imgs[v], tile_iters, lane_slots = run(ds, v[1])
        meta[v] = (tile_iters, lane_slots)
        print(f"pitch {v}: warm {time.perf_counter()-t0:.3f}s tile-iters={tile_iters} "
              f"({card})", flush=True)
    base_v = min(variants)
    bad = []
    for v in variants:
        same = np.array_equal(imgs[base_v], imgs[v])
        print(f"pitch {v} vs {base_v}: bit-identical={same}", flush=True)
        if not same:
            bad.append(v)
    if bad:
        raise RuntimeError(f"pitches {bad} render another image than {base_v}")

    times = {v: [] for v in variants}
    for rnd in range(rounds):
        for v, ds in variants.items():
            t0 = time.perf_counter()
            run(ds, v[1])
            times[v].append(time.perf_counter() - t0)
        print(f"round {rnd}: " + " ".join(
            f"p{v}={times[v][-1]:.3f}" for v in variants), flush=True)

    samples = w * h * spp
    print()
    med = {}
    for v in variants:
        t = med[v] = statistics.median(times[v])
        tile_iters, lane_slots = meta[v]
        print(f"pitch {v}: {t:6.3f}s  {t/samples*1e9:5.2f} ns/sample  "
              f"{t/max(tile_iters, 1)*1e6:7.4f} us/tile-iter  "
              f"issued/sample {lane_slots/samples:5.2f} ({card})", flush=True)
    return med


if __name__ == "__main__":
    main()
