"""Fixed-iteration per-section cost attribution for the paged kernel.

Port of ``scripts/paged_iterbench.py`` (100k-sphere field).  A short real
warm-up -- fresh rays at M pixels per lane, one production launch, the
port's own re-bucket (the driver's Morton key, ``trace._rebucket_key``, as
the kernel's epilogue writes it: the live lanes sorted by page and
gathered), another launch -- gives a mid-flight state; then the paged
kernel's ``freeze`` switch pins the march (the advance is discarded, so a
marching lane marches forever) and makes every live lane run every section
each iteration, and each ``cut_*`` variant removes one section (a
passthrough of live values; the image is invalid), so every variant runs
the same iterations on the same lanes at realistic page spreads.  The
page-spread lines are the JAX script's, over chunks of 128 lanes (a warp
is 32 of them).

Each variant's library is built before anything is timed (one nvcc each,
all at once); a round runs ``INVOKES`` launches of ``K_STEPS`` iterations
in a host loop, each launch's state the last one's output, ended by one
device sync (host clock); the rounds go in turns and the medians print
beside each variant's registers, stack frame, spills and SASS count, and
the spread of its launches (CUDA events).

Run ``[N_SPHERES=100000] [INVOKES=60] [ROUNDS=5] [VARIANTS=...] python -m
raytrace_tpu_torch.scripts.paged_iterbench [--device cpu]``: on the GPU
unless given ``--device cpu`` (it raises without one).  ``W``, ``H`` and
``M`` are the module's (1920x1080, 64).  ``CARRY=0`` (the JAX script's
legacy attribute resolve) is not in the port and raises.  Every timing
line names the card and its power limit (``nvidia-smi``), or the CPU.
"""

from __future__ import annotations

import os

W, H, M = 1920, 1080, 64
VARIANTS = ("base,cut_fetch,cut_resolve,cut_quad,cut_shade,cut_globals,cut_init,"
            "cut_tea,cut_camera,cut_gsel")
SPP = 1_000_000  # samples per pixel of the state: its lanes never run out


def main(argv=None) -> dict:
    """Run the attribution; returns {variant: median seconds}."""
    import numpy as np

    from ..models.paged_grid import P_NSCZM
    from ..models.scene import random_sphere_field
    from ..ops import pagedkernel as pk
    from ..ops import trace
    from ..runtime.renderer import reference_camera
    from . import probe_runs as pr

    if os.environ.get("CARRY", "1") == "0":
        raise NotImplementedError("CARRY=0 (the legacy attribute resolve) is not ported: "
                                  "ROADMAP, 'Not ported, by design'")
    device, card, _ = pr.parse("paged_iterbench", __doc__, argv)
    n_spheres = int(os.environ.get("N_SPHERES", 100_000))
    invokes = int(os.environ.get("INVOKES", 60))
    rounds = int(os.environ.get("ROUNDS", 5))
    variants = os.environ.get("VARIANTS", VARIANTS).split(",")
    sets = pr.variant_sets(variants, always=("freeze",))

    ds = trace.device_scene_from_numpy(trace.prepare_scene(random_sphere_field(n_spheres)),
                                       device)
    g = ds.paged
    if g is None:
        raise RuntimeError("the scene must build a paged grid")
    five, textured, n_slots, _, _, ab = pk.layout(g)
    vp = trace.viewport_arrays(reference_camera(), W, H)
    f, u, scal, vpr, geom = trace.pack_state(
        ds, vp, backend="paged", band_h=H, width=W, y0=0, seed_y0=0, offset_x=0, spp=SPP,
        number=0, pixels_per_lane=M)
    print(f"pages={g.geom.shape[0]} n_slots={n_slots} ab={ab} lanes={geom['n_lanes']} "
          f"pad={f.shape[1]}", flush=True)
    acc = trace.home_accum(None, geom["p_total"], device)
    kw = dict(geom, max_depth=50, skip_tmax=True, k_steps=pk.K_STEPS)

    # the warm-up: a launch, the driver's re-bucket, a launch
    f, u, key = pk.paged_megakernel_step(scal, vpr, g, f, u, acc, **kw)
    f, u = trace.gather_lanes(f, u, trace.live_order(key))
    f0, u0, _ = pk.paged_megakernel_step(scal, vpr, g, f, u, acc, **kw)
    march = (u0[pk.U_MARCH] != 0).cpu().numpy()
    cell = u0[pk.U_CELL].cpu().numpy().astype(np.int64)
    nsczm = int(g.gscal.reshape(-1)[P_NSCZM])
    sx, sz = (cell >> 12) >> 3, (cell & 4095) >> 4  # the kernel's 8x16 pages
    page = sx * nsczm + sz
    spreads, boxes = [], []
    for c in range(-(-len(cell) // 128)):
        sl = slice(c * 128, (c + 1) * 128)
        mm = march[sl]
        spreads.append(int(page[sl][mm].max() - page[sl][mm].min() + 1) if mm.any() else 0)
        boxes.append(int((sx[sl][mm].max() - sx[sl][mm].min() + 1)
                         * (sz[sl][mm].max() - sz[sl][mm].min() + 1)) if mm.any() else 0)
    spreads, boxes = np.array(spreads), np.array(boxes)
    print(f"marching {int(march.sum())}/{len(march)}; per-chunk LINEAR page spread: "
          f"mean {spreads.mean():.1f} p50 {np.percentile(spreads, 50):.0f} "
          f"p90 {np.percentile(spreads, 90):.0f} max {spreads.max()}", flush=True)
    print(f"per-chunk 2-D BOX of pages: mean {boxes.mean():.1f} p50 "
          f"{np.percentile(boxes, 50):.0f} p90 {np.percentile(boxes, 90):.0f} max "
          f"{boxes.max()} ({card})", flush=True)

    masks = {v: pk.switch_mask(s, pk.SWITCHES, "paged") for v, s in sets.items()}
    reps = pr.compiled(device, "paged", sorted(set(masks.values())),
                       pr.paged_instance(five, textured))

    def step(fs, us, a, switches):
        return pk.paged_megakernel_step(scal, vpr, g, fs, us, a, ablate=switches, **kw)[:2]

    times, spread = pr.launch_rounds(step, f0, u0, acc, sets, rounds, invokes, device)
    text = {v: pr.compiled_text(reps.get(masks[v]), None if v == "base" else
                                reps.get(masks["base"])) + "; " + spread[v] for v in variants}
    iters = invokes * pk.K_STEPS
    tiles = -(-f0.shape[1] // trace.LANE_PAD)
    return pr.medians(times, text, card,
                      lambda t: f"{t / (iters * tiles) * 1e6:.4f} us per tile-iteration, "
                                f"{tiles} tiles x {iters} iterations")


if __name__ == "__main__":
    main()
