"""Fixed-iteration per-section cost attribution for the grid kernel.

Port of ``scripts/grid_iterbench.py``: each ``cut_*`` variant removes one
section of the grid kernel (a passthrough of live values; the image is
invalid), and its time against base over a fixed number of launches
measures that section's serial share of an iteration -- which the additive
duplications of ``grid_ablate`` cannot see, a duplicated section
overlapping its twin.

The JAX script timed dead lanes, because SIMD masking runs the same ops on
them (its docstring: "dead iterations run the same ops").  A dead CUDA lane
copies its state and returns, so on the card that method would time a copy.
This port runs LIVE lanes under the grid kernel's ``freeze`` switch
instead, as ``scripts/paged_iterbench.py`` does for the paged kernel: from
a mid-flight state (the book scene at M pixels per lane, one production
launch of ``K_STEPS`` iterations from fresh rays, the driver's live lanes,
samples that never run out), ``freeze`` pins the march (a cell's advance is
discarded, so a marching lane marches forever) and makes every live lane
run every section each iteration, so every variant runs the same
iterations on the same lanes.  What it measures is each section's serial
cost on a program that does not diverge (every lane takes every section);
the divergence of real renders is what ``grid_ablate`` sees.

Each variant's library is built before anything is timed (one nvcc each,
all at once); a round runs ``INVOKES`` launches of ``K_STEPS`` iterations
in a host loop, each launch's state the last one's output, ended by one
device sync (host clock); the rounds go in turns and the medians print
beside each variant's registers, stack frame, spills and SASS count, and
the spread of its launches (CUDA events).  There is no relay to hide: the
host loop issues launches faster than they run.

Run ``[INVOKES=300] [ROUNDS=5] [VARIANTS=base,cut_fetch,...]
[SWEEP_MODE=fast] [PITCH=1.0] python -m
raytrace_tpu_torch.scripts.grid_iterbench [--device cpu]``: on the GPU
unless given ``--device cpu`` (it raises without one).  ``W``, ``H`` and
``M`` are the module's (1920x1080, 64).  Every timing line names the card
and its power limit (``nvidia-smi``), or the CPU.
"""

from __future__ import annotations

import os

W, H, M = 1920, 1080, 64
VARIANTS = ("base,cut_fetch,cut_resolve,cut_quad,cut_shade,cut_tea,cut_camera,"
            "cut_globals,cut_init")
SPP = 1_000_000  # samples per pixel of the state: its lanes never run out


def main(argv=None) -> dict:
    """Run the attribution; returns {variant: median seconds}."""
    from .. import config as _cfg
    from ..models.scene import generate_random_scene
    from ..ops import gridkernel as gk
    from ..ops import trace
    from ..runtime.renderer import reference_camera
    from . import probe_runs as pr

    device, card, _ = pr.parse("grid_iterbench", __doc__, argv)
    invokes = int(os.environ.get("INVOKES", 300))
    rounds = int(os.environ.get("ROUNDS", 5))
    variants = os.environ.get("VARIANTS", VARIANTS).split(",")
    mode = os.environ.get("SWEEP_MODE", "exact")
    rr = (_cfg.RR_START_DEPTH, _cfg.RR_CAP_DEPTH, _cfg.RR_PMIN) if mode == "fast" else None
    pitch = os.environ.get("PITCH", "1.0")
    sets = pr.variant_sets(variants, always=("freeze",))

    ds = trace.device_scene_from_numpy(
        trace.prepare_scene(generate_random_scene(0.0), grid_pitch=pitch), device)
    vp = trace.viewport_arrays(reference_camera(), W, H)
    f, u, scal, vpr, geom = trace.pack_state(
        ds, vp, backend="grid", band_h=H, width=W, y0=0, seed_y0=0, offset_x=0, spp=SPP,
        number=0, pixels_per_lane=M)
    acc = trace.home_accum(None, geom["p_total"], device)
    kw = dict(geom, max_depth=50, skip_tmax=True, rr=rr, k_steps=gk.K_STEPS,
              j_steps=gk.J_STEPS)
    f, u = gk.grid_megakernel_step(scal, vpr, ds.grid, f, u, acc, **kw)
    f0, u0 = trace.gather_lanes(f, u, trace.live_lanes(u[gk.U_ALIVE]))
    n = f0.shape[1]
    march = int((u0[gk.U_MARCH] != 0).sum())
    print(f"{mode} mode, pitch {pitch}, {W}x{H} at M={M}: {n} live lanes of "
          f"{geom['n_lanes']} after one launch, {march} marching; K={gk.K_STEPS}, "
          f"J={gk.J_STEPS} ({card})", flush=True)

    masks = {v: gk.switch_mask(s) for v, s in sets.items()}
    g = ds.grid
    reps = pr.compiled(device, "grid", sorted(set(masks.values())),
                       pr.grid_instance(bool(g.five), int(g.n_slots)))

    def step(fs, us, a, switches):
        return gk.grid_megakernel_step(scal, vpr, g, fs, us, a, ablate=switches, **kw)

    times, spread = pr.launch_rounds(step, f0, u0, acc, sets, rounds, invokes, device)
    text = {v: pr.compiled_text(reps.get(masks[v]), None if v == "base" else
                                reps.get(masks["base"])) + "; " + spread[v] for v in variants}
    iters = invokes * gk.K_STEPS
    tiles = -(-n // trace.LANE_PAD)
    return pr.medians(times, text, card,
                      lambda t: f"{t / (iters * tiles) * 1e6:.4f} us per tile-iteration, "
                                f"{tiles} tiles x {iters} iterations")


if __name__ == "__main__":
    main()
