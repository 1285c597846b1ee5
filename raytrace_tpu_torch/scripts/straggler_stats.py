"""Per-pixel wavefront cost distribution and a lane-assignment simulation.

Port of ``scripts/straggler_stats.py``.  The wavefront's wall is set by its
most expensive lane, and per-pixel costs are heavy-tailed (glass interiors
run toward the depth-50 cap while sky pixels cost ~1), so lane sums over M
statically assigned pixels have a fat right tail.

This measures each sampled pixel's iteration cost by replaying the grid
kernel's iterations-per-segment rule, max(1, cells marched), over the CPU
oracle's paths (``oracle_paths``: the exact RNG streams, ``_closest_hit``
hooked), then simulates lane totals from that cost distribution for M = 16,
32, 64 and 128 under a random deal ("shuffled") and greedy
longest-processing-time binning ("LPT bound", what a cost-feedback
assignment could reach), and prints max/mean lane cost, the wavefront's
utilization ceiling.  The numbers are the JAX script's for the same
arguments.  Numpy on the host; no kernel runs.

Run ``python -m raytrace_tpu_torch.scripts.straggler_stats [n_pixels]
[spp] [--device cpu]`` (3000 pixels, 4 spp): the numbers come from the
host either way, but without ``--device cpu`` it wants the card, as every
entry point of the port does, and raises without one.
"""

from __future__ import annotations

import numpy as np

from . import oracle_paths as op


def main(argv=None) -> dict:
    """Run the study; returns the per-pixel costs and the simulation's
    {M: (shuffled, LPT bound)} max/mean."""
    from ..oracle import cpu_reference as orc

    n_px, spp, device = op.parse("straggler_stats", __doc__, argv, 3000, 4)
    march = op.BookMarch()
    cam = op.Camera()
    sc = march.scene
    counter = {"iters": 0}
    orig = orc._closest_hit

    def hooked(scene, o, d, tmin, tmax):
        counter["iters"] += max(1, march.segment_cells(o, d))
        return orig(scene, o, d, tmin, tmax)

    orc._closest_hit = hooked
    rng = np.random.default_rng(0)
    pix = rng.choice(op.W * op.H, size=n_px, replace=False)
    cost = np.zeros(n_px)
    try:
        for j, p in enumerate(pix):
            px, py = int(p % op.W), int(p // op.W)
            seed = cam.seed(px, py)
            counter["iters"] = 0
            for _s in range(spp):
                seed, d = cam.sample(seed, px, py)
                seed, _c = orc._ray_color(sc, cam.origin, d, seed, 50)
            cost[j] = counter["iters"] / spp
            if (j + 1) % 500 == 0:
                print(f"{j+1}/{n_px} pixels...", flush=True)
    finally:
        orc._closest_hit = orig

    q = np.percentile(cost, [50, 90, 99, 99.9])
    print(f"\nper-pixel iterations/sample: mean {cost.mean():.2f}  "
          f"p50 {q[0]:.1f}  p90 {q[1]:.1f}  p99 {q[2]:.1f}  p99.9 {q[3]:.1f}  "
          f"max {cost.max():.1f}")

    # lane totals drawn iid from the measured cost distribution (the
    # strided map's spatial decorrelation makes this a good model)
    sim = np.random.default_rng(1)
    ratios = {}
    for m in (16, 32, 64, 128):
        n_lanes = 2048
        draws = sim.choice(cost, size=(n_lanes, m), replace=True).sum(axis=1)
        shuf = draws.max() / draws.mean()
        # LPT bound: perfect-knowledge binning of the same pixel pool
        pool = np.sort(sim.choice(cost, size=n_lanes * m, replace=True))[::-1]
        bins = np.zeros(n_lanes)
        for c in pool:  # greedy into the least-loaded bin
            bins[np.argmin(bins)] += c
        lpt = bins.max() / bins.mean()
        ratios[m] = (float(shuf), float(lpt))
        print(f"M={m:<4} shuffled max/mean {shuf:.3f}   LPT bound {lpt:.3f}")
    print(op.host_label(device), flush=True)
    return {"cost": cost, "max_over_mean": ratios}


if __name__ == "__main__":
    main()
