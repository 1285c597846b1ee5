"""Russian-roulette prize study: the iterations path termination can save.

Port of ``scripts/rr_study.py``.  It replays the grid kernel's
iterations-per-segment rule at J = 2 (``oracle_paths``: the exact RNG
streams, the oracle's scatter math, max(1, ceil(cells marched / 2)) per
segment) under several RR policies and prints each policy's mean, p50, p90,
p99 and max iterations per sample and its mean color: the upper bound of
fast mode's win from path termination alone.

RR policy (the standard unbiased estimator): after a scatter at depth >=
d0, survive with p = min(1, max component of the throughput) (halved past
depth d1, to bound glass paths whose throughput stays ~1); on survival
divide the throughput by p.  The expectation is unchanged.  The numbers are
the JAX script's for the same arguments.  Numpy on the host; no kernel
runs.

Run ``python -m raytrace_tpu_torch.scripts.rr_study [n_pixels] [spp]
[--device cpu]`` (1200 pixels, 4 spp): the numbers come from the host
either way, but without ``--device cpu`` it wants the card, as every entry
point of the port does, and raises without one.
"""

from __future__ import annotations

import numpy as np

from . import oracle_paths as op

POLICIES = [("baseline", None, None), ("rr d0=2", 2, None),
            ("rr d0=3", 3, None), ("rr d0=4", 4, None),
            ("rr d0=2 d1=16", 2, 16), ("rr d0=3 d1=24", 3, 24)]


def _p(refl):
    return min(1.0, float(refl.max()))


def main(argv=None) -> dict:
    """Run the study; returns {policy: (per-pixel iterations per sample,
    mean color)}."""
    n_px, spp, device = op.parse("rr_study", __doc__, argv, 1200, 4)
    march = op.BookMarch()
    cam = op.Camera()
    rng = np.random.default_rng(0)
    pix = rng.choice(op.W * op.H, size=n_px, replace=False)

    cost = {name: np.zeros(n_px) for name, _, _ in POLICIES}
    mean_col = {name: np.zeros(3) for name, _, _ in POLICIES}
    for j, p in enumerate(pix):
        px, py = int(p % op.W), int(p // op.W)
        for name, d0, d1 in POLICIES:
            seed = cam.seed(px, py)
            tot_it = 0
            for _s in range(spp):
                seed, d = cam.sample(seed, px, py)
                seed, col, it = op.ray_color_rr(march, cam.origin, d, seed, 50, d0, d1, _p)
                tot_it += it
                mean_col[name] += col / (n_px * spp)
            cost[name][j] = tot_it / spp
        if (j + 1) % 200 == 0:
            print(f"{j+1}/{n_px} pixels...", flush=True)

    base = cost["baseline"].mean()
    for name, _, _ in POLICIES:
        c = cost[name]
        q = np.percentile(c, [50, 90, 99])
        print(f"{name:<16} mean {c.mean():.3f} ({c.mean()/base:.3f}x)  "
              f"p50 {q[0]:.1f} p90 {q[1]:.1f} p99 {q[2]:.1f} max {c.max():.1f}"
              f"  mean-color {mean_col[name].round(4)}", flush=True)
    print(op.host_label(device), flush=True)
    return {name: (cost[name], mean_col[name]) for name, _, _ in POLICIES}


if __name__ == "__main__":
    main()
