"""RR policy efficiency study: is fast mode's default policy the best?

Port of ``scripts/rr_efficiency.py``.  Russian roulette trades work for
variance; the honest scalar is the inverse efficiency E[cost] x
Var[estimator] (lower is better): a policy deserves to replace the default
only if it wins on this product, not on time alone (any policy buys time
with variance at a fixed spp).

It replays the oracle per policy (``oracle_paths``: exact GLSL semantics,
the TEA/LCG streams, the J = 2 iteration rule) over a random pixel set and
prints per policy: cost (mean kernel iterations per sample), var (the
per-pixel sample variance, RGB- and pixel-averaged), each relative to the
exact baseline, cost*var normalised to it, and the mean color.  Policies:
exact, the conservative d0=2 point, the shipped fast default (d0=1 d1=16
pmin=.05, p = the throughput's max component), a luminance-weighted p, and
p scaled by 0.8 and 0.6.  The numbers are the JAX script's for the same
arguments.  Numpy on the host; no kernel runs.

Run ``python -m raytrace_tpu_torch.scripts.rr_efficiency [n_pixels] [spp]
[--device cpu]`` (400 pixels, 64 spp): the numbers come from the host
either way, but without ``--device cpu`` it wants the card, as every entry
point of the port does, and raises without one.
"""

from __future__ import annotations

import numpy as np

from . import oracle_paths as op


def p_max(refl):
    return float(refl.max())


def p_lum(refl):
    return float(0.2126 * refl[0] + 0.7152 * refl[1] + 0.0722 * refl[2])


# (name, d0, d1, pmin, prule, pscale)
POLICIES = [
    ("exact", None, None, 0.0, p_max, 1.0),
    ("rr(2,16) max", 2, 16, 0.05, p_max, 1.0),
    ("rr(1,16) max*", 1, 16, 0.05, p_max, 1.0),  # the shipped default
    ("rr(1,16) lum", 1, 16, 0.05, p_lum, 1.0),
    ("rr(1,16) 0.8p", 1, 16, 0.05, p_max, 0.8),
    ("rr(1,16) 0.6p", 1, 16, 0.05, p_max, 0.6),
]


def main(argv=None) -> dict:
    """Run the study; returns {policy: (mean cost, mean variance)}."""
    n_px, spp, device = op.parse("rr_efficiency", __doc__, argv, 400, 64)
    march = op.BookMarch()
    cam = op.Camera()
    rng = np.random.default_rng(0)
    pix = rng.choice(op.W * op.H, size=n_px, replace=False)

    cost = {n: np.zeros(n_px) for n, *_ in POLICIES}
    var = {n: np.zeros(n_px) for n, *_ in POLICIES}
    mean_col = {n: np.zeros(3) for n, *_ in POLICIES}
    for j, p in enumerate(pix):
        px, py = int(p % op.W), int(p // op.W)
        for name, d0, d1, pmin, prule, pscale in POLICIES:
            def p_of(refl, pmin=pmin, prule=prule, pscale=pscale):
                return min(1.0, max(pmin, pscale * prule(refl)))

            seed = cam.seed(px, py)
            tot_it = 0
            cols = np.zeros((spp, 3))
            for s in range(spp):
                seed, d = cam.sample(seed, px, py)
                seed, col, it = op.ray_color_rr(march, cam.origin, d, seed, 50, d0, d1, p_of)
                tot_it += it
                cols[s] = col
            cost[name][j] = tot_it / spp
            var[name][j] = cols.var(axis=0, ddof=1).mean()
            mean_col[name] += cols.mean(axis=0) / n_px
        if (j + 1) % 100 == 0:
            print(f"{j+1}/{n_px} pixels...", flush=True)

    base_c = cost["exact"].mean()
    base_e = base_c * var["exact"].mean()
    print(f"\n{'policy':<16} {'cost':>6} {'rel':>6} {'var':>9} {'rel':>6} "
          f"{'cost*var':>8}  mean-color")
    for name, *_ in POLICIES:
        c, v = cost[name].mean(), var[name].mean()
        print(f"{name:<16} {c:6.3f} {c/base_c:6.3f} {v:9.5f} "
              f"{v/var['exact'].mean():6.3f} {c*v/base_e:8.3f}  "
              f"{mean_col[name].round(4)}", flush=True)
    print(op.host_label(device), flush=True)
    return {name: (float(cost[name].mean()), float(var[name].mean()))
            for name, *_ in POLICIES}


if __name__ == "__main__":
    main()
