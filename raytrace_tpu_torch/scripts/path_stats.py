"""Oracle path statistics: segments per sample and DDA cells per segment.

Port of ``scripts/path_stats.py``: the useful-work floor of the book scene
(segments per sample, and grid cells marched per segment: the globals pass
prunes the march to zero cells for many segments).  It runs the CPU oracle
over randomly drawn pixels of the 1920x1080 frame with the exact reference
RNG streams, hooks ``_closest_hit`` to count segments, and replays the grid
kernel's march-length rule per segment (``oracle_paths``; an upper bound:
it ignores the pruning by grid hits, which only shortens it).  It prints
the JAX script's numbers for the same arguments.  Numpy on the host; no
kernel runs.

Run ``python -m raytrace_tpu_torch.scripts.path_stats [n_pixels] [spp]
[--device cpu]`` (400 pixels, 1 spp): the numbers come from the host either
way, but without ``--device cpu`` it wants the card, as every entry point
of the port does, and raises without one.
"""

from __future__ import annotations

import numpy as np

from . import oracle_paths as op


def main(argv=None) -> dict:
    """Run the study; returns the counts {segments, cells, samples}."""
    from ..oracle import cpu_reference as orc

    n_px, spp, device = op.parse("path_stats", __doc__, argv, 400, 1)
    march = op.BookMarch()
    cam = op.Camera()
    sc = march.scene
    stats = {"segments": 0, "cells": 0, "samples": 0}
    orig = orc._closest_hit

    def hooked(scene, o, d, tmin, tmax):
        stats["segments"] += 1
        stats["cells"] += march.segment_cells(o, d)
        return orig(scene, o, d, tmin, tmax)

    orc._closest_hit = hooked
    try:
        rng = np.random.default_rng(0)
        for _ in range(n_px):
            px = int(rng.integers(0, op.W))
            py = int(rng.integers(0, op.H))
            seed = cam.seed(px, py)
            for _s in range(spp):
                seed, d = cam.sample(seed, px, py)
                seed, _c = orc._ray_color(sc, cam.origin, d, seed, 50)
                stats["samples"] += 1
    finally:
        orc._closest_hit = orig

    print(stats)
    print("segments/sample: %.2f   cells/segment: %.2f" % (
        stats["segments"] / stats["samples"],
        stats["cells"] / max(stats["segments"], 1)))
    print(op.host_label(device), flush=True)
    return stats


if __name__ == "__main__":
    main()
