"""The kernels' work count: float32 operations an image needs at the least.

A function of the cell's inputs alone (scene, camera, size, samples per
pixel, depth, mode), the same whichever backend or kernel renders it, and
with no term taken from the program's own tallies.  The plain reference
traces a fixed lattice of pixels at ``PROBE_SPP`` samples (call number 0)
and counts its events; an image's count is its pixel-samples times the
operations one sample needs for those events at their mean rates:

- every sample: its camera ray (``OPS_CAMERA``) and its contribution
  (``OPS_TERM``);
- every segment: the ray's terms a = d.d, o.d, o.o, 1/a (``OPS_RAY``);
- every hit: one ray-sphere test, the winner's (``OPS_TEST``), and the
  cheapest material's shading, diffuse (``OPS_SHADE``);
- every bounce: the direction's normalisation and the throughput
  (``OPS_BOUNCE``).

A square root, a divide and a sine count one operation each; integer work
(the RNG) counts none.  So it is a lower bound: any implementation tests at
least the winning sphere of every hit, and shades at least as dearly as a
diffuse hit.  The reference itself tests every sphere at every segment.
The rates are estimates over the lattice (within a few percent of the
image's); they repeat exactly for the same inputs.  Against the card's
67 TFLOP/s, which counts a fused multiply-add as two operations, a kernel
built with ``--fmad=false`` tops out near half of the bound.
"""

from __future__ import annotations

import numpy as np

PROBE_SPP = 8
LATTICE = (40, 24)  # pixels across, down

OPS_CAMERA = 59  # four draws 8, uv 4, lens 10, origin 12, target 12, direction 3 + 10
OPS_TERM = 6  # throughput x light, added to the pixel
OPS_RAY = 16  # a, o.d, o.o (5 each), 1/a
OPS_TEST = 22  # c.d, c.o (5 each), b, c (3), disc (3), sqrt, two roots (2 each)
OPS_SHADE = 46  # hit point 6, normal 3 + 10, d.n 5, diffuse: three draws 9, unit 10, n + u 3
OPS_BOUNCE = 13  # unit direction 10, throughput 3


def lattice(width: int, height: int) -> np.ndarray:
    """The probe's pixels: a fixed lattice over the image, [n, 2] (x, y)."""
    nx, ny = LATTICE
    xs = ((np.arange(nx) + 0.5) * width / nx).astype(np.int64)
    ys = ((np.arange(ny) + 0.5) * height / ny).astype(np.int64)
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    return np.stack([xx.ravel(), yy.ravel()], axis=1)


def event_rates(scene, vp: dict, width: int, height: int, max_depth: int, rr,
                device="cpu") -> dict:
    """Segments, hits and bounces per sample over the probe lattice."""
    from .reference import tracer

    stats: dict = {}
    pix = lattice(width, height)
    tracer.render_pixels(scene, vp, pix, np.zeros((len(pix), 1), np.int64), [PROBE_SPP],
                         max_depth, rr, device=device, stats=stats)
    n = stats["samples"]
    return {k: stats[k] / n for k in ("segments", "hits", "bounces")}


def ops_per_sample(rates: dict) -> float:
    return (OPS_CAMERA + OPS_TERM + rates["segments"] * OPS_RAY
            + rates["hits"] * (OPS_TEST + OPS_SHADE) + rates["bounces"] * OPS_BOUNCE)


def image_ops(scene, vp: dict, width: int, height: int, spp: int, max_depth: int, rr,
              device="cpu") -> float:
    """Float32 operations one image of ``spp`` samples per pixel needs."""
    rates = event_rates(scene, vp, width, height, max_depth, rr, device=device)
    return float(width * height * spp) * ops_per_sample(rates)
