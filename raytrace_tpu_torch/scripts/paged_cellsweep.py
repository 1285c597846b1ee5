"""Interleaved cell-size sweep for the paged backend (100k scene).

Port of ``scripts/paged_cellsweep.py``.  Smaller fine cells hold fewer
candidate slots (a cell's table row is n_slots wide) but rays march more
cells per segment; larger cells do the opposite.  ``build_paged_grid`` sizes
cells for ~8 expected candidates each; this sweeps a scale on that size,
``models/paged_grid.CELL_SIZE_SCALE`` (restored to its value after), with
one ``Renderer`` of ``random_sphere_field(100_000)`` per scale.  A scale
``build_paged_grid`` refuses (the scene then resolves to another backend) is
skipped.  Per scale it prints the cell size, n_slots, the geometry pages
and the tables' device megabytes.

Images are not bit-identical across cell sizes in general (the candidate
order within a cell decides which of two exactly-equal-t winners is kept),
so the script reports the share of identical pixels, not a gate.  Times are
host-clock walls of one ``render_call`` ended by copying the accumulator to
the host, in interleaved rounds, medians printed.  Every timing line names
the card and its power limit (``nvidia-smi``), or the CPU.

Run ``[AB_W=1920] [AB_H=1080] [SWEEP_SPP=8] [SWEEP_ROUNDS=7]
[SCALES=0.7,0.85,1.0,1.2] python -m
raytrace_tpu_torch.scripts.paged_cellsweep [--device cpu]``: on the GPU
unless given ``--device cpu`` (it raises without one).
"""

from __future__ import annotations

import argparse
import os
import statistics
import time


def main(argv=None) -> dict:
    """Run the sweep; returns {scale: (median seconds, share of pixels
    identical to the first scale's)}."""
    import numpy as np

    from ..config import RenderConfig
    from ..models import paged_grid as pg
    from ..models.scene import random_sphere_field
    from ..runtime.renderer import Renderer, render_device
    from .bench_gather import card_label

    ap = argparse.ArgumentParser(prog="python -m raytrace_tpu_torch.scripts.paged_cellsweep",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = render_device(args.device)
    w = int(os.environ.get("AB_W", 1920))
    h = int(os.environ.get("AB_H", 1080))
    spp = int(os.environ.get("SWEEP_SPP", 8))
    rounds = int(os.environ.get("SWEEP_ROUNDS", 7))
    scales = [float(f) for f in os.environ.get("SCALES", "0.7,0.85,1.0,1.2").split(",")]
    card = card_label(device)

    scene = random_sphere_field(100_000)
    cfg = RenderConfig(samples=spp, width=w, height=h, backend="auto")

    def mb(*ts):
        return sum(t.numel() * t.element_size() for t in ts) / 2**20

    renderers = {}
    s0 = pg.CELL_SIZE_SCALE
    try:
        for f in scales:
            pg.CELL_SIZE_SCALE = f
            r = Renderer(cfg, scene=scene, device=device)
            if r.backend != "paged":
                print(f"scale={f}: paged grid refused (backend={r.backend}) — skipped",
                      flush=True)
                continue
            g = r.device_scene.paged
            print(f"scale={f}: cell={float(g.gscal[0, 13]):.3f} "
                  f"n_slots={g.lids.shape[1]} geom pages={g.geom.shape[0]} "
                  f"({mb(g.geom, g.lids, g.attrs):.0f} MB)", flush=True)
            renderers[f] = r
    finally:
        pg.CELL_SIZE_SCALE = s0

    imgs = {}
    for f, r in renderers.items():
        t0 = time.perf_counter()
        imgs[f] = r.render_call(spp).cpu().numpy()
        print(f"scale={f}: warm {time.perf_counter()-t0:.3f}s ({card})", flush=True)
    fs = list(renderers)
    agree = {fs[0]: 1.0} if fs else {}
    for f in fs[1:]:
        agree[f] = float((np.abs(imgs[fs[0]] - imgs[f]).max(axis=2) == 0).mean())
        print(f"scale {f} vs {fs[0]}: {agree[f]*100:.2f}% pixels identical", flush=True)

    times = {f: [] for f in renderers}
    for rnd in range(rounds):
        for f, r in renderers.items():
            t0 = time.perf_counter()
            r.render_call(spp).cpu()
            times[f].append(time.perf_counter() - t0)
        print(f"round {rnd}: " + " ".join(f"s{f}={times[f][-1]:.3f}" for f in renderers),
              flush=True)

    med = {}
    for f in renderers:
        t = statistics.median(times[f])
        med[f] = (t, agree[f])
        print(f"scale={f:<5} median {t:.3f}s ({t/(w*h*spp)*1e9:.2f} ns/sample) ({card})",
              flush=True)
    return med


if __name__ == "__main__":
    main()
