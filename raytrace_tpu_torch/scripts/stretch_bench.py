"""Measure the 100k-sphere stretch scene (BASELINE.json config 5) on one card.

Port of ``scripts/stretch_bench.py``: ``random_sphere_field(n)`` through
``Renderer`` at ``backend="auto"`` (the paged two-level grid for the 100k
field: the paged kernel), one JSON line per config.  ``seconds`` is one
``render_call`` of the config's spp after a 1-spp warm-up call, on the host
clock, ended by copying the accumulator to the host; ``ns_per_sample`` is
it over width x height x spp.  The scene's build (``prepare_scene``, the
paged tables) is outside the clock.  ``device`` names what ran it: the
card's name and power limit (``nvidia-smi``), or the CPU.

Run ``python -m raytrace_tpu_torch.scripts.stretch_bench [--device cpu]
[n_spheres] [configs...]``: each config is WxHxSPP, default ``320x180x8
1920x1080x8``; on the GPU unless given ``--device cpu`` (it raises without
one).  Env: STRETCH_MODE=exact|fast (default exact): fast adds the
Russian-roulette path termination (statistically the same images, fewer
wavefront iterations).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def main(argv=None) -> list:
    from ..config import RenderConfig
    from ..models.scene import random_sphere_field
    from ..runtime.renderer import Renderer, render_device
    from .bench_gather import card_label

    ap = argparse.ArgumentParser(prog="python -m raytrace_tpu_torch.scripts.stretch_bench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=100_000, help="spheres (100000)")
    ap.add_argument("configs", nargs="*", default=["320x180x8", "1920x1080x8"],
                    help="WxHxSPP each")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = render_device(args.device)
    mode = os.environ.get("STRETCH_MODE", "exact")
    scene = random_sphere_field(args.n)
    card = card_label(device)
    out = []
    for spec in args.configs:
        w, h, spp = (int(x) for x in spec.split("x"))
        cfg = RenderConfig(samples=spp, width=w, height=h, backend="auto", mode=mode)
        r = Renderer(cfg, scene=scene, device=device)
        r.render_call(1).cpu()  # warm-up
        t0 = time.perf_counter()
        img = r.render_call(spp).cpu().numpy()
        dt = time.perf_counter() - t0
        rec = {
            "config": spec, "n_spheres": args.n, "backend": r.backend,
            "mode": mode,
            "seconds": round(dt, 3),
            "ns_per_sample": round(dt / (w * h * spp) * 1e9, 2),
            "mean": round(float(img.mean()), 4),
            "nonfinite": int((~np.isfinite(img)).sum()),
            "device": card,
        }
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


if __name__ == "__main__":
    main()
