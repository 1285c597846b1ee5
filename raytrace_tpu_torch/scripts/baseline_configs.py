"""Measure BASELINE.json's configs 1-3, one JSON line each.

Port of ``scripts/baseline_configs.py``:

1. 3-sphere scene, 480x270, 1 spp, depth 8 — the ``matmul`` spec path on
   the CPU, asked for explicitly (the oracle-parity tests pin it to the GLSL
   semantics)
2. book scene, 1280x720, 10 spp, depth 50 — brute force, no acceleration
   structure (``mega``: the megakernel), on the device
3. book scene, 1920x1080, 100 spp — the grid traversal (``grid``: the grid
   kernel), on the device
4. the README benchmark, 1920x1080 x 10k spp — ``python -m
   raytrace_tpu_torch.bench`` (not repeated here)
5. 100k spheres at 3840x2160 — ``raytrace_tpu_torch.scripts.stretch_bench``
   (not repeated here)

``seconds`` is one ``render_call`` of the config's spp after a 1-spp
warm-up call, on the host clock, ended by copying the accumulator to the
host: on the card the kernels' time plus the host loop's and the copy's;
config 1 is the plain torch spec path on the host's cores.  ``device``
names what ran it: the card's name and power limit (``nvidia-smi``), or the
CPU.

Run ``python -m raytrace_tpu_torch.scripts.baseline_configs [--device cpu]
[1 2 3]``: configs 2-3 run on the GPU unless given ``--device cpu`` (and
raise without one).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

# n -> (RenderConfig fields, scene); config 1 always renders on the CPU
CONFIGS = {
    1: (dict(samples=1, width=480, height=270, max_depth=8, backend="matmul"), "three"),
    2: (dict(samples=10, width=1280, height=720, max_depth=50, backend="mega"), "book"),
    3: (dict(samples=100, width=1920, height=1080, max_depth=50, backend="grid"), "book"),
}


def run(n: int, device="cuda") -> dict:
    """Render config ``n`` (config 1 on the CPU, the others on ``device``);
    prints and returns its JSON record."""
    from ..config import RenderConfig
    from ..models.scene import generate_random_scene, three_sphere_scene
    from ..runtime.renderer import Renderer
    from .bench_gather import card_label

    if n not in CONFIGS:
        raise SystemExit(f"config {n} is measured elsewhere (see docstring)")
    fields, which = CONFIGS[n]
    if n == 1:
        device = "cpu"
    cfg = RenderConfig(**fields)
    scene = three_sphere_scene() if which == "three" else generate_random_scene(0.0)
    r = Renderer(cfg, scene=scene, device=device)
    r.render_call(1).cpu()  # warm-up
    t0 = time.perf_counter()
    img = r.render_call(cfg.samples).cpu().numpy()
    dt = time.perf_counter() - t0
    rec = {
        "config": n, "backend": r.backend, "seconds": round(dt, 3),
        "width": cfg.width, "height": cfg.height, "spp": cfg.samples,
        "depth": cfg.max_depth, "mean": round(float(img.mean()), 4),
        "nonfinite": int((~np.isfinite(img)).sum()),
        "device": card_label(r.device),
    }
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(prog="python -m raytrace_tpu_torch.scripts.baseline_configs",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("configs", nargs="*", type=int, default=[1, 2, 3])
    ap.add_argument("--device", default="cuda",
                    help="device of configs 2-3: cuda (default) or cpu")
    args = ap.parse_args(argv)
    return [run(n, args.device) for n in args.configs]


if __name__ == "__main__":
    main()
