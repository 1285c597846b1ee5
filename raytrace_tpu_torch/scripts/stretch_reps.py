"""BASELINE config 5's repeats in one process: one scene build, one table
upload, one ``Renderer``, N timed ``render_call``s.

Port of ``scripts/stretch_reps.py``.  ``random_sphere_field(100_000)``
renders through ``Renderer`` at ``backend="auto"`` (the paged kernel) after
one 1-spp warm-up call; each repeat is one ``render_call`` of the config's
spp on the host clock, ended by copying the accumulator to the host (on the
card: the paged kernel's launches, the re-bucket sorts, the host loop and
the copy).  In-process repeats spread less than separate processes, and
the first repeat is the process's first call at the config's spp.  Prints
each repeat's time on stderr and one JSON line with every repeat's time,
their median, the image's mean, ns per sample (the median over width x
height x spp) and ``device``, the card's name and power limit
(``nvidia-smi``) or the CPU.

Run ``[STRETCH_MODE=fast|exact] python -m
raytrace_tpu_torch.scripts.stretch_reps [reps] [WxHxSPP] [--device cpu]``
(5 repeats of 3840x2160x8, fast): on the GPU unless given ``--device cpu``
(it raises without one).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> dict:
    """Run the repeats; returns the JSON record it printed."""
    from ..config import RenderConfig
    from ..models.scene import random_sphere_field
    from ..runtime.renderer import Renderer, render_device
    from .bench_gather import card_label

    ap = argparse.ArgumentParser(prog="python -m raytrace_tpu_torch.scripts.stretch_reps",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("reps", nargs="?", type=int, default=5, help="repeats (5)")
    ap.add_argument("spec", nargs="?", default="3840x2160x8", help="WxHxSPP (3840x2160x8)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = render_device(args.device)
    mode = os.environ.get("STRETCH_MODE", "fast")
    w, h, spp = (int(x) for x in args.spec.split("x"))

    scene = random_sphere_field(100_000)
    r = Renderer(RenderConfig(samples=spp, width=w, height=h, backend="auto", mode=mode),
                 scene=scene, device=device)
    r.render_call(1).cpu()  # upload + warm
    times = []
    mean = None
    for i in range(args.reps):
        t0 = time.perf_counter()
        img = r.render_call(spp).cpu().numpy()
        times.append(round(time.perf_counter() - t0, 3))
        mean = round(float(img.mean()), 4)
        print(f"rep {i}: {times[-1]}s", file=sys.stderr, flush=True)
    times_s = sorted(times)
    rec = {
        "config": args.spec, "mode": mode, "backend": r.backend, "reps": times,
        "median": times_s[len(times_s) // 2], "mean_img": mean,
        "ns_per_sample": round(times_s[len(times_s) // 2] / (w * h * spp) * 1e9, 2),
        "device": card_label(device),
    }
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
