"""Exact vs fast (Russian-roulette) mode, interleaved A/B.

Port of ``scripts/fast_ab.py``: builds a ``Renderer`` per variant on the
book scene (grid kernel), warms each with one full call, times them
round-robin (drift between rounds cancels) and prints the medians, then
holds each fast variant's image against exact mode's with the statistical
gate (``utils/compare.compare_accums``: per-tile z-scores, mean shift,
PSNR).  A time is the host-clock wall of one ``render_call`` of SWEEP_SPP
samples ended by copying the accumulator to the host; on the card the grid
kernel's launches, the host loop and the copy.  Every line names the card
and its power limit (``nvidia-smi``).

Run ``[SWEEP_W=1920] [SWEEP_H=1080] [SWEEP_SPP=400] [SWEEP_ROUNDS=5]
[FAST_RR="d0,d1,pmin;..."] python -m raytrace_tpu_torch.scripts.fast_ab
[--device cpu]``, alone on the card: on the GPU unless given ``--device
cpu`` (it raises without one).  FAST_RR lists fast variants (default: the
config's RR defaults).
"""

from __future__ import annotations

import argparse
import os
import statistics
import time


def main(argv=None) -> dict:
    """Run the A/B; returns {variant: median seconds}."""
    from ..config import RR_CAP_DEPTH, RR_PMIN, RR_START_DEPTH, RenderConfig
    from ..runtime.renderer import Renderer, render_device
    from ..utils.compare import compare_accums
    from .bench_gather import card_label

    ap = argparse.ArgumentParser(prog="python -m raytrace_tpu_torch.scripts.fast_ab",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = render_device(args.device)
    w = int(os.environ.get("SWEEP_W", 1920))
    h = int(os.environ.get("SWEEP_H", 1080))
    spp = int(os.environ.get("SWEEP_SPP", 400))
    rounds = int(os.environ.get("SWEEP_ROUNDS", 5))
    rr_env = os.environ.get("FAST_RR")
    variants = [("exact", "exact", None)]
    if rr_env:
        for spec in rr_env.split(";"):
            d0, d1, pmin = spec.split(",")
            variants.append((f"fast({spec})", "fast", (int(d0), int(d1), float(pmin))))
    else:
        variants.append(("fast", "fast", (RR_START_DEPTH, RR_CAP_DEPTH, RR_PMIN)))
    card = card_label(device)

    renderers = {}
    for name, mode, rrp in variants:
        r = Renderer(RenderConfig(samples=spp, width=w, height=h, backend="grid",
                                  mode=mode, rr_params=rrp), device=device)
        t0 = time.perf_counter()
        r.render_call(spp).cpu()
        print(f"{name}: warm {time.perf_counter()-t0:.0f}s", flush=True)
        renderers[name] = r

    times = {name: [] for name, _, _ in variants}
    imgs = {}
    for rnd in range(rounds):
        for name, _, _ in variants:
            t0 = time.perf_counter()
            imgs[name] = renderers[name].render_call(spp).cpu().numpy()
            times[name].append(time.perf_counter() - t0)
        print(f"round {rnd}: " + " ".join(
            f"{n}={times[n][-1]:.2f}" for n, _, _ in variants), flush=True)

    med = {name: statistics.median(ts) for name, ts in times.items()}
    base = med["exact"]
    print(f"\nexact median: {base:.3f}s ({base/(w*h*spp)*1e9:.2f} ns/sample) ({card})")
    for name, _, _ in variants[1:]:
        m = med[name]
        print(f"{name:<16} median {m:.3f}s ({m/(w*h*spp)*1e9:.2f} ns/sample)  "
              f"{100*(m-base)/base:+.1f}% ({card})", flush=True)
        res = compare_accums(imgs[name], imgs["exact"], spp, spp, tile=8)
        print(f"  gate vs exact: p95_z {res.tile_p95_z:.2f}  mean_rel "
              f"{res.mean_rel_diff:.5f}  psnr {res.psnr_db:.1f} dB  "
              f"matches={res.matches()}", flush=True)
    return med


if __name__ == "__main__":
    main()
