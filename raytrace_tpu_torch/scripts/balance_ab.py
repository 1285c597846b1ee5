"""Balanced vs strided pixel assignment: an interleaved A/B on the card.

Port of ``scripts/balance_ab.py``.  It probes the book scene's per-pixel
costs with the grid kernel's iterstats mode, builds the balanced table
(``runtime/balance.build_passign``), then renders the strided map and the
balanced table in turns and prints the medians.  The image does not depend
on the table (every pixel still renders whole on one lane), so the two
images must be equal bit for bit: the script raises if a pixel differs.
Times are host-clock walls of one ``render_band`` of the whole image ended
by copying it to the host (on the card: the grid kernel's launches, the
host loop and the copy); ns/sample is the median over width x height x
spp.  The table is padded to the port's 128-lane blocks.  Every timing line
names the card and its power limit (``nvidia-smi``), or the CPU.

Run ``[SWEEP_W=1920] [SWEEP_H=1080] [SWEEP_SPP=400] [SWEEP_ROUNDS=7]
[SWEEP_MODE=fast] [PROBE_SPP=32] [SWEEP_M=64] python -m
raytrace_tpu_torch.scripts.balance_ab [--device cpu]``, alone on the card:
on the GPU unless given ``--device cpu`` (it raises without one).  The
card's operating point is SWEEP_M=2.
"""

from __future__ import annotations

import argparse
import os
import statistics
import time


def setup(prog, doc, argv):
    """The scripts' common part: the arguments, the environment, the book
    scene on the device and its measured cost map.  Returns (device, card
    label, render_band keywords, cost map, m, rounds)."""
    from .. import config as _cfg
    from ..models.scene import generate_random_scene
    from ..ops.trace import device_scene_from_numpy, prepare_scene, viewport_arrays
    from ..runtime.balance import measure_cost_map
    from ..runtime.renderer import reference_camera, render_device
    from .bench_gather import card_label

    ap = argparse.ArgumentParser(prog=f"python -m raytrace_tpu_torch.scripts.{prog}",
                                 description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = render_device(args.device)
    w = int(os.environ.get("SWEEP_W", 1920))
    h = int(os.environ.get("SWEEP_H", 1080))
    spp = int(os.environ.get("SWEEP_SPP", 400))
    rounds = int(os.environ.get("SWEEP_ROUNDS", 7))
    mode = os.environ.get("SWEEP_MODE", "fast")
    probe_spp = int(os.environ.get("PROBE_SPP", 32))
    m = int(os.environ.get("SWEEP_M", 64))
    rr = (_cfg.RR_START_DEPTH, _cfg.RR_CAP_DEPTH, _cfg.RR_PMIN) if mode == "fast" else None
    card = card_label(device)

    ds = device_scene_from_numpy(prepare_scene(generate_random_scene(0.0)), device)
    kw = dict(scene=ds, vp=viewport_arrays(reference_camera(), w, h), band_h=h, width=w,
              y0=0, seed_y0=0, offset_x=0, spp=spp, number=0, max_depth=50,
              backend="grid", pixels_per_lane=m, skip_tmax=True, rr=rr)
    t0 = time.perf_counter()
    cost = measure_cost_map(kw, probe_spp)
    print(f"probe {probe_spp}spp: {time.perf_counter()-t0:.3f}s ({card})", flush=True)
    return device, card, kw, cost, m, rounds


def interleave(variants, kw, rounds, card, pair):
    """Warm each passign variant up, hold the two of ``pair`` bit-equal
    (raises if a pixel differs), time every variant in ``rounds`` turns
    and print the medians.  Returns {name: median seconds}."""
    import numpy as np

    from ..ops.trace import render_band

    imgs = {}
    for name, t in variants.items():
        t0 = time.perf_counter()
        imgs[name] = render_band(**kw, passign=t).cpu().numpy()
        print(f"{name}: warm {time.perf_counter()-t0:.3f}s ({card})", flush=True)

    a, b = pair
    diff = np.abs(imgs[a] - imgs[b])
    n_diff = int((diff.max(axis=-1) > 0).sum())
    print(f"bit check: {n_diff}/{kw['width']*kw['band_h']} px differ, "
          f"max {diff.max()}", flush=True)
    if n_diff or not np.array_equal(imgs[a], imgs[b]):
        raise RuntimeError(f"{a} and {b} images differ in {n_diff} px: the assignment "
                           "must not change the image")

    times = {n: [] for n in variants}
    for rnd in range(rounds):
        for name, t in variants.items():
            t0 = time.perf_counter()
            render_band(**kw, passign=t).cpu()
            times[name].append(time.perf_counter() - t0)
        print(f"round {rnd}: " + " ".join(
            f"{n}={times[n][-1]:.3f}s" for n in variants), flush=True)

    samples = kw["width"] * kw["band_h"] * kw["spp"]
    med = {n: statistics.median(ts) for n, ts in times.items()}
    for n, t in med.items():
        print(f"{n}: median {t:.3f}s  {t/samples*1e9:.2f} ns/sample ({card})", flush=True)
    return med


def main(argv=None) -> dict:
    """Run the A/B; returns {"strided", "balanced": median seconds}."""
    import torch

    from ..ops.trace import LANE_PAD
    from ..runtime.balance import balance_stats, build_passign

    device, card, kw, cost, m, rounds = setup("balance_ab", __doc__, argv)
    tab = build_passign(cost, m, LANE_PAD)
    print("strided wall:", balance_stats(cost, None, m)["max_over_mean"],
          "balanced wall:", balance_stats(cost, tab, m)["max_over_mean"], flush=True)
    variants = {"strided": None, "balanced": torch.from_numpy(tab).to(device)}
    med = interleave(variants, kw, rounds, card, ("strided", "balanced"))
    print(f"balanced vs strided: "
          f"{100*(med['balanced']-med['strided'])/med['strided']:+.1f}% ({card})", flush=True)
    return med


if __name__ == "__main__":
    main()
