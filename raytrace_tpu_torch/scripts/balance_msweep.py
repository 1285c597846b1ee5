"""Pixels-per-lane (M) sweep under the balanced pixel->lane assignment.

Port of ``scripts/balance_msweep.py``.  A larger M averages a lane's
stragglers over more pixels; the balanced table (``runtime/balance.py``)
evens out the lanes' totals directly, so the best M may move.  This times
the M candidates round-robin on the book scene, each with its own balanced
table built from one shared measured cost map (the map is per pixel, the
same for any M), checks that every M renders the first M's image bit for
bit, and prints the medians: host-clock walls of one ``render_band`` of
the whole image ended by copying it to the host (on the card: the grid
kernel's launches, the host loop and the copy); ns/sample is the median
over width x height x spp.  The tables are padded to the port's 128-lane
blocks.  Every line names the card and its power limit (``nvidia-smi``).

Run ``[SWEEP_W=1920] [SWEEP_H=1080] [SWEEP_SPP=400] [SWEEP_ROUNDS=7]
[SWEEP_MODE=fast] [PROBE_SPP=32] [MS=32,48,64] python -m
raytrace_tpu_torch.scripts.balance_msweep [--device cpu]``, alone on the
card: on the GPU unless given ``--device cpu`` (it raises without one).
"""

from __future__ import annotations

import argparse
import os
import statistics
import time


def main(argv=None) -> dict:
    """Run the sweep; returns {M: median seconds}."""
    import numpy as np
    import torch

    from .. import config as _cfg
    from ..models.scene import generate_random_scene
    from ..ops.trace import (LANE_PAD, device_scene_from_numpy, prepare_scene,
                             render_band, viewport_arrays)
    from ..runtime.balance import balance_stats, build_passign, measure_cost_map
    from ..runtime.renderer import reference_camera, render_device
    from .bench_gather import card_label

    ap = argparse.ArgumentParser(prog="python -m raytrace_tpu_torch.scripts.balance_msweep",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = render_device(args.device)
    w = int(os.environ.get("SWEEP_W", 1920))
    h = int(os.environ.get("SWEEP_H", 1080))
    spp = int(os.environ.get("SWEEP_SPP", 400))
    rounds = int(os.environ.get("SWEEP_ROUNDS", 7))
    mode = os.environ.get("SWEEP_MODE", "fast")
    probe_spp = int(os.environ.get("PROBE_SPP", 32))
    ms_ = [int(m) for m in os.environ.get("MS", "32,48,64").split(",")]
    rr = (_cfg.RR_START_DEPTH, _cfg.RR_CAP_DEPTH, _cfg.RR_PMIN) if mode == "fast" else None
    card = card_label(device)

    ds = device_scene_from_numpy(prepare_scene(generate_random_scene(0.0)), device)
    vp = viewport_arrays(reference_camera(), w, h)

    def kw_for(m):
        return dict(scene=ds, vp=vp, band_h=h, width=w, y0=0, seed_y0=0, offset_x=0,
                    spp=spp, number=0, max_depth=50, backend="grid",
                    pixels_per_lane=m, skip_tmax=True, rr=rr)

    # one shared cost probe (per-pixel costs do not depend on M; probed at
    # the first candidate's M)
    t0 = time.perf_counter()
    cost = measure_cost_map(kw_for(ms_[0]), probe_spp)
    print(f"probe {probe_spp}spp @M={ms_[0]}: {time.perf_counter()-t0:.0f}s", flush=True)

    tabs = {}
    for m in ms_:
        tab = build_passign(cost, m, LANE_PAD)
        st = balance_stats(cost, tab, m)
        print(f"M={m}: balanced max/mean {st['max_over_mean']:.3f} "
              f"(strided {balance_stats(cost, None, m)['max_over_mean']:.3f})", flush=True)
        tabs[m] = torch.from_numpy(tab).to(device)

    imgs = {}
    for m in ms_:
        t0 = time.perf_counter()
        imgs[m] = render_band(**kw_for(m), passign=tabs[m]).cpu().numpy()
        print(f"M={m}: warm {time.perf_counter()-t0:.0f}s", flush=True)

    base = imgs[ms_[0]]
    for m in ms_[1:]:
        diff = np.abs(base - imgs[m])
        print(f"bit check M={ms_[0]} vs M={m}: "
              f"{int((diff.max(axis=-1) > 0).sum())}/{w*h} px differ, "
              f"max {diff.max()}", flush=True)

    times = {m: [] for m in ms_}
    for rnd in range(rounds):
        for m in ms_:
            t0 = time.perf_counter()
            render_band(**kw_for(m), passign=tabs[m]).cpu()
            times[m].append(time.perf_counter() - t0)
        print(f"round {rnd}: " + " ".join(
            f"M{m}={times[m][-1]:.2f}s" for m in ms_), flush=True)

    samples = w * h * spp
    med = {m: statistics.median(ts) for m, ts in times.items()}
    for m, t in med.items():
        print(f"M={m}: median {t:.3f}s  {t/samples*1e9:.2f} ns/sample ({card})", flush=True)
    return med


if __name__ == "__main__":
    main()
