"""The wavefront's straggler wall from the grid kernel's measured per-pixel
costs, under lane-assignment policies.

Port of ``scripts/lane_balance.py``.  The grid kernel's ``iterstats`` probe
makes the red channel count the issued iterations each pixel consumed: a
per-pixel cost map from the production kernel itself.  This renders the
probe twice (numbers 0 and 1: independent sample streams), then evaluates
lane-total balance on the book scene under three policies:

  strided     the production map (pixel of lane k, slot m = m*n + k)
  serpentine  ``runtime/balance.build_passign(method="serpentine")``'s
              table: pixels sorted by measured cost, dealt boustrophedon
              across the lanes
  lpt         its ``method="lpt"`` table, the pass-sorted greedy deal: each
              pass hands the next n sorted pixels heaviest-first to the
              lightest lanes

max/mean lane total is the scheduling-efficiency ceiling: a launch runs
until its slowest lane drains.  "in-sample" evaluates a deal on the map it
was built from, "held-out" on probe 1's map: the balance a render would
see.  The probes' times are host-clock walls ended by copying the map to
the host.  Every timing line names the card and its power limit
(``nvidia-smi``), or the CPU.

Run ``[SWEEP_W=1920] [SWEEP_H=1080] [SWEEP_SPP=32] [SWEEP_MODE=fast]
[SWEEP_M=64] python -m raytrace_tpu_torch.scripts.lane_balance [--device
cpu]``, alone on the card: on the GPU unless given ``--device cpu`` (it
raises without one).  The card's operating point is SWEEP_M=2.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def lane_stats(cost_flat: np.ndarray, table, m: int) -> dict:
    """Lane totals' balance stats for a pixel->lane table of
    ``build_passign`` (None: the strided map); max/mean is
    ``balance_stats``'."""
    from ..runtime.balance import balance_stats

    p_total = cost_flat.size
    n = -(-p_total // m)
    lane_of = np.arange(p_total) % n
    if table is not None:
        flat = table.ravel()
        ok = flat < p_total
        lane_of[flat[ok]] = np.tile(np.arange(table.shape[1]), table.shape[0])[ok]
    totals = np.bincount(lane_of, weights=cost_flat, minlength=n)
    return {
        "max/mean": balance_stats(cost_flat, table, m)["max_over_mean"],
        "p99/mean": np.percentile(totals, 99) / totals.mean(),
        "mean": totals.mean(),
    }


def main(argv=None) -> dict:
    """Run the probes; returns {policy: lane_stats} for strided (probe 0),
    serpentine and lpt in-sample and held-out, and strided on probe 1."""
    from .. import config as _cfg
    from ..models.scene import generate_random_scene
    from ..ops.trace import (LANE_PAD, device_scene_from_numpy, prepare_scene, render_band,
                             viewport_arrays)
    from ..runtime.balance import build_passign
    from ..runtime.renderer import reference_camera, render_device
    from .bench_gather import card_label

    ap = argparse.ArgumentParser(prog="python -m raytrace_tpu_torch.scripts.lane_balance",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = render_device(args.device)
    w = int(os.environ.get("SWEEP_W", 1920))
    h = int(os.environ.get("SWEEP_H", 1080))
    spp = int(os.environ.get("SWEEP_SPP", 32))
    m = int(os.environ.get("SWEEP_M", 64))
    mode = os.environ.get("SWEEP_MODE", "fast")
    rr = (_cfg.RR_START_DEPTH, _cfg.RR_CAP_DEPTH, _cfg.RR_PMIN) if mode == "fast" else None
    card = card_label(device)

    ds = device_scene_from_numpy(prepare_scene(generate_random_scene(0.0)), device)
    vp = viewport_arrays(reference_camera(), w, h)

    def probe(number):
        t0 = time.perf_counter()
        acc = render_band(ds, vp, band_h=h, width=w, y0=0, seed_y0=0, offset_x=0,
                          spp=spp, number=number, max_depth=50, backend="grid",
                          pixels_per_lane=m, skip_tmax=True, ablate=("iterstats",),
                          rr=rr).cpu().numpy()
        print(f"probe {w}x{h}x{spp}spp mode={mode} number={number}: "
              f"{time.perf_counter()-t0:.3f}s ({card})", flush=True)
        return acc[:, :, 0].astype(np.float64).ravel()

    cost = probe(0)  # issued iterations per pixel
    cost_b = probe(1)  # independent streams: the held-out map
    print(f"per-pixel issued iters/sample: mean {cost.mean()/spp:.3f} "
          f"p50 {np.percentile(cost,50)/spp:.2f} "
          f"p99 {np.percentile(cost,99)/spp:.2f} "
          f"max {cost.max()/spp:.2f}")

    tabs = {"serpentine": build_passign(cost, m, LANE_PAD, method="serpentine"),
            "lpt": build_passign(cost, m, LANE_PAD, method="lpt")}
    res = {"strided": lane_stats(cost, None, m)}
    for name, tab in tabs.items():
        res[name] = lane_stats(cost, tab, m)
        res[f"{name} held-out"] = lane_stats(cost_b, tab, m)
    res["strided held-out"] = lane_stats(cost_b, None, m)
    strided, serp, lpt = res["strided"], res["serpentine"], res["lpt"]
    serp_held, lpt_held = res["serpentine held-out"], res["lpt held-out"]
    strided_b = res["strided held-out"]
    print(f"strided    max/mean {strided['max/mean']:.4f}  "
          f"p99/mean {strided['p99/mean']:.4f}")
    print(f"serpentine max/mean {serp['max/mean']:.4f}  "
          f"p99/mean {serp['p99/mean']:.4f}  (in-sample)")
    print(f"serpentine max/mean {serp_held['max/mean']:.4f}  "
          f"p99/mean {serp_held['p99/mean']:.4f}  (held-out probe)")
    print(f"lpt        max/mean {lpt['max/mean']:.4f}  "
          f"p99/mean {lpt['p99/mean']:.4f}  (in-sample)")
    print(f"lpt        max/mean {lpt_held['max/mean']:.4f}  "
          f"p99/mean {lpt_held['p99/mean']:.4f}  (held-out probe)")
    print(f"predicted issued-iteration saving vs strided (held-out): "
          f"serpentine {100*(1-serp_held['max/mean']/strided_b['max/mean']):.1f}%  "
          f"lpt {100*(1-lpt_held['max/mean']/strided_b['max/mean']):.1f}%", flush=True)
    res["cost"] = cost
    return res


if __name__ == "__main__":
    main()
