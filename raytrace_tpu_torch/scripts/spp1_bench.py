"""1-spp frame-latency sweep over (pixels_per_lane, K) (the reference's
other headline: 1.25 ms per 1080p frame).

Port of ``scripts/spp1_bench.py``.  A 1-spp call has only M samples per lane
to average over, so the wavefront tail (lanes that run long) and the
launch quantisation of K iterations per launch weigh more than at many
spp.  This sweeps (M, K) at spp = 1 on the book scene at 1920x1080 in
interleaved rounds and prints medians: host-clock walls of one
``render_band`` call ended by copying one pixel to the host (on the card:
the grid kernel's launches, the host loop's one sync per launch and the
copy).  K is the grid kernel's ``K_STEPS`` (iterations per launch) and J
its ``J_STEPS`` = 2, set for each call and restored after it, as
``runtime/autotune.py`` sets them (``render_band`` takes no
``grid_steps``).  ``launches`` is the port's count of grid launches per
call (the TPU script's invocations per tile), and ``issued its/sample``
the lane slots those launches ran (blocks of 128 lanes x K, summed over
launches of the live lanes) per pixel.  Every line names the card and its
power limit (``nvidia-smi``).

Run ``[CONFIGS=64x40,64x8,...] [SWEEP_ROUNDS=7] python -m
raytrace_tpu_torch.scripts.spp1_bench [--device cpu]``: on the GPU unless
given ``--device cpu`` (it raises without one).
"""

from __future__ import annotations

import argparse
import os
import statistics
import time

W, H = 1920, 1080  # the image (the book scene at 1080p)
J = 2  # DDA cells per iteration of every swept point (the JAX script's)


def main(argv=None) -> dict:
    """Run the sweep; returns {(M, K): (median ms, launches, issued
    iterations per sample)}."""
    from ..models.scene import generate_random_scene
    from ..ops import gridkernel as gk
    from ..ops.trace import (device_scene_from_numpy, prepare_scene, render_band,
                             viewport_arrays)
    from ..runtime.renderer import reference_camera, render_device
    from .bench_gather import card_label

    ap = argparse.ArgumentParser(prog="python -m raytrace_tpu_torch.scripts.spp1_bench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = render_device(args.device)
    rounds = int(os.environ.get("SWEEP_ROUNDS", 7))
    configs = [tuple(int(x) for x in c.split("x")) for c in os.environ.get(
        "CONFIGS", "64x40,64x16,64x8,128x8,256x8,256x16").split(",")]
    card = card_label(device)
    # the tables stay on the device for every call
    ds = device_scene_from_numpy(prepare_scene(generate_random_scene(0.0)), device)
    vp = viewport_arrays(reference_camera(), W, H)
    counters = (gk.grid_megakernel_step, gk.grid_megakernel_step_plain)

    def run(m, k, return_iters=False):
        j0, k0 = gk.J_STEPS, gk.K_STEPS
        gk.J_STEPS, gk.K_STEPS = J, k
        try:
            out = render_band(ds, vp, band_h=H, width=W, y0=0, seed_y0=0, offset_x=0,
                              spp=1, number=0, max_depth=50, backend="grid",
                              pixels_per_lane=m, skip_tmax=True, return_iters=return_iters)
        finally:
            gk.J_STEPS, gk.K_STEPS = j0, k0
        if return_iters:
            acc, (_, lane_slots) = out
            acc[:1, :1, :].cpu()
            return lane_slots
        out[:1, :1, :].cpu()  # sync via a tiny fetch

    stats = {}
    for m, k in configs:
        t0 = time.perf_counter()
        before = sum(c.launches for c in counters)
        slots = run(m, k, return_iters=True)
        stats[(m, k)] = (sum(c.launches for c in counters) - before, slots)
        print(f"M={m} K={k}: warm {time.perf_counter()-t0:.0f}s "
              f"launches={stats[(m, k)][0]}", flush=True)

    times = {c: [] for c in configs}
    for rnd in range(rounds):
        for c in configs:
            t0 = time.perf_counter()
            run(*c)
            times[c].append(time.perf_counter() - t0)
        print(f"round {rnd}: " + " ".join(
            f"{c[0]}x{c[1]}={times[c][-1]*1e3:.1f}ms" for c in configs), flush=True)

    print()
    res = {}
    for m, k in configs:
        t = statistics.median(times[(m, k)])
        n, slots = stats[(m, k)]
        res[(m, k)] = (t * 1e3, n, slots / (W * H))
        print(f"M={m:<4} K={k:<3} {t*1e3:7.1f} ms  launches {n:<4} issued its/sample "
              f"{slots / (W * H):5.2f} ({card})", flush=True)
    return res


if __name__ == "__main__":
    main()
