"""Steady 1-spp frame-loop sweep over pixels_per_lane (M).

Port of ``scripts/spp1_loop_sweep.py``.  The reference's 1.25 ms per frame
is a per-frame average over its presenting loop (ray_trace.cpp:741-748);
the comparable number here is the grid kernel's in-kernel call merge: R
consecutive 1-spp frames in one dispatch, per frame = (t_R - t_1) / (R - 1),
so the fixed cost of a dispatch differences out (``python -m
raytrace_tpu_torch.bench``'s ``spp1_ms_frame_loop``, which runs at M = 16).

At spp = 1 a lane renders its M pixels' single samples one after another
inside each merged call, so M sets the per-frame critical path, while a
smaller M launches more lanes per iteration.  This sweeps M in interleaved
rounds and prints the medians: on the card, host-clock walls of work ended
by copying one pixel to the host (the launches, the host loop's one sync
per launch and the copy); ns/sample is a frame's median over its pixels.
The book scene at 1920x1080, fast mode by default, the balanced tables from
a 32-spp probe per M.  Every line names the card and its power limit (``nvidia-smi``).

Run ``[MS=8,16,32,64] [REPS=65] [SWEEP_ROUNDS=5] [SWEEP_MODE=fast] python
-m raytrace_tpu_torch.scripts.spp1_loop_sweep [--device cpu]``: on the GPU
unless given ``--device cpu`` (it raises without one).
"""

from __future__ import annotations

import argparse
import os
import statistics
import time

W, H = 1920, 1080  # the image (the book scene at 1080p)


def main(argv=None) -> dict:
    """Run the sweep; returns {M: median ms per frame}."""
    from ..config import RenderConfig
    from ..runtime.renderer import Renderer, render_device
    from .bench_gather import card_label

    ap = argparse.ArgumentParser(prog="python -m raytrace_tpu_torch.scripts.spp1_loop_sweep",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = render_device(args.device)
    ms_ = [int(x) for x in os.environ.get("MS", "8,16,32,64").split(",")]
    reps = int(os.environ.get("REPS", 65))
    rounds = int(os.environ.get("SWEEP_ROUNDS", 5))
    mode = os.environ.get("SWEEP_MODE", "fast")
    card = card_label(device)

    renderers = {}
    for m in ms_:
        r = Renderer(RenderConfig(samples=reps, width=W, height=H, backend="grid",
                                  mode=mode, balance_spp=32, pixels_per_lane=m),
                     device=device)
        t0 = time.perf_counter()
        r.render_call(1)[:1, :1, :].cpu()
        r.render_call(1, n_calls=reps, spp_last=1)[:1, :1, :].cpu()
        print(f"M={m}: warm {time.perf_counter()-t0:.0f}s", flush=True)
        renderers[m] = r

    times = {m: [] for m in ms_}
    for rnd in range(rounds):
        for m, r in renderers.items():
            t0 = time.perf_counter()
            r.render_call(1)[:1, :1, :].cpu()
            t1 = time.perf_counter()
            r.render_call(1, n_calls=reps, spp_last=1)[:1, :1, :].cpu()
            t2 = time.perf_counter()
            times[m].append(((t2 - t1) - (t1 - t0)) / (reps - 1) * 1e3)
        print(f"round {rnd}: " + " ".join(
            f"M={m}:{times[m][-1]:.2f}ms" for m in ms_), flush=True)

    print()
    med = {m: statistics.median(times[m]) for m in ms_}
    for m in ms_:
        print(f"M={m:<3} median {med[m]:.2f} ms/frame "
              f"({med[m] * 1e6 / (W * H):.2f} ns/sample) ({card})", flush=True)
    return med


if __name__ == "__main__":
    main()
