"""Interleaved re-bucket interval sweep for the paged backend (100k scene).

Port of ``scripts/paged_ksweep.py``, its K half.  K is the paged kernel's
``pagedkernel.K_STEPS``: wavefront iterations per launch, between two
re-bucket sorts.  A small K pays the sort and the state gather more often;
a large one lets each 128-lane chunk's page box drift wider between sorts.
The sweep turns ``pagedkernel.K_AUTO`` off, so every launch runs exactly
the variant's K (the lane-count scaling is off), prints the K its
launches ran (``pagedkernel.scaled_k`` of the band's lanes, as
``trace._render_band_paged`` computes it), and restores both values at the
end.  The JAX script's second axis, the linear sort key (MORTON = 0), is
not in the port: its key is always Morton.

The image must not depend on K (lane permutation and launch grouping never
reorder a pixel's sample stream): the script raises if a variant's image
differs from the first's.  ``random_sphere_field(100_000)`` renders through
``Renderer`` at ``backend="auto"``; times are host-clock walls of one
``render_call`` ended by copying the accumulator to the host, in
interleaved rounds, medians printed.  Every timing line names the card and
its power limit (``nvidia-smi``), or the CPU.

Run ``[AB_W=1920] [AB_H=1080] [SWEEP_SPP=8] [SWEEP_ROUNDS=7]
[KS=5,10,20,40] python -m raytrace_tpu_torch.scripts.paged_ksweep [--device
cpu]``: on the GPU unless given ``--device cpu`` (it raises without one).
"""

from __future__ import annotations

import argparse
import os
import statistics
import time


def main(argv=None) -> dict:
    """Run the sweep; returns {K: median seconds}."""
    import numpy as np

    from ..config import RenderConfig
    from ..models.scene import random_sphere_field
    from ..ops import pagedkernel as pkm
    from ..runtime.renderer import Renderer, render_device
    from .bench_gather import card_label

    ap = argparse.ArgumentParser(prog="python -m raytrace_tpu_torch.scripts.paged_ksweep",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = render_device(args.device)
    w = int(os.environ.get("AB_W", 1920))
    h = int(os.environ.get("AB_H", 1080))
    spp = int(os.environ.get("SWEEP_SPP", 8))
    rounds = int(os.environ.get("SWEEP_ROUNDS", 7))
    ks = [int(k) for k in os.environ.get("KS", "5,10,20,40").split(",")]
    card = card_label(device)

    r = Renderer(RenderConfig(samples=spp, width=w, height=h, backend="auto"),
                 scene=random_sphere_field(100_000), device=device)
    if r.backend != "paged":
        raise RuntimeError(f"the 100k field resolved to {r.backend!r}, not the paged backend")
    lanes = [-(-(kw["band_h"] * w) // kw["pixels_per_lane"]) for kw in r.chunks(r.bands[0])]

    k0, auto0 = pkm.K_STEPS, pkm.K_AUTO
    pkm.K_AUTO = False  # the sweep pins exact intervals: no lane-count scaling
    try:
        imgs = {}
        for k in ks:
            pkm.K_STEPS = k
            t0 = time.perf_counter()
            imgs[k] = r.render_call(spp).cpu().numpy()
            print(f"K={k}: warm {time.perf_counter()-t0:.3f}s, launches at K="
                  f"{sorted({pkm.scaled_k(n) for n in lanes})} over {lanes} lanes "
                  f"({card})", flush=True)

        ref = imgs[ks[0]]
        bad = []
        for k in ks[1:]:
            same = np.array_equal(ref, imgs[k])
            print(f"K={k} image bit-identical to K={ks[0]}: {same}", flush=True)
            if not same:
                bad.append(k)
        if bad:
            raise RuntimeError(f"K={bad} render another image than K={ks[0]}")

        times = {k: [] for k in ks}
        for rnd in range(rounds):
            for k in ks:
                pkm.K_STEPS = k
                t0 = time.perf_counter()
                r.render_call(spp).cpu()
                times[k].append(time.perf_counter() - t0)
            print(f"round {rnd}: " + " ".join(f"K{k}={times[k][-1]:.3f}" for k in ks),
                  flush=True)
    finally:
        pkm.K_STEPS, pkm.K_AUTO = k0, auto0

    med = {}
    for k in ks:
        t = med[k] = statistics.median(times[k])
        print(f"K={k:<3} median {t:.3f}s ({t/(w*h*spp)*1e9:.2f} ns/sample) ({card})",
              flush=True)
    return med


if __name__ == "__main__":
    main()
