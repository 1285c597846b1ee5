"""Additive section-cost attribution for the grid kernel on the card.

Port of ``scripts/grid_ablate.py``.  Each duplication variant
(``ops.gridkernel.DUPLICATIONS``: ``fetch2``, ``resolve2``, ``global2``,
``camera2``, ``isect2``, ``dda2``, ``shade2``) runs one kernel section a
second time on inputs made opaque to the compiler and consumes the result
through a zero it cannot know (``csrc/gridkernel.cu``), so the image is
unchanged; the time a variant adds over base attributes that section's
cost.  Every variant's library is built before anything is timed (one nvcc
each, all at once), and each is rendered once through ``Renderer`` with
``gridkernel.ABLATE`` set to it; its image must equal base's bit for bit
(the script raises if not), and on the card its SASS must hold more
instructions than base's -- a variant whose duplicate the compiler removed
is reported and not timed.  Then the variants are rendered in interleaved
rounds (host clock to the accumulator on the host) and the medians
printed, each beside the variant's registers, stack frame and spills
(ptxas) and SASS instruction count with its delta from base.

What it can see: a section's cost within real renders, divergence
included; a duplicated section overlaps its twin, so a section on a
latency chain with slack reads ~0 here (``grid_iterbench`` removes
sections instead).

Run ``[SWEEP_W=1920] [SWEEP_H=1080] [SWEEP_SPP=200] [SWEEP_ROUNDS=5]
[ABLATE_VARIANTS=base,fetch2,...] [SWEEP_J=2] [SWEEP_K=40] [M=2] python -m
raytrace_tpu_torch.scripts.grid_ablate [--mode exact|fast] [--device cpu]``:
on the GPU unless given ``--device cpu`` (it raises without one).  The
JAX script's defaults are exact mode and the renderer's M; the headline's
operating point is ``--mode fast`` with M=2.  Every timing line names the
card and its power limit (``nvidia-smi``), or the CPU.
"""

from __future__ import annotations

import os
import time

VARIANTS = "base,fetch2,resolve2,global2,camera2,isect2,dda2,shade2"


def main(argv=None) -> dict:
    """Run the attribution; returns {variant: median seconds} of the timed
    variants."""
    import numpy as np

    from ..config import RenderConfig
    from ..ops import gridkernel as gk
    from ..runtime.renderer import Renderer
    from . import probe_runs as pr

    device, card, args = pr.parse("grid_ablate", __doc__, argv, modes=True)
    w = int(os.environ.get("SWEEP_W", 1920))
    h = int(os.environ.get("SWEEP_H", 1080))
    spp = int(os.environ.get("SWEEP_SPP", 200))
    rounds = int(os.environ.get("SWEEP_ROUNDS", 5))
    variants = os.environ.get("ABLATE_VARIANTS", VARIANTS).split(",")
    m = int(os.environ["M"]) if "M" in os.environ else None
    sets = pr.variant_sets(variants)
    for v, s in sets.items():
        if any(a not in gk.DUPLICATIONS for a in s):
            raise ValueError(f"variant {v!r}: grid_ablate times duplications "
                             f"{gk.DUPLICATIONS} (grid_iterbench the removals)")

    j0, k0, ablate0 = gk.J_STEPS, gk.K_STEPS, gk.ABLATE
    gk.J_STEPS = int(os.environ.get("SWEEP_J", gk.J_STEPS))
    gk.K_STEPS = int(os.environ.get("SWEEP_K", gk.K_STEPS))
    try:
        r = Renderer(RenderConfig(samples=spp, width=w, height=h, backend="grid",
                                  mode=args.mode, pixels_per_lane=m), device=device)
        g = r.device_scene.grid
        masks = {v: gk.switch_mask(s) for v, s in sets.items()}
        reps = pr.compiled(device, "grid", sorted(set(masks.values())),
                           pr.grid_instance(bool(g.five), int(g.n_slots)))
        print(f"{args.mode} mode, {w}x{h} x {spp} spp, M={r.pixels_per_lane}, "
              f"J={gk.J_STEPS}, K={gk.K_STEPS} ({card})", flush=True)

        def run(v):
            gk.ABLATE = frozenset(sets[v])
            return r.render_call(spp).cpu().numpy()

        base_img, timed = None, []
        for v in variants:
            t0 = time.perf_counter()
            img = run(v)
            print(f"{v}: warm {time.perf_counter() - t0:.3f}s", flush=True)
            if base_img is None:
                base_img = img
            elif not np.array_equal(img, base_img):
                raise RuntimeError(f"{v} renders another image than {variants[0]}")
            rep, base_rep = reps.get(masks[v]), reps.get(masks["base"])
            if rep and v != "base" and rep["sass"] <= base_rep["sass"]:
                print(f"{v}: {rep['sass']} SASS instructions, not more than base's "
                      f"{base_rep['sass']}: the compiler removed the duplicate; not timed")
                continue
            timed.append(v)
        times = pr.rounds_in_turns(run, timed, rounds, device)
    finally:
        gk.J_STEPS, gk.K_STEPS, gk.ABLATE = j0, k0, ablate0

    text = {v: pr.compiled_text(reps.get(masks[v]), None if v == "base" else
                                reps.get(masks["base"])) for v in timed}
    return pr.medians(times, text, card,
                      lambda t: f"{t / (w * h * spp) * 1e9:.3f} ns/sample")


if __name__ == "__main__":
    main()
