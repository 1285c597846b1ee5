"""Serpentine vs pass-sorted LPT balanced tables: an interleaved A/B on the
card.

Port of ``scripts/balance_policy_ab.py``.  Both tables feed the same
kernel (the table is a tensor input), so the A/B measures the scheduling
difference between the two deal policies of
``runtime/balance.build_passign`` (``method="serpentine"`` and ``"lpt"``)
and nothing else.  It probes the book scene's per-pixel costs with the
grid kernel's iterstats mode, prints each table's in-sample max/mean lane
cost, holds the two images equal bit for bit (it raises if a pixel
differs: the table never changes the image), renders them in turns and
prints the medians: host-clock walls of one ``render_band`` of the whole
image ended by copying it to the host.  Every timing line names the card
and its power limit (``nvidia-smi``), or the CPU.

Run ``[SWEEP_W=1920] [SWEEP_H=1080] [SWEEP_SPP=400] [SWEEP_ROUNDS=7]
[SWEEP_MODE=fast] [PROBE_SPP=32] [SWEEP_M=64] python -m
raytrace_tpu_torch.scripts.balance_policy_ab [--device cpu]``, alone on the
card: on the GPU unless given ``--device cpu`` (it raises without one).
The card's operating point is SWEEP_M=2.
"""

from __future__ import annotations


def main(argv=None) -> dict:
    """Run the A/B; returns {"serpentine", "lpt": median seconds}."""
    import torch

    from ..ops.trace import LANE_PAD
    from ..runtime.balance import balance_stats, build_passign
    from .balance_ab import interleave, setup

    device, card, kw, cost, m, rounds = setup("balance_policy_ab", __doc__, argv)
    tabs = {}
    for name in ("serpentine", "lpt"):
        tab = build_passign(cost, m, LANE_PAD, method=name)
        print(f"{name}: in-sample max/mean "
              f"{balance_stats(cost, tab, m)['max_over_mean']:.4f}", flush=True)
        tabs[name] = torch.from_numpy(tab).to(device)
    med = interleave(tabs, kw, rounds, card, ("serpentine", "lpt"))
    print(f"lpt vs serpentine: "
          f"{100*(med['lpt']-med['serpentine'])/med['serpentine']:+.1f}% ({card})", flush=True)
    return med


if __name__ == "__main__":
    main()
