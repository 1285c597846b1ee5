"""Measured-cost balanced pixel->lane assignment.

Port of ``raytrace_tpu/runtime/balance.py`` (numpy, kept byte-equal here:
the port imports nothing of the JAX package).  The wavefront runs until its
slowest lane drains, and lanes own static pixel sets; this module renders a
cheap probe with the grid kernel's ``iterstats`` mode (red counts the issued
iterations of each pixel: the production kernel measuring itself), then
deals pixels to lanes by cost (``build_passign``).

The image does not change: every pixel still renders whole, on one lane, its
samples in sequence, so the output is bit-identical to the strided map for
any table.  Tables are padded to the port's ``trace.LANE_PAD`` (one CUDA
block), not the TPU kernel's 4096-lane tile.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def build_passign(cost: np.ndarray, m_slots: int, tile: int,
                  method: str = "lpt") -> np.ndarray:
    """Deal pixels to lanes by measured cost.

    ``cost``: per-pixel cost, shape [band_h, width] or flat [p_total].
    Returns an i32 [m_slots, n_pad] table of pixel ids; entries that carry
    no pixel (padding lanes / the short last pass) hold the ``p_total``
    sentinel the kernel treats as invalid.

    ``method``:
      - "lpt" (default): pass-sorted greedy deal — each pass hands the
        next ``n`` cost-sorted pixels heaviest-first to lanes in ascending
        running-total order (LPT restricted to the table's one-pixel-per-
        pass shape).  Measured held-out max/mean below the serpentine's.
      - "serpentine": boustrophedon deal over the cost-sorted list (the
        original r4 policy; kept for A/Bs).
    """
    cost = np.asarray(cost, np.float64).ravel()
    p_total = cost.size
    m_slots = max(1, min(m_slots, p_total))
    n = -(-p_total // m_slots)
    n_pad = -(-n // tile) * tile

    order = np.argsort(-cost, kind="stable")  # expensive pixels first
    table = np.full((m_slots, n_pad), p_total, np.int32)
    if method == "serpentine":
        ranks = np.arange(p_total)
        pass_i = ranks // n
        col = ranks % n
        lane_of_rank = np.where(pass_i % 2 == 0, col, n - 1 - col)
        table[pass_i, lane_of_rank] = order
    elif method == "lpt":
        totals = np.zeros(n, np.float64)
        sorted_cost = cost[order]
        for p in range(m_slots):
            chunk = order[p * n : (p + 1) * n]
            if chunk.size == 0:
                break
            lanes = np.argsort(totals[: n], kind="stable")[: chunk.size]
            table[p, lanes] = chunk
            totals[lanes] += sorted_cost[p * n : p * n + chunk.size]
    else:
        raise ValueError(f"unknown balance method {method!r}")
    return table


def measure_cost_map(render_band_kwargs: dict, spp: int) -> np.ndarray:
    """Render the iterstats probe; returns per-pixel issued-iteration
    counts [band_h, width] (numpy).  ``render_band_kwargs`` are the
    production band render's (same backend, M and rr) minus spp, ablate and
    the accumulator, so the costs are measured under the production
    operating point."""
    from ..ops.trace import run_steps

    return run_steps(cost_map_steps(render_band_kwargs, spp))


def cost_map_steps(render_band_kwargs: dict, spp: int):
    """``measure_cost_map`` as a generator of steps (``render_band_steps``),
    so that several bands' probes run at once (``parallel/sharding.py``)."""
    from ..ops.trace import render_band_steps

    kw = dict(render_band_kwargs)
    kw.pop("accum_init", None)
    kw.pop("n_calls", None)
    kw.pop("spp_last", None)
    kw.pop("passign", None)
    kw["spp"] = int(spp)
    kw["ablate"] = ("iterstats",)
    cost = yield from render_band_steps(kw.pop("scene"), kw.pop("vp"), **kw)
    return cost[:, :, 0].cpu().numpy()


def balance_stats(cost: np.ndarray, table: Optional[np.ndarray],
                  m_slots: int) -> dict:
    """max/mean lane-total diagnostics for a cost map under a table (or
    the default strided map when table is None)."""
    cost = np.asarray(cost, np.float64).ravel()
    p_total = cost.size
    n = -(-p_total // max(1, min(m_slots, p_total)))
    if table is None:
        assign = np.arange(p_total) % n
        totals = np.bincount(assign, weights=cost, minlength=n)
    else:
        flat = table.ravel()
        valid = flat < p_total
        lanes = np.tile(np.arange(table.shape[1]), table.shape[0])[valid]
        totals = np.bincount(lanes % n, weights=cost[flat[valid]],
                             minlength=n)
    return {"max_over_mean": float(totals.max() / totals.mean()),
            "lanes": int(n)}
