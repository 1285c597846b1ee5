"""Statistical image comparison — the cross-RNG validation tool.

Port copy of ``raytrace_tpu/utils/compare.py`` (numpy only).

SURVEY.md hard-part (b): draws from different fp orderings / RNG backends
can never match bitwise, so "same image" must be established statistically.
Monte Carlo renders of the same scene are independent estimates of the same
integral: per-tile means should agree within sampling error, and the
difference image should be zero-mean noise.

Used by tests to compare production backends against the oracle, and by
users to diff this framework's output against the Vulkan reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class CompareResult(NamedTuple):
    mean_rel_diff: float  # |mean(a) - mean(b)| / mean(b)
    tile_p95_z: float  # 95th percentile of per-tile z-scores
    sad: float  # mean absolute difference (display-scale images)
    psnr_db: float

    def matches(self, z_thresh: float = 4.0, mean_thresh: float = 0.02) -> bool:
        return self.mean_rel_diff < mean_thresh and self.tile_p95_z < z_thresh


def compare_accums(a: np.ndarray, b: np.ndarray, spp_a: int, spp_b: int,
                   tile: int = 16) -> CompareResult:
    """Compare two accumulator sums (pre-gamma) rendered at spp_a/spp_b.

    Per-tile z-score: difference of tile means normalized by the pooled
    standard error estimated from b's within-tile variance.
    """
    ia = np.asarray(a, np.float64) / spp_a
    ib = np.asarray(b, np.float64) / spp_b
    h, w = ia.shape[:2]
    th, tw = h // tile, w // tile
    ia_t = ia[: th * tile, : tw * tile].reshape(th, tile, tw, tile, 3)
    ib_t = ib[: th * tile, : tw * tile].reshape(th, tile, tw, tile, 3)
    ma = ia_t.mean(axis=(1, 3, 4))
    mb = ib_t.mean(axis=(1, 3, 4))
    var_b = ib_t.var(axis=(1, 3, 4))
    se = np.sqrt(np.maximum(var_b, 1e-8) * (1.0 / (tile * tile)) * (1 + spp_b / max(spp_a, 1)))
    z = np.abs(ma - mb) / np.maximum(se, 1e-6)

    da = np.sqrt(np.clip(ia, 0, 1))
    db = np.sqrt(np.clip(ib, 0, 1))
    sad = float(np.abs(da - db).mean())
    mse = float(((da - db) ** 2).mean())
    psnr = 99.0 if mse == 0 else float(10 * np.log10(1.0 / mse))
    return CompareResult(
        mean_rel_diff=float(abs(ia.mean() - ib.mean()) / max(ib.mean(), 1e-9)),
        tile_p95_z=float(np.percentile(z, 95)),
        sad=sad,
        psnr_db=psnr,
    )
