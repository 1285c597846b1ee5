"""On-device numeric validation against the CPU-oracle golden.

Port of ``raytrace_tpu/runtime/validation.py``: the same gates, render
configurations, pass rules and result keys, each run on ``device`` (the
CUDA kernels by default; ``device="cpu"`` runs their plain torch versions).
The goldens are read from the repository's ``tests/data``.  chip_smoke.py
runs every gate on the card.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

W, H, SPP, DEPTH = 24, 14, 2, 12
_DATA = os.path.join(os.path.dirname(__file__), "..", "..", "tests", "data")
GOLDEN = os.path.join(_DATA, "golden_fullscene_24x14_2spp_d12.npy")
# multi-tile config: 9216 lanes at pixels_per_lane=1 span many kernel
# blocks, which a 336-pixel render does not
GOLDEN_MT = os.path.join(_DATA, "golden_fullscene_128x72_2spp_d8.npy")


def _fast_rr():
    from .. import config as _cfg

    return (_cfg.RR_START_DEPTH, _cfg.RR_CAP_DEPTH, _cfg.RR_PMIN)


def _book(device):
    """The book scene's tables on ``device``."""
    from ..models.scene import generate_random_scene
    from ..ops.trace import device_scene_from_numpy, prepare_scene
    from .renderer import render_device

    return device_scene_from_numpy(prepare_scene(generate_random_scene(0.0)),
                                   render_device(device))


def _band(ds, w, h, *, y0=0, band_h=None, **kw):
    """One band of the book scene at (w, h) from the reference camera, as a
    numpy [band_h, w, 3] array."""
    from ..ops.trace import render_band, viewport_arrays
    from .renderer import reference_camera

    vp = viewport_arrays(reference_camera(), w, h)
    band_h = h if band_h is None else band_h
    return render_band(ds, vp, band_h=band_h, width=w, y0=y0, seed_y0=y0,
                       offset_x=0, skip_tmax=True, **kw).cpu().numpy()


def _render_golden_config(backend: str, multi_tile: bool, m=None, rr=None,
                          spp: int = SPP, device="cuda"):
    if multi_tile:
        w, h, depth = 128, 72, 8
        m = 1 if m is None else m
    else:
        w, h, depth = W, H, DEPTH
        m = 3 if m is None else m
    out = _band(_book(device), w, h, spp=spp, number=0, max_depth=depth,
                backend=backend, pixels_per_lane=m, rr=rr)
    return out, (w, h)


def golden_check(backend: str = "mega", golden_path: Optional[str] = None,
                 multi_tile: bool = False, mode: str = "exact",
                 device="cuda") -> dict:
    """Render the golden config with ``backend`` on ``device`` and compare
    against the stored CPU-oracle artifact.  Passes on the statistical
    comparator's ``matches()`` (per-tile z-scores within sampling error and
    < 2% mean shift); the flipped-pixel counts are diagnostics."""
    from ..utils.compare import compare_accums

    if multi_tile:
        golden = np.load(golden_path or GOLDEN_MT)
    else:
        golden = np.load(golden_path or GOLDEN)
    out, (w, h) = _render_golden_config(
        backend, multi_tile, rr=_fast_rr() if mode == "fast" else None,
        device=device)
    diff = np.abs(out - golden)
    bad = int((diff.max(axis=2) > 1e-3).sum())
    # the tile size must DIVIDE the golden dims or compare_accums silently
    # crops the remainder out of the z gate: 8 | (128, 72); 2 | (24, 14)
    res = compare_accums(out, golden, SPP, SPP, tile=8 if multi_tile else 2)
    return {
        "backend": backend,
        "mode": mode,
        "bad_px": bad,
        "total_px": w * h,
        "max_diff": float(diff.max()),
        "mean_rel": round(res.mean_rel_diff, 6),
        "tile_p95_z": round(res.tile_p95_z, 3),
        "psnr_db": round(res.psnr_db, 2),
        "ok": bool(res.matches()),
    }


FAST_CHECK_SPP = 64  # at 2 spp the z gate compares noise with noise; at 64
# its sampling noise is ~5.7x smaller while a bias term is unchanged


def fast_check(spp: int = FAST_CHECK_SPP, device="cuda") -> dict:
    """Fast (Russian-roulette) vs exact mode on ``device``, compared
    statistically on the multi-tile golden config at ``spp`` samples: fast
    mode's estimator is unbiased."""
    from ..utils.compare import compare_accums

    exact, (w, h) = _render_golden_config("grid", multi_tile=True, spp=spp,
                                          device=device)
    fast, _ = _render_golden_config("grid", multi_tile=True, rr=_fast_rr(),
                                    spp=spp, device=device)
    res = compare_accums(fast, exact, spp, spp, tile=8)
    return {
        "check": "fast==exact (statistical)",
        "rr": list(_fast_rr()),
        "spp": spp,
        "mean_rel": round(res.mean_rel_diff, 6),
        "tile_p95_z": round(res.tile_p95_z, 3),
        "psnr_db": round(res.psnr_db, 2),
        "ok": bool(res.matches()),
    }


def merge_check(device="cuda") -> dict:
    """In-kernel call merge vs host-loop calls, compared bitwise (multi-tile
    golden config, 2 calls of 1 spp): the merge keeps the accumulation
    order and the kernel's ray regeneration is the driver's formula."""
    import torch

    w, h, depth = 128, 72, 8
    ds = _book(device)

    def call(number, accum=None, n_calls=None, spp_last=None):
        return _band(ds, w, h, spp=1, number=number,
                     accum_init=None if accum is None else torch.from_numpy(accum),
                     max_depth=depth, backend="grid", pixels_per_lane=1,
                     n_calls=n_calls, spp_last=spp_last)

    a = call(1, accum=call(0))
    b = call(0, n_calls=2, spp_last=1)
    ndiff = int((a != b).any(axis=2).sum())
    return {
        "check": "call_merge==host_loop",
        "diff_px": ndiff,
        "total_px": w * h,
        "bit_identical": bool(ndiff == 0),
        "max_diff": float(np.abs(a - b).max()),
    }


def bandsplit_check(backend: str = "grid", n_bands: int = 4, device="cuda") -> dict:
    """Row-band split vs whole-frame render, compared bitwise: the per-band
    renders a multi-device render runs (global-seed mode)."""
    w, h, depth = 128, 72, 8
    assert h % n_bands == 0
    bh = h // n_bands
    ds = _book(device)

    def band(y0, band_h):
        return _band(ds, w, h, y0=y0, band_h=band_h, spp=SPP, number=0,
                     max_depth=depth, backend=backend, pixels_per_lane=1)

    whole = band(0, h)
    split = np.concatenate([band(i * bh, bh) for i in range(n_bands)], axis=0)
    ndiff = int((whole != split).any(axis=2).sum())
    return {
        "check": f"bandsplit({n_bands})==whole",
        "backend": backend,
        "diff_px": ndiff,
        "total_px": w * h,
        "bit_identical": bool(ndiff == 0),
        "max_diff": float(np.abs(whole - split).max()),
    }


def bitident_check(backend_a: str = "grid", backend_b: str = "mega",
                   mode: str = "exact", device="cuda") -> dict:
    """Render the multi-tile golden config with two backends and compare
    bitwise: grid == mega in both modes (fast mode's RR is deterministic
    given seeds)."""
    rr = _fast_rr() if mode == "fast" else None
    a, (w, h) = _render_golden_config(backend_a, multi_tile=True, rr=rr,
                                      device=device)
    b, _ = _render_golden_config(backend_b, multi_tile=True, rr=rr,
                                 device=device)
    ndiff = int((a != b).any(axis=2).sum())
    return {
        "backends": f"{backend_a}=={backend_b}",
        "mode": mode,
        "diff_px": ndiff,
        "total_px": w * h,
        "bit_identical": bool(ndiff == 0),
        "max_diff": float(np.abs(a - b).max()),
    }
