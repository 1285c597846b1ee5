"""Quirk Q5: f32 vs f64 accumulation error at 1080p / 10k spp.

Port of ``scripts/measure_f64.py``.  The reference sums samples in dvec3
(shader.rgen:55, forcing shaderFloat64); the port accumulates f32 on the
device.  This renders the whole benchmark twice with identical RNG streams
(the book scene, exact mode, the renderer's backend: the grid kernel),
in calls of 1000 spp: (a) ``accum_dtype="float32"``, the accumulator
carried through the calls in f32; (b) ``accum_dtype="float64"``, each
call's f32 sum added into an f64 accumulator.  The only difference is the
summation's precision.  It prints each render's host-clock wall (ended by
copying the accumulator to the host), the linear relative error of (a)
against (b), and the pixels of the u8 display image that differ.  The
walls name the card and its power limit (``nvidia-smi``).

Run ``[F64_W=1920] [F64_H=1080] [F64_SPP=10000] python -m
raytrace_tpu_torch.scripts.measure_f64 [--device cpu]``: on the GPU unless
given ``--device cpu`` (it raises without one).
"""

from __future__ import annotations

import argparse
import os
import time

SPP_PER_CALL = 1000


def main(argv=None) -> dict:
    """Run both renders; returns the comparison's numbers."""
    import numpy as np

    from ..config import RenderConfig
    from ..ops.image import accum_to_u8
    from ..runtime.renderer import Renderer, render_device
    from .bench_gather import card_label

    ap = argparse.ArgumentParser(prog="python -m raytrace_tpu_torch.scripts.measure_f64",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = render_device(args.device)
    w, h = int(os.environ.get("F64_W", 1920)), int(os.environ.get("F64_H", 1080))
    spp = int(os.environ.get("F64_SPP", 10000))
    card = card_label(device)

    def run(dtype):
        cfg = RenderConfig(samples=spp, width=w, height=h, samples_per_call=SPP_PER_CALL,
                           accum_dtype=dtype)
        r = Renderer(cfg, device=device)
        t0 = time.perf_counter()
        accum, total = r.render(spp)
        accum = accum.cpu().numpy()
        print(f"{dtype}: {time.perf_counter()-t0:.1f}s ({card})", flush=True)
        return accum, total

    a32, n = run("float32")
    a64, _ = run("float64")
    a32d = a32.astype(np.float64)
    lin_rel = np.abs(a32d - a64) / np.maximum(np.abs(a64), 1e-12)
    u32_img = accum_to_u8(a32, n).astype(np.int32)
    u64_img = accum_to_u8(a64, n).astype(np.int32)
    du8 = np.abs(u32_img - u64_img)
    res = dict(max_rel=float(lin_rel.max()), mean_rel=float(lin_rel.mean()),
               differing_px=int((du8.max(axis=2) > 0).sum()), max_du8=int(du8.max()))
    print(f"linear: max_rel={res['max_rel']:.3e} mean_rel={res['mean_rel']:.3e}", flush=True)
    print(f"display u8: differing px={res['differing_px']}/{w*h} "
          f"max|d|={res['max_du8']}", flush=True)
    return res


if __name__ == "__main__":
    main()
