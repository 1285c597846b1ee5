#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``raytrace_tpu_torch``) on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device, nvcc (``$CUDA_HOME/bin`` or ``/usr/local/cuda``)
and the repository's sources; it imports nothing of JAX.  Each phase prints
one line and raises on failure, so any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: both CUDA kernels from ``raytrace_tpu_torch/csrc`` with nvcc, and a
   PTX check that no fast-math instruction (approximate sqrt/div, rsqrt, sin)
   reached the kernels;
3. kernel vs plain version: one book-scene state at the 1920x1080 lane
   count, one launch of each kernel and one call of its plain torch version
   on the card, exact and fast mode, every state row compared (bit-equal on
   >= 99.9% of lanes), and both times in exact mode (CUDA events, median of
   several calls);
4. goldens: mega and grid against the CPU-oracle goldens (24x14: <= 3 px off
   by > 1e-4; 128x72: <= 1% of pixels off by > 1e-3), and grid == mega
   exactly at 128x72, depth 4;
5. main path, with every launch count set to 0 just before it and read
   just after it: ``raytrace_tpu_torch.ray_trace(samples=16, width=1920,
   height=1080, store_render_result=True)`` on the book scene, exact and
   fast mode, which resolves to the grid kernel; then
   ``raytrace_tpu_torch.render_image`` of the three-sphere scene at the same
   size, which has no grid tables and so resolves to the brute-force
   megakernel, the renderer's backend for every scene the grid cannot hold.
   Each kernel must have launched, and neither plain version.

Before the last line it prints the kernels' JSON record (``launches`` are the
main path's counts); the last line is ``{"ok": true, "device": {...}}``.
Images and the build log are written under ``build/smoke/`` (gitignored).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "build", "smoke")
MAIN_SPP, MAIN_W, MAIN_H = 16, 1920, 1080


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def cuda_ms(fn, reps):
    """Median CUDA-event time of ``fn()`` over ``reps`` calls (after one
    warm-up call), in milliseconds."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def compare_states(kern, plain):
    """(lanes differing in any row, max |diff| over finite f32 entries)."""
    import torch

    fk, uk = kern
    fp, up = plain
    same_f = (fk == fp) | (torch.isnan(fk) & torch.isnan(fp))
    lane_ok = same_f.all(dim=0) & (uk == up).all(dim=0)
    fin = torch.isfinite(fk) & torch.isfinite(fp)
    diff = torch.where(fin, (fk - fp).abs(), torch.zeros_like(fk))
    return int((~lane_ok).sum()), float(diff.max())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    import raytrace_tpu_torch
    from raytrace_tpu_torch import RenderConfig, _build
    from raytrace_tpu_torch.models.scene import generate_random_scene, three_sphere_scene
    from raytrace_tpu_torch.ops import gridkernel, megakernel
    from raytrace_tpu_torch.ops import trace
    from raytrace_tpu_torch.runtime import renderer as rmod

    os.makedirs(OUT, exist_ok=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. device -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    phase("device", f"{kind}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")

    # ---- 2. build ----------------------------------------------------------
    info = _build.build()
    with open(os.path.join(OUT, "build.log"), "w") as f:
        f.write(info["log"])
    bad = _build.forbidden_ptx(info["ptx"])
    if bad:
        raise RuntimeError(f"fast-math instructions in the kernels' PTX: {bad}")
    regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln]
    phase("build", f"{info['seconds']:.1f} s (0 = cached), {info['lib'].name}; "
          f"PTX clean of {', '.join(_build.FORBIDDEN_PTX)}; ptxas: {regs}")
    _build.library()

    # ---- 3. kernels vs plain versions at the 1080p lane count --------------
    scene = generate_random_scene(0.0)
    ds = trace.device_scene_from_numpy(trace.prepare_scene(scene), dev)
    cam = rmod.reference_camera()
    vp = trace.viewport_arrays(cam, MAIN_W, MAIN_H)
    skip = trace.tmax_never_binds(scene, cam)
    m = int(np.clip(-(-(MAIN_W * MAIN_H) // rmod.lanes_target(dev)), 1, rmod.M_MAX))
    atab = ds.table[:, 8:24].T.contiguous()
    records = {}
    steps = {
        "grid_megakernel_step": (
            "grid", gridkernel.grid_megakernel_step,
            gridkernel.grid_megakernel_step_plain,
            lambda k, f, u, s, v, g: k(s, v, ds.grid, f, u, **g),
            "raytrace_tpu_torch/csrc/gridkernel.cu",
            "raytrace_tpu/ops/gridkernel.py:1123"),
        "megakernel_step": (
            "mega", megakernel.megakernel_step, megakernel.megakernel_step_plain,
            lambda k, f, u, s, v, g: k(s, v, ds.table, atab, f, u, **g),
            "raytrace_tpu_torch/csrc/megakernel.cu",
            "raytrace_tpu/ops/megakernel.py:473"),
    }
    for name, (backend, kern, plain, call, src, repl) in steps.items():
        f0, u0, scal, vpr, geom = trace.pack_state(
            ds, vp, backend=backend, band_h=MAIN_H, width=MAIN_W, y0=0,
            seed_y0=0, offset_x=0, spp=MAIN_SPP, number=0, pixels_per_lane=m)
        max_err = 0.0
        for mode, rr in (("exact", None), ("fast", RenderConfig(mode="fast").rr)):
            g = dict(geom, max_depth=50, skip_tmax=skip, rr=rr)
            # advance two launches so the compared state is mid-path
            f1, u1 = call(kern, *call(kern, f0, u0, scal, vpr, g), scal, vpr, g)
            out_k = call(kern, f1, u1, scal, vpr, g)
            out_p = call(plain, f1, u1, scal, vpr, g)
            torch.cuda.synchronize()
            n_bad, err = compare_states(out_k, out_p)
            max_err = max(max_err, err)
            n = f1.shape[1]
            if mode == "exact":  # the main path's default mode is timed
                ms = cuda_ms(lambda: call(kern, f1, u1, scal, vpr, g), 5)
                plain_ms = cuda_ms(lambda: call(plain, f1, u1, scal, vpr, g), 2)
                timing = f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms per launch"
            else:
                timing = ""
            phase("kernel", f"{name} {mode}: {n} lanes (M={m}), {n_bad} lanes "
                  f"differ from the plain version, max |diff| {err}{timing}")
            if n_bad > n // 1000:
                raise RuntimeError(f"{name} {mode}: {n_bad}/{n} lanes differ (> 0.1%)")
        records[name] = dict(name=name, route="cuda", source=src, replaces=repl,
                             launches=0, max_abs_err=max_err, ms=ms,
                             plain_ms=plain_ms)

    # ---- 4. goldens --------------------------------------------------------
    def render(backend, w, h, spp, depth, m_):
        vp_ = trace.viewport_arrays(cam, w, h)
        out = trace.render_band(
            ds, vp_, band_h=h, width=w, y0=0, seed_y0=0, offset_x=0, spp=spp,
            number=0, max_depth=depth, backend=backend, pixels_per_lane=m_,
            skip_tmax=skip)
        return out.cpu().numpy()

    data = os.path.join(ROOT, "tests", "data")
    g24 = np.load(os.path.join(data, "golden_fullscene_24x14_2spp_d12.npy"))
    g128 = np.load(os.path.join(data, "golden_fullscene_128x72_2spp_d8.npy"))
    for backend in ("mega", "grid"):
        off24 = int((np.abs(render(backend, 24, 14, 2, 12, 3) - g24).max(axis=2) > 1e-4).sum())
        off128 = int((np.abs(render(backend, 128, 72, 2, 8, 1) - g128).max(axis=2) > 1e-3).sum())
        phase("golden", f"{backend}: 24x14 {off24}/336 px off by > 1e-4; "
              f"128x72 {off128}/9216 px off by > 1e-3")
        if off24 > 3 or off128 > 9216 // 100:
            raise RuntimeError(f"{backend} disagrees with the oracle goldens")
    a = render("grid", 128, 72, 2, 4, 1)
    b = render("mega", 128, 72, 2, 4, 1)
    n_diff = int((a != b).any(axis=2).sum())
    phase("golden", f"grid == mega at 128x72 depth 4: {n_diff} px differ")
    if n_diff:
        raise RuntimeError("grid and mega differ at depth 4")

    # the exactness gate every bench run of the JAX package makes (bench.py:121):
    # grid == mega through the public entry point, on the 128x72 golden config
    seen = {}
    orig_render = rmod.Renderer.render

    def spy_render(self, *args, **kw):  # records what the entry point resolved
        accum, total = orig_render(self, *args, **kw)
        seen.update(backend=self.backend, accum=accum, m=self.pixels_per_lane)
        return accum, total

    rmod.Renderer.render = spy_render
    imgs = {}
    for backend in ("grid", "mega"):
        raytrace_tpu_torch.ray_trace(samples=2, width=128, height=72, max_depth=8,
                                     backend=backend, pixels_per_lane=1)
        imgs[backend] = seen["accum"]
    n_diff = int((imgs["grid"] != imgs["mega"]).any(dim=2).sum())
    phase("golden", f"ray_trace grid == mega at 128x72 depth 8: {n_diff} px differ")
    if n_diff:
        raise RuntimeError("grid and mega differ through ray_trace")

    # ---- 5. main path ------------------------------------------------------
    counters = (gridkernel.grid_megakernel_step, megakernel.megakernel_step,
                gridkernel.grid_megakernel_step_plain,
                megakernel.megakernel_step_plain)

    def launches():
        return {c.__name__: c.launches for c in counters}

    def book(mode):
        path = os.path.join(OUT, f"render_{MAIN_W}x{MAIN_H}_{MAIN_SPP}spp_{mode}.png")
        img = raytrace_tpu_torch.ray_trace(
            samples=MAIN_SPP, width=MAIN_W, height=MAIN_H,
            store_render_result=True, out_path=path, mode=mode)
        return img, f"png {os.path.getsize(path)} B"

    def gridless():
        cfg = RenderConfig(samples=MAIN_SPP, width=MAIN_W, height=MAIN_H)
        return raytrace_tpu_torch.render_image(cfg, scene=three_sphere_scene()), ""

    runs = (("book scene exact", book, ("exact",), "grid"),
            ("book scene fast", book, ("fast",), "grid"),
            ("three-sphere scene exact", gridless, (), "mega"))
    results = []
    for c in counters:
        c.launches = 0
    for label, fn, args, want in runs:
        before = launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, extra = fn(*args)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        ran = {k: v - before[k] for k, v in launches().items()}
        results.append((label, sec, img, ran, dict(seen), extra, want))
    main_counts = launches()
    rmod.Renderer.render = orig_render

    step_of = {"grid": "grid_megakernel_step", "mega": "megakernel_step"}
    for label, sec, img, ran, got, extra, want in results:
        finite = bool(torch.isfinite(got["accum"]).all())
        mean = float(img.mean())
        phase("main", f"{label} {MAIN_W}x{MAIN_H} {MAIN_SPP} spp: {sec:.3f} s, "
              f"{MAIN_SPP * MAIN_W * MAIN_H / sec:.4g} samples*px/s, backend "
              f"{got['backend']} (M={got['m']}), launches {ran}, finite {finite}, "
              f"u8 mean {mean:.2f} {extra}")
        if got["backend"] != want or ran[step_of[want]] == 0:
            raise RuntimeError(f"{label}: the main path did not run the {want} kernel")
        if not finite or img.shape != (MAIN_H, MAIN_W, 3) or not 20.0 < mean < 235.0:
            raise RuntimeError(f"{label}: implausible image")
    phase("main", f"launches over the main path {main_counts}")
    if main_counts["grid_megakernel_step_plain"] or main_counts["megakernel_step_plain"]:
        raise RuntimeError("a plain version ran on the main path")
    for name in records:
        if main_counts[name] == 0:
            raise RuntimeError(f"{name} did not launch on the main path")
        records[name]["launches"] = main_counts[name]

    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
