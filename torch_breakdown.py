#!/usr/bin/env python3
"""Where the time of one frame of ``raytrace_tpu_torch`` goes, on one GPU.

Run from the repository root: ``python3 torch_breakdown.py [--scene
book|dense|gridless]``.  It needs one CUDA device and builds the port's
kernels on first use.  ``--scene book`` (the default) times the book scene at
1920x1080 and 16 spp on the grid kernel (``ray_trace``'s main path);
``--scene dense`` times ``random_sphere_field(100_000)`` at 3840x2160 and 8
spp on the paged kernel (``render_image``'s dense-scene path); ``--scene
gridless`` times ``three_sphere_scene()`` at 1920x1080 and 16 spp on the
brute-force megakernel.  Each step is timed three times:

- the host steps of a render: scene generation, ``prepare_scene`` (for the
  dense scene also its parts: the flat-grid attempt that returns None and
  the paged-grid build), the table upload, ``Renderer`` construction (host
  clock);
- ``Renderer.render`` in exact and fast mode, steady state after one warm-up
  (host clock around work that ends in ``torch.cuda.synchronize()``);
- one instrumented render per mode: each kernel launch timed with CUDA
  events, with the number of lanes alive going into it; for the paged
  driver also the first launch's sort key, and the sort and the gather of
  the live lanes before each launch, timed the same way;
- the tonemap and copy to the host, and the PNG encode;
- the same exact frame on the brute-force megakernel (book scene only: on
  100k spheres it would take minutes);
- the exact frame's wall and launches at each iteration count per launch of
  ``K_SWEEP`` (dense: the paged interval ``scaled_k``; gridless:
  ``megakernel.K_STEPS``); output bits do not depend on it;
- the device time of the kernel under ``torch.profiler``.

It prints the card's name and power limit, one JSON object of the timings,
then one of the profiler's device time.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
REPS = 3
# scene -> (spp, width, height, step module, step name)
SCENES = {"book": (16, 1920, 1080, "gridkernel", "grid_megakernel_step"),
          "dense": (8, 3840, 2160, "pagedkernel", "paged_megakernel_step"),
          "gridless": (16, 1920, 1080, "megakernel", "megakernel_step")}
DENSE_N = 100_000
K_SWEEP = {"dense": (10, 20, 40, 80), "gridless": (10, 20, 40)}


def wall(fn):
    """(result, seconds) of ``fn()``, synchronised with the device."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _events():
    import torch

    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


def instrumented(renderer, mod, name):
    """Render once with each launch of ``mod.<name>`` timed by CUDA events,
    and for the paged driver its first key, each sort and each gather;
    returns (wall s, per-launch ms, alive lanes going into each launch,
    {"key"|"sort"|"gather": per-call ms})."""
    from raytrace_tpu_torch.ops import trace

    orig = getattr(mod, name)
    glue = {"key": "_rebucket_key", "sort": "live_order", "gather": "gather_lanes"}
    orig_glue = {k: getattr(trace, f) for k, f in glue.items()}
    launch_ev, alive, glue_ev = [], [], {k: [] for k in glue}

    def timing(fn, events, on_call=None):
        def timed(*args, **kw):
            if on_call is not None:
                on_call(args)
            a, b = _events()
            a.record()
            out = fn(*args, **kw)
            b.record()
            events.append((a, b))
            return out
        return timed

    u_arg = 5 if name == "megakernel_step" else 4  # the ustate argument
    step = timing(orig, launch_ev,
                  lambda args: alive.append(int((args[u_arg][mod.U_ALIVE] != 0).sum())))
    step.launches = orig.launches  # the wrapper counts through its module name
    setattr(mod, name, step)
    for k, f in glue.items():
        setattr(trace, f, timing(orig_glue[k], glue_ev[k]))
    try:
        _, sec = wall(renderer.render)
    finally:
        setattr(mod, name, orig)
        for k, f in glue.items():
            setattr(trace, f, orig_glue[k])
        orig.launches = step.launches
    ms = [round(a.elapsed_time(b), 3) for a, b in launch_ev]
    glue_ms = {k: [round(a.elapsed_time(b), 3) for a, b in ev] for k, ev in glue_ev.items()}
    return sec, ms, alive, glue_ms


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=sorted(SCENES), default="book")
    scene_name = ap.parse_args().scene
    if not torch.cuda.is_available():
        print("torch_breakdown: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)

    import importlib

    from raytrace_tpu_torch import RenderConfig
    from raytrace_tpu_torch.models.grid import build_grid
    from raytrace_tpu_torch.models.paged_grid import build_paged_grid
    from raytrace_tpu_torch.models.scene import (generate_random_scene,
                                                 random_sphere_field, three_sphere_scene)
    from raytrace_tpu_torch.ops import megakernel, pagedkernel, trace
    from raytrace_tpu_torch.ops.image import accum_to_u8
    from raytrace_tpu_torch.ops.intersect import sphere_table
    from raytrace_tpu_torch.runtime.renderer import Renderer
    from raytrace_tpu_torch.utils.png import encode_png

    spp, width, height, mod_name, step_name = SCENES[scene_name]
    mod = importlib.import_module(f"raytrace_tpu_torch.ops.{mod_name}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    res = {"device": torch.cuda.get_device_name(0), "scene": scene_name, "spp": spp,
           "width": width, "height": height}
    reps = range(REPS)

    make = {"book": lambda: generate_random_scene(0.0),
            "dense": lambda: random_sphere_field(DENSE_N),
            "gridless": three_sphere_scene}[scene_name]
    scenes = [wall(make) for _ in reps]
    res["scene_gen_s"] = [s for _, s in scenes]
    scene = scenes[0][0]
    preps = [wall(lambda: trace.prepare_scene(scene)) for _ in reps]
    res["prepare_scene_s"] = [s for _, s in preps]
    if scene_name == "dense":
        table = sphere_table(scene)
        res["build_grid_attempt_s"] = [wall(lambda: build_grid(scene, table))[1] for _ in reps]
        res["build_paged_grid_s"] = [wall(lambda: build_paged_grid(scene, table))[1]
                                     for _ in reps]
        g = preps[0][0].paged
        res["paged_table_bytes"] = int(g.geom.nbytes + g.lids.nbytes + g.attrs.nbytes)
    res["upload_s"] = [wall(lambda: trace.device_scene_from_numpy(preps[0][0], dev))[1]
                       for _ in reps]

    def cfg(**kw):
        return RenderConfig(samples=spp, width=width, height=height, **kw)

    res["renderer_init_s"] = [wall(lambda: Renderer(cfg(), scene=scene, device=dev))[1]
                              for _ in reps]
    for mode in ("exact", "fast"):
        r = Renderer(cfg(mode=mode), scene=scene, device=dev)
        res[f"{mode}_backend"], res[f"{mode}_m"] = r.backend, r.pixels_per_lane
        renders = [wall(r.render) for _ in range(REPS + 1)]  # first: warm-up
        res[f"render_{mode}_s"] = [s for _, s in renders]
        sec, ms, alive, glue_ms = instrumented(r, mod, step_name)
        res[f"{mode}_instrumented_wall_s"] = sec
        res[f"{mode}_launches"] = len(ms)
        res[f"{mode}_kernel_ms_sum"] = sum(ms)
        glue_sum = 0.0
        for k, v in glue_ms.items():
            if v:
                res[f"{mode}_{k}_ms_sum"] = sum(v)
                res[f"{mode}_{k}_ms_each"] = v
                glue_sum += sum(v)
        if glue_ms["gather"]:
            res[f"{mode}_rebucket_ms_per_launch"] = (
                (sum(glue_ms["sort"]) + sum(glue_ms["gather"])) / len(glue_ms["gather"]))
        res[f"{mode}_host_ms"] = sec * 1e3 - sum(ms) - glue_sum
        res[f"{mode}_kernel_ms_each"] = ms
        res[f"{mode}_alive_lanes_in"] = alive
        accum, total = renders[-1][0]
        res[f"{mode}_to_u8_s"] = [wall(lambda: accum_to_u8(accum, total).cpu().numpy())[1]
                                  for _ in reps]
        img = accum_to_u8(accum, total).cpu().numpy()
        res[f"{mode}_png_encode_s"] = [wall(lambda: encode_png(img))[1] for _ in reps]

    if scene_name == "book":
        r = Renderer(cfg(backend="mega"), scene=scene, device=dev)
        res["mega_render_exact_s"] = [wall(r.render)[1] for _ in range(REPS + 1)]

    if scene_name in K_SWEEP:
        r = Renderer(cfg(), scene=scene, device=dev)
        orig_k = (pagedkernel.scaled_k, megakernel.K_STEPS)
        for k in K_SWEEP[scene_name]:
            if scene_name == "dense":
                pagedkernel.scaled_k = lambda n, k=k: k
            else:
                megakernel.K_STEPS = k
            try:
                before = getattr(mod, step_name).launches
                walls = [wall(r.render)[1] for _ in range(REPS + 1)]  # first: warm-up
                res[f"k{k}_render_exact_s"] = walls
                res[f"k{k}_launches"] = (getattr(mod, step_name).launches - before) // (REPS + 1)
            finally:
                pagedkernel.scaled_k, megakernel.K_STEPS = orig_k

    res["render_exact_median_s"] = statistics.median(res["render_exact_s"][1:])
    print(json.dumps(res), flush=True)

    r = Renderer(cfg(), scene=scene, device=dev)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        wall(r.render)
    kernel = step_name.replace("_step", "")
    dev_us = [e.device_time_total for e in prof.key_averages() if kernel in e.key]
    print(json.dumps({f"profiler_{kernel}_device_ms":
                      (sum(dev_us) / 1e3) if dev_us else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
