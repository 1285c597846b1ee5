#!/usr/bin/env python3
"""Where the time of one ``raytrace_tpu_torch.ray_trace`` frame goes, on one GPU.

Run from the repository root with no arguments: ``python3
torch_breakdown.py``.  It needs one CUDA device and builds the port's kernels
on first use.  It times, for the book scene at 1920x1080 and 16 spp (the
smoke run's main path), each step three times:

- the host steps of a render: scene generation, ``prepare_scene``, the table
  upload, ``Renderer`` construction (host clock);
- ``Renderer.render`` in exact and fast mode, steady state after one warm-up
  (host clock around work that ends in ``torch.cuda.synchronize()``);
- one instrumented render per mode: each grid-kernel launch timed with CUDA
  events, with the number of lanes alive going into it;
- the tonemap and copy to the host, and the PNG encode;
- the same exact frame on the brute-force megakernel;
- the device time of the grid kernel under ``torch.profiler``.

It prints the card's name and power limit, one JSON object of the timings,
then one of the profiler's device time.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SPP, WIDTH, HEIGHT, REPS = 16, 1920, 1080, 3


def wall(fn):
    """(result, seconds) of ``fn()``, synchronised with the device."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def instrumented(renderer, mod, name):
    """Render once with each launch of ``mod.<name>`` timed by CUDA events;
    returns (wall s, per-launch ms, alive lanes going into each launch)."""
    import torch

    orig = getattr(mod, name)
    ms, alive = [], []

    def timed(*args, **kw):
        u = args[4]  # ustate
        alive.append(int((u[mod.U_ALIVE] != 0).sum()))
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = orig(*args, **kw)
        b.record()
        b.synchronize()
        ms.append(round(a.elapsed_time(b), 3))
        return out

    timed.launches = orig.launches  # the wrapper counts through its module name
    setattr(mod, name, timed)
    try:
        _, sec = wall(renderer.render)
    finally:
        setattr(mod, name, orig)
        orig.launches = timed.launches
    return sec, ms, alive


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_breakdown: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)

    from raytrace_tpu_torch import RenderConfig
    from raytrace_tpu_torch.models.scene import generate_random_scene
    from raytrace_tpu_torch.ops import gridkernel, trace
    from raytrace_tpu_torch.ops.image import accum_to_u8
    from raytrace_tpu_torch.runtime.renderer import Renderer
    from raytrace_tpu_torch.utils.png import encode_png

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    res = {"device": torch.cuda.get_device_name(0), "spp": SPP,
           "width": WIDTH, "height": HEIGHT}
    reps = range(REPS)

    scenes = [wall(lambda: generate_random_scene(0.0)) for _ in reps]
    res["scene_gen_s"] = [s for _, s in scenes]
    scene = scenes[0][0]
    preps = [wall(lambda: trace.prepare_scene(scene)) for _ in reps]
    res["prepare_scene_s"] = [s for _, s in preps]
    res["upload_s"] = [wall(lambda: trace.device_scene_from_numpy(preps[0][0], dev))[1]
                       for _ in reps]

    def cfg(**kw):
        return RenderConfig(samples=SPP, width=WIDTH, height=HEIGHT, **kw)

    res["renderer_init_s"] = [wall(lambda: Renderer(cfg(), scene=scene, device=dev))[1]
                              for _ in reps]
    for mode in ("exact", "fast"):
        r = Renderer(cfg(mode=mode), scene=scene, device=dev)
        renders = [wall(r.render) for _ in range(REPS + 1)]  # first: warm-up
        res[f"render_{mode}_s"] = [s for _, s in renders]
        sec, ms, alive = instrumented(r, gridkernel, "grid_megakernel_step")
        res[f"{mode}_instrumented_wall_s"] = sec
        res[f"{mode}_launches"] = len(ms)
        res[f"{mode}_kernel_ms_sum"] = sum(ms)
        res[f"{mode}_kernel_ms_each"] = ms
        res[f"{mode}_alive_lanes_in"] = alive
        accum, total = renders[-1][0]
        res[f"{mode}_to_u8_s"] = [wall(lambda: accum_to_u8(accum, total).cpu().numpy())[1]
                                  for _ in reps]
        img = accum_to_u8(accum, total).cpu().numpy()
        res[f"{mode}_png_encode_s"] = [wall(lambda: encode_png(img))[1] for _ in reps]

    r = Renderer(cfg(backend="mega"), scene=scene, device=dev)
    res["mega_render_exact_s"] = [wall(r.render)[1] for _ in range(REPS + 1)]

    res["render_exact_median_s"] = statistics.median(res["render_exact_s"][1:])
    print(json.dumps(res), flush=True)

    r = Renderer(cfg(), scene=scene, device=dev)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        wall(r.render)
    dev_us = [e.device_time_total for e in prof.key_averages()
              if "grid_megakernel" in e.key]
    print(json.dumps({"profiler_grid_kernel_device_ms":
                      (sum(dev_us) / 1e3) if dev_us else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
