#!/usr/bin/env python3
"""Where the time of one frame of ``raytrace_tpu_torch`` goes, on one GPU.

Run from the repository root: ``python3 torch_breakdown.py [--scene
book|dense|gridless|pallas|headline|step|bands|first-call] [--root DIR]``.  It needs one CUDA
device and builds the port's kernels on first use.  ``--scene book`` (the default) times the book
scene at 1920x1080 and 16 spp on the grid kernel (``ray_trace``'s main
path); ``--scene dense`` times ``random_sphere_field(100_000)`` at 3840x2160
and 8 spp on the paged kernel (``render_image``'s dense-scene path);
``--scene gridless`` times ``three_sphere_scene()`` at 1920x1080 and 16 spp
on the brute-force megakernel; ``--scene pallas`` times the book scene at
1920x1080 and 2 spp on the ``pallas`` backend (the eager spec loop around the
fused intersect kernel).  Each step is timed three times:

- the host steps of a render: scene generation, ``prepare_scene`` (for the
  dense scene also its parts: the flat-grid attempt that returns None and
  the paged-grid build), the table upload, ``Renderer`` construction (host
  clock);
- ``Renderer.render`` in exact and fast mode, steady state after one warm-up
  (host clock around work that ends in ``torch.cuda.synchronize()``);
- one instrumented render per mode: each kernel launch timed with CUDA
  events, with the number of lanes alive going into it, and the tail: the
  launches that start with under 97% of the band's lanes alive, their
  kernel time and its share; for the paged driver also the first launch's
  sort key, and the sort and the gather of the live lanes before each
  launch, timed the same way; for the grid driver also the compaction
  (``live_lanes``, ``gather_lanes``), and the same render with compaction
  off (every lane launched until none is alive, as the grid driver did
  before it compacted), its steady walls timed in turns with the compacted
  render's; for ``pallas`` the kernel time against the host time per
  spec-loop iteration;
- the tonemap and copy to the host, and the PNG encode;
- the same exact frame on the brute-force megakernel (book scene only: on
  100k spheres it would take minutes);
- the exact frame's wall and launches at each iteration count per launch of
  ``K_SWEEP`` (dense: the paged interval ``scaled_k``; gridless:
  ``megakernel.K_STEPS``); for the book scene the same, and the kernel
  time, over every combination of ``K_SWEEP`` (``gridkernel.K_STEPS``),
  ``J_SWEEP`` (``gridkernel.J_STEPS``, cells per iteration) and ``M_SWEEP``
  (pixels per lane); output bits depend on none of them;
- the device time of the kernel under ``torch.profiler``.

It prints the card's name and power limit, one JSON object of the timings,
then one of the profiler's device time.

``--scene headline`` renders the JAX bench's operating point (the book scene
at 1920x1080 x 10,000 spp in fast mode, 2500 spp per call) four ways, with
the in-kernel call merge on (4 calls per dispatch) or off and balanced lanes
on (a 32-spp probe) or off: the walls in turns (A B C D D C B A), then one
instrumented render of each: its kernel time summed over launches, the
launches, the tail share and the host loop; with ``--m M [M ...]`` instead
the shipped way (merge and balance) at each of those pixels per lane.  ``--scene step`` times one
launch of the production grid kernel at the smoke run's check state (the
1080p x 16 spp exact state two launches in, on the driver's live lanes; CUDA
events, median of ``STEP_REPS``) and prints one JSON line; with ``--root
DIR`` it imports ``raytrace_tpu_torch`` from the checkout at DIR instead, so
that two commits' kernels can be timed in turns, each in its own process.
``--scene bands`` times the book scene at 1920x1080 x 16 spp, exact (or
with ``--bands-of dense`` the 100k-sphere field at 3840x2160 x 8 spp), as
four row bands of the one card (``MultiChipRenderer`` over
``[cuda:0] * 4``) against the whole frame: the walls in turns of the whole
(``Renderer.render_call``), the shipped bands (each stepped from one thread
once its last launch is done, a CUDA stream each), the same steps taken in
turns whether or not the band's launch is done (lockstep), the four bands
one after another on the calling thread, a thread and a stream per band,
and a thread per band on the default stream; then one instrumented banded
call of the shipped and of the lockstep way (each band's launches, kernel
time by CUDA events on its stream, the host clock at each launch) and the
profiler's top host and device entries over one banded call.
``--scene first-call`` (run it in a process of its own) renders the 100k
field at 320x180 x 8 spp, fast, after a 1-spp warm-up, twice, each time
with the paged render's launches, key, sorts and gathers timed by CUDA
events: where the process's first such call spends the time the second
does not.
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
SWEEP_REPS = 7
# scene -> (spp, width, height, step module, step name, backend)
SCENES = {"book": (16, 1920, 1080, "gridkernel", "grid_megakernel_step", "auto"),
          "dense": (8, 3840, 2160, "pagedkernel", "paged_megakernel_step", "auto"),
          "gridless": (16, 1920, 1080, "megakernel", "megakernel_step", "auto"),
          "pallas": (2, 1920, 1080, "pallas_intersect", "intersect_shade_pallas", "pallas")}
# the device kernel's name in the profiler, by scene
PROFILED = {"book": "grid_megakernel_step_kernel", "dense": "paged_megakernel_step_kernel",
            "gridless": "megakernel_step_kernel", "pallas": "intersect_shade_kernel"}
DENSE_N = 100_000
K_SWEEP = {"dense": (10, 20, 40, 80), "gridless": (10, 20, 40), "book": (40, 80, 160)}
J_SWEEP = {"2": 2, "4": 4, "close": 1 << 30}  # close: march until the segment closes
M_SWEEP = (2, 4, 8)
TAIL = 0.97  # a launch starting with fewer of the band's lanes alive is the tail
HEADLINE = dict(samples=10_000, width=1920, height=1080, mode="fast", samples_per_call=2500)
HEADLINE_WAYS = {"merge+balance": dict(calls_per_exec=4, balance_spp=32),
                 "merge": dict(calls_per_exec=4), "balance": dict(balance_spp=32),
                 "neither": {}}
STEP_REPS = 21
FIRST_CALL = dict(samples=8, width=320, height=180, mode="fast")


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
    and each band's set-up (``pack_state``, with the paged driver's first
    key), and for the paged driver each sort and each gather (the grid
    driver: each ``live_lanes`` and gather); returns (wall s, per-launch ms,
    alive lanes going into each launch (None for the fused intersect
    kernel), {"setup"|"sort"|"live"|"gather": per-call ms})."""
    from raytrace_tpu_torch.ops import trace

    orig = getattr(mod, name)
    glue = {"setup": "pack_state", "sort": "live_order", "live": "live_lanes",
            "gather": "gather_lanes"}
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

    u_arg = {"megakernel_step": 5, "intersect_shade_pallas": None}.get(name, 4)  # ustate
    step = timing(orig, launch_ev, None if u_arg is None else
                  lambda args: alive.append(int((args[u_arg][mod.U_ALIVE] != 0).sum())))
    step.launches = orig.launches  # the wrapper counts through its module name
    setattr(mod, name, step)
    wrapped = {k: timing(orig_glue[k], glue_ev[k]) for k in glue}
    wrapped["setup"].launches = trace.pack_state.launches  # it counts through its name
    for k, f in glue.items():
        setattr(trace, f, wrapped[k])
    try:
        _, sec = wall(renderer.render)
    finally:
        setattr(mod, name, orig)
        for k, f in glue.items():
            setattr(trace, f, orig_glue[k])
        orig.launches = step.launches
        orig_glue["setup"].launches = wrapped["setup"].launches
    ms = [round(a.elapsed_time(b), 3) for a, b in launch_ev]
    glue_ms = {k: [round(a.elapsed_time(b), 3) for a, b in ev] for k, ev in glue_ev.items()}
    return sec, ms, alive, glue_ms


def tail_stats(ms, alive):
    """(tail launches, their kernel ms, their share of the kernel time): the
    launches that start with fewer than TAIL of the first launch's lanes."""
    tail = [m for m, a in zip(ms, alive) if a < TAIL * alive[0]]
    return len(tail), sum(tail), sum(tail) / sum(ms)


def first_call(res):
    """``--scene first-call``: in this fresh process, ``random_sphere_field(
    100_000)`` at FIRST_CALL (320x180 x 8 spp, fast; the paged kernel)
    after one 1-spp warm-up call, rendered ``instrumented`` twice: each
    part's summed time (CUDA events, which include the device's wait for
    the host) in the process's first 8-spp call against the second."""
    from raytrace_tpu_torch import RenderConfig
    from raytrace_tpu_torch.models.scene import random_sphere_field
    from raytrace_tpu_torch.ops import pagedkernel
    from raytrace_tpu_torch.runtime.renderer import Renderer

    import torch

    def allocator():  # the caching allocator's device allocations and retries
        st = torch.cuda.memory_stats()
        return {k: st.get(k, 0) for k in ("num_device_alloc", "num_alloc_retries",
                                          "reserved_bytes.all.current")}

    r = Renderer(RenderConfig(**FIRST_CALL), scene=random_sphere_field(DENSE_N))
    wall(lambda: r.render_call(1))  # the warm-up, as stretch_reps and stretch_bench do
    for i in (1, 2):
        before = allocator()
        sec, ms, alive, glue = instrumented(r, pagedkernel, "paged_megakernel_step")
        after = allocator()
        slow = sorted(range(len(ms)), key=lambda j: -ms[j])[:3]
        res[f"call_{i}"] = {
            "allocator_delta": {k: after[k] - before[k] for k in after},
            "wall_s": round(sec, 4), "launches": len(ms), "kernel_ms": round(sum(ms), 3),
            **{f"{k}_ms": round(sum(v), 3) for k, v in glue.items() if v},
            "slowest_launches": [(j, ms[j], alive[j]) for j in slow],
            "slowest_sorts": sorted(glue["sort"], reverse=True)[:3],
            "slowest_gathers": sorted(glue["gather"], reverse=True)[:3]}
    print(json.dumps(res))


def headline(res, ms_sweep=None):
    """The JAX bench's operating point four ways: merge on/off x balance
    on/off (or the shipped way at each M of ``ms_sweep``), walls in turns
    and one instrumented render each."""
    from raytrace_tpu_torch import RenderConfig
    from raytrace_tpu_torch.ops import gridkernel
    from raytrace_tpu_torch.runtime.renderer import Renderer

    ways = HEADLINE_WAYS
    if ms_sweep:
        ways = {f"m{m}": dict(HEADLINE_WAYS["merge+balance"], pixels_per_lane=m)
                for m in ms_sweep}
    rs = {}
    for name, kw in ways.items():
        r = Renderer(RenderConfig(**HEADLINE, **kw), device="cuda")
        res[f"{name}_warmup_s"] = wall(lambda: r.render_call(4))[1]  # runs the probe
        if r.balance_stats:
            res[f"{name}_balance"] = r.balance_stats
        rs[name] = r
    order = list(ways)
    walls = {name: [] for name in order}
    for name in order + order[::-1]:
        walls[name].append(wall(rs[name].render)[1])
    res["walls_in_turns_s"] = walls
    for name, r in rs.items():
        sec, ms, alive, glue_ms = instrumented(r, gridkernel, "grid_megakernel_step")
        n_tail, tail_ms, share = tail_stats(ms, alive)
        glue = sum(sum(v) for v in glue_ms.values())
        res[name] = dict(instrumented_wall_s=sec, kernel_ms_sum=sum(ms), launches=len(ms),
                         tail_launches=n_tail, tail_kernel_ms=tail_ms, tail_share=share,
                         compaction_ms_sum=glue, host_ms=sec * 1e3 - sum(ms) - glue)
    print(json.dumps(res), flush=True)


def step(res):
    """One launch of the production grid kernel at the smoke run's check
    state, timed with CUDA events; only API that every version of the port
    has, so that ``--root`` can point at an older checkout."""
    import numpy as np
    import torch

    from raytrace_tpu_torch.models.scene import generate_random_scene
    from raytrace_tpu_torch.ops import gridkernel, trace
    from raytrace_tpu_torch.runtime import renderer as rmod

    dev = torch.device("cuda", 0)
    spp, w, h = SCENES["book"][:3]
    scene = generate_random_scene(0.0)
    ds = trace.device_scene_from_numpy(trace.prepare_scene(scene), dev)
    cam = rmod.reference_camera()
    m = int(np.clip(-(-(w * h) // rmod.lanes_target(dev, "grid")), 1, rmod.M_MAX))
    f, u, scal, vpr, geom = trace.pack_state(
        ds, trace.viewport_arrays(cam, w, h), backend="grid", band_h=h, width=w, y0=0,
        seed_y0=0, offset_x=0, spp=spp, number=0, pixels_per_lane=m)
    acc = trace.home_accum(None, geom["p_total"], dev)
    kw = dict(geom, max_depth=50, skip_tmax=trace.tmax_never_binds(scene, cam), rr=None,
              k_steps=gridkernel.K_STEPS, j_steps=gridkernel.J_STEPS)

    def launch(f_, u_):
        return gridkernel.grid_megakernel_step(scal, vpr, ds.grid, f_, u_, acc, **kw)

    def live(f_, u_):
        return trace.gather_lanes(f_, u_, trace.live_lanes(u_[gridkernel.U_ALIVE]))

    for _ in range(2):
        f, u = launch(*live(f, u))
    f, u = live(f, u)
    launch(f, u)  # warm-up
    ms = []
    for _ in range(STEP_REPS):
        a, b = _events()
        a.record()
        launch(f, u)
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    res.update(m=m, live_lanes=f.shape[1], step_ms_median=statistics.median(ms), step_ms=ms)
    print(json.dumps(res), flush=True)


BANDS = 4


def bands(res, scene_name="book"):
    """A frame as four row bands of the one card against the whole: walls in
    turns, then one instrumented banded call of the shipped way and of the
    lockstep way, then one profiled banded call."""
    import threading

    import torch

    from raytrace_tpu_torch import RenderConfig
    from raytrace_tpu_torch.models.scene import random_sphere_field
    from raytrace_tpu_torch.ops import gridkernel, pagedkernel, trace
    from raytrace_tpu_torch.parallel.sharding import MultiChipRenderer
    from raytrace_tpu_torch.runtime.renderer import Renderer

    dev = torch.device("cuda", 0)
    spp, w, h = SCENES[scene_name][:3]
    cfg = RenderConfig(samples=spp, width=w, height=h)
    scene = random_sphere_field(DENSE_N) if scene_name == "dense" else None
    whole = Renderer(cfg, scene=scene, device=dev)
    r = MultiChipRenderer(cfg, scene=scene, devices=[dev] * BANDS)
    res["bands_of"] = scene_name
    res["backend"] = r.backend

    def band_steps(i):
        return r.band_steps(r.bands[i], spp)

    def band(i):
        return trace.run_steps(band_steps(i))

    def serial():  # the four bands one after another on the calling thread
        return torch.cat([band(i) for i in range(BANDS)])

    def lockstep():
        """The bands stepped in turns, each step taken whether or not its
        band's last launch is done (so it blocks on it in its host sync)."""
        main = torch.cuda.current_stream(dev)
        streams = [torch.cuda.Stream(dev) for _ in range(BANDS)]
        for st in streams:
            st.wait_stream(main)
        gens = [band_steps(i) for i in range(BANDS)]
        outs = [None] * BANDS
        running = list(range(BANDS))
        while running:
            for i in list(running):
                with torch.cuda.stream(streams[i]):
                    try:
                        next(gens[i])
                    except StopIteration as stop:
                        outs[i] = stop.value
                        streams[i].synchronize()
                        running.remove(i)
        return torch.cat(outs)

    def threads(own_stream):  # a thread per band, on a stream of its own or not
        outs = [None] * BANDS
        main = torch.cuda.current_stream(dev)

        def run(i):
            if own_stream:
                st = torch.cuda.Stream(dev)
                st.wait_stream(main)
                with torch.cuda.stream(st):
                    outs[i] = band(i)
                st.synchronize()
            else:
                outs[i] = band(i)
                torch.cuda.default_stream(dev).synchronize()

        ths = [threading.Thread(target=run, args=(i,)) for i in range(BANDS)]
        for th in ths:
            th.start()
        for th in ths:
            th.join()
        return torch.cat(outs)

    ways = {"whole": lambda: whole.render_call(spp), "in_turns": lambda: r.render_call(spp),
            "lockstep": lockstep, "serial": serial, "threads": lambda: threads(True),
            "threads_default_stream": lambda: threads(False)}
    ref = ways["whole"]()
    for name, fn in ways.items():
        out = fn()
        res[f"{name}_px_differ"] = int((out != ref).any(dim=2).sum())
    order = list(ways)
    walls = {name: [] for name in order}
    for name in order + order[::-1] + order + order[::-1]:
        walls[name].append(wall(ways[name])[1])
    res["walls_in_turns_s"] = walls
    res["walls_median_ms"] = {k: statistics.median(v) * 1e3 for k, v in walls.items()}

    # one banded call of each stepping way: each launch timed with CUDA
    # events on its band's stream and stamped on the host clock
    mod, name = (pagedkernel, "paged_megakernel_step") if r.backend == "paged" else \
        (gridkernel, "grid_megakernel_step")
    orig = getattr(mod, name)
    for way in ("in_turns", "lockstep"):
        log = []

        def step(*args, **kw):
            a, b = _events()
            t0 = time.perf_counter()
            a.record()
            out = orig(*args, **kw)
            b.record()
            log.append((torch.cuda.current_stream(dev).cuda_stream, t0, a, b,
                        int(args[3].shape[1])))
            return out

        step.launches = orig.launches
        setattr(mod, name, step)
        try:
            t_start = time.perf_counter()
            _, sec = wall(ways[way])
        finally:
            setattr(mod, name, orig)
            orig.launches = step.launches
        per_band = {"wall_ms": round(sec * 1e3, 3)}
        for stream, t0, a, b, lanes in log:
            d = per_band.setdefault(str(stream), dict(launches=0, kernel_ms=0.0, lanes=[],
                                                      issue_ms=[]))
            d["launches"] += 1
            d["kernel_ms"] += a.elapsed_time(b)
            d["lanes"].append(lanes)
            d["issue_ms"].append(round((t0 - t_start) * 1e3, 3))
        res[f"instrumented_{way}"] = per_band

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        wall(lambda: r.render_call(spp))
    ka = prof.key_averages()
    res["profiler_top_host_ms"] = {e.key: round(e.self_cpu_time_total / 1e3, 3) for e in
                                   sorted(ka, key=lambda e: -e.self_cpu_time_total)[:12]}
    res["profiler_top_device_ms"] = {e.key: round(e.device_time_total / 1e3, 3) for e in
                                     sorted(ka, key=lambda e: -e.device_time_total)[:8]}
    print(json.dumps(res), flush=True)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=sorted(SCENES) + ["headline", "step", "bands",
                                                         "first-call"],
                    default="book")
    ap.add_argument("--root", default=ROOT,
                    help="the checkout to import raytrace_tpu_torch from (--scene step)")
    ap.add_argument("--bands-of", choices=("book", "dense"), default="book",
                    help="the scene to split into four bands (--scene bands)")
    ap.add_argument("--m", type=int, nargs="+",
                    help="pixels per lane to sweep the shipped way at (--scene headline)")
    args = ap.parse_args()
    scene_name = args.scene
    if not torch.cuda.is_available():
        print("torch_breakdown: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    if scene_name in ("headline", "step", "bands", "first-call"):
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
        res = {"device": torch.cuda.get_device_name(0), "scene": scene_name,
               "root": os.path.abspath(args.root)}
        if scene_name == "headline":
            headline(res, args.m)
        elif scene_name == "bands":
            bands(res, args.bands_of)
        elif scene_name == "first-call":
            first_call(res)
        else:
            step(res)
        return 0

    import importlib

    from raytrace_tpu_torch import RenderConfig
    from raytrace_tpu_torch.models.grid import build_grid
    from raytrace_tpu_torch.models.paged_grid import build_paged_grid
    from raytrace_tpu_torch.models.scene import (generate_random_scene,
                                                 random_sphere_field, three_sphere_scene)
    from raytrace_tpu_torch.ops import gridkernel, megakernel, pagedkernel, trace
    from raytrace_tpu_torch.ops.image import accum_to_u8
    from raytrace_tpu_torch.ops.intersect import sphere_table
    from raytrace_tpu_torch.runtime.renderer import Renderer
    from raytrace_tpu_torch.utils.png import encode_png

    spp, width, height, mod_name, step_name, backend = SCENES[scene_name]
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
            "gridless": three_sphere_scene,
            "pallas": lambda: generate_random_scene(0.0)}[scene_name]
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
        return RenderConfig(samples=spp, width=width, height=height,
                            **dict(dict(backend=backend), **kw))

    def instrumented_into(r, prefix):
        """An instrumented render of ``r`` into ``res`` under ``prefix``: the
        second of two, so that the first pays for the events' and the
        allocator's first use."""
        instrumented(r, mod, step_name)
        sec, ms, alive, glue_ms = instrumented(r, mod, step_name)
        res[f"{prefix}_instrumented_wall_s"] = sec
        res[f"{prefix}_launches"] = len(ms)
        res[f"{prefix}_kernel_ms_sum"] = sum(ms)
        glue_sum = 0.0
        for k, v in glue_ms.items():
            if v:
                res[f"{prefix}_{k}_ms_sum"] = sum(v)
                res[f"{prefix}_{k}_ms_each"] = v
                glue_sum += sum(v)
        if glue_ms["gather"] and glue_ms["sort"]:
            res[f"{prefix}_rebucket_ms_per_launch"] = (
                (sum(glue_ms["sort"]) + sum(glue_ms["gather"])) / len(glue_ms["gather"]))
        res[f"{prefix}_host_ms"] = sec * 1e3 - sum(ms) - glue_sum
        res[f"{prefix}_kernel_ms_each"] = ms
        if alive:
            # the band's lanes: the first launch's (every lane starts alive)
            res[f"{prefix}_alive_lanes_in"] = alive
            (res[f"{prefix}_tail_launches"], res[f"{prefix}_tail_kernel_ms"],
             res[f"{prefix}_tail_share"]) = tail_stats(ms, alive)
        else:  # the spec loop: one kernel call per iteration
            res[f"{prefix}_host_ms_per_iteration"] = res[f"{prefix}_host_ms"] / len(ms)
            res[f"{prefix}_kernel_ms_per_iteration"] = sum(ms) / len(ms)

    res["renderer_init_s"] = [wall(lambda: Renderer(cfg(), scene=scene, device=dev))[1]
                              for _ in reps]
    for mode in ("exact", "fast"):
        r = Renderer(cfg(mode=mode), scene=scene, device=dev)
        res[f"{mode}_backend"], res[f"{mode}_m"] = r.backend, r.pixels_per_lane
        renders = [wall(r.render) for _ in range(REPS + 1)]  # first: warm-up
        res[f"render_{mode}_s"] = [s for _, s in renders]
        instrumented_into(r, mode)
        if scene_name == "book":  # the same render without the compaction
            orig_live = trace.live_lanes

            def every_lane(row):
                return (torch.arange(row.numel(), device=row.device) if bool(row.any())
                        else orig_live(row))

            def uncompacted(fn):
                trace.live_lanes = every_lane
                try:
                    return fn()
                finally:
                    trace.live_lanes = orig_live
            # walls in turns: compacted, uncompacted, uncompacted, compacted, ...
            turns = {"compacted": [], "uncompacted": []}
            for i in range(SWEEP_REPS):
                for name in (("compacted", "uncompacted") if i % 2 == 0
                             else ("uncompacted", "compacted")):
                    run = (lambda: wall(r.render)[1])
                    turns[name].append(uncompacted(run) if name == "uncompacted" else run())
            res[f"{mode}_render_in_turns_s"] = turns
            uncompacted(lambda: instrumented_into(r, f"{mode}_uncompacted"))
        accum, total = renders[-1][0]
        res[f"{mode}_to_u8_s"] = [wall(lambda: accum_to_u8(accum, total).cpu().numpy())[1]
                                  for _ in reps]
        img = accum_to_u8(accum, total).cpu().numpy()
        res[f"{mode}_png_encode_s"] = [wall(lambda: encode_png(img))[1] for _ in reps]

    if scene_name == "book":
        r = Renderer(cfg(backend="mega"), scene=scene, device=dev)
        res["mega_render_exact_s"] = [wall(r.render)[1] for _ in range(REPS + 1)]

    def sweep(key, setting, values, r=None):
        """The exact frame's walls, launches and kernel time with
        ``setting(v)`` applied (it returns an undo) for each value."""
        r = r or Renderer(cfg(), scene=scene, device=dev)
        for v in values:
            undo = setting(v)
            try:
                before = getattr(mod, step_name).launches
                walls = [wall(r.render)[1] for _ in range(SWEEP_REPS + 1)]  # first: warm-up
                res[f"{key}{v}_render_exact_s"] = walls
                res[f"{key}{v}_launches"] = (getattr(mod, step_name).launches
                                             - before) // (SWEEP_REPS + 1)
                res[f"{key}{v}_kernel_ms_sum"] = [sum(instrumented(r, mod, step_name)[1])
                                                  for _ in range(REPS)]
            finally:
                undo()

    def set_attr(obj, name):
        def setting(v):
            old = getattr(obj, name)
            setattr(obj, name, v)
            return lambda: setattr(obj, name, old)
        return setting

    if scene_name == "dense":
        sweep("k", lambda k: set_attr(pagedkernel, "scaled_k")(lambda n: k), K_SWEEP["dense"])
    elif scene_name == "gridless":
        sweep("k", set_attr(megakernel, "K_STEPS"), K_SWEEP["gridless"])
    elif scene_name == "book":
        for m in M_SWEEP:
            r = Renderer(cfg(pixels_per_lane=m), scene=scene, device=dev)
            for j_name, j in J_SWEEP.items():
                undo = set_attr(gridkernel, "J_STEPS")(j)
                try:
                    sweep(f"m{m}_j{j_name}_k", set_attr(gridkernel, "K_STEPS"),
                          K_SWEEP["book"], r)
                finally:
                    undo()

    res["render_exact_median_s"] = statistics.median(res["render_exact_s"][1:])
    print(json.dumps(res), flush=True)

    r = Renderer(cfg(), scene=scene, device=dev)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        wall(r.render)
    kernel = PROFILED[scene_name]
    dev_us = [e.device_time_total for e in prof.key_averages() if kernel in e.key]
    print(json.dumps({f"profiler_{kernel}_device_ms":
                      (sum(dev_us) / 1e3) if dev_us else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
