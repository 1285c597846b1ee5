#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``raytrace_tpu_torch``) on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device, nvcc (``$CUDA_HOME/bin`` or ``/usr/local/cuda``)
and the repository's sources; it imports nothing of JAX.  Each phase prints
one line and raises on failure, so any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: every source of ``_build.SOURCES`` in ``raytrace_tpu_torch/csrc``
   (the megakernel, the grid, paged and fused intersect kernels, the band
   set-up, and the gather probe with its loop baseline; one nvcc per source, started
   together), and a PTX check that no fast-math
   instruction (approximate sqrt/div, rsqrt, sin) reached any of them; the
   registers, spills and resident blocks per SM of the grid and fused
   intersect kernels' instances (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``);
3. kernel vs plain version, on the card, at the main path's shapes, each
   kernel's result compared with its plain torch version on the same inputs
   (>= 99.9% of lanes or rays bit-equal), exact and fast mode for the steps,
   with both times (CUDA events, median of several calls) and the least time
   the card could take for the work (bytes over 3.35 TB/s or fp32 operations
   over 67 TFLOP/s, whichever is larger, counted from this run's inputs):
   the grid step on the driver's live lanes of a book-scene state at the
   renderer's 1920x1080 lane count for it (M=2 on an H100), with its
   home-order accumulator (every lane and pixel bit-equal), and the same
   for a merged state (4 calls, the last shorter), a balanced table built
   from a real iterstats probe, the iterstats instance, and the 1-spp frame
   loops that phase 9 runs (65 merged calls of 1 spp under the balanced
   table of their own M: the bench's at M = 16 and the sweep's at M = 8,
   each the whole 1080-row band its renderer renders); the brute-force step on
   the three-sphere state (the path that launches it) and on the book-scene
   state, at their lane count (M=8), the kernel scanning the table's valid
   prefix and the plain version every row; the paged step
   on the sorted and compacted live lanes of a 100k-sphere state at the
   3840x2160 lane count, with its home-order accumulator (every pixel
   bit-equal) and its sort-key row (equal to ``trace._rebucket_key``); and
   the fused intersect kernel (valid prefix; its plain version every row)
   on the 259,200 rays of the book-scene state; the band set-up kernel
   (``trace.pack_state``'s route on the card) against ``pack_state_plain``
   on every row and lane of the book's 1080p band with and without its
   balanced table, the 1-spp frame's call (65 merged calls under the M = 16
   table), the 100k field's 4K band with its first sort key (timed: the
   kernel alone, CUDA events between launches queued behind a spin, against
   its bytes or integer operations), the three-sphere mega state with a
   carried accumulator and two bands below the top with an x offset (one
   of 0 spp); and, untimed, every lane and
   pixel bit-equal, the states phase 10's scripts launch at their scenes,
   sizes, M and spp: ``hw_validate``'s 5-value varied grid, ``ttab`` grid,
   paged varied and paged ``has_tex`` fields (on their kernel and on the
   megakernel), its book at M=64 (grid and megakernel) and its pitch-2 grid,
   ``grid_pitchsweep``'s 16-slot grids at pitch 1.5, 2 and 3 at 1920x1080
   and M=2, and on the 100k field at 1920x1080 the paged kernel at
   ``paged_ksweep``'s K=10 and at ``paged_cellsweep``'s cell scale 0.7;
4. gates: the JAX package's gates through ``runtime/validation.py`` on the
   card: ``golden_check`` single and multi-tile for bruteforce, mega and grid
   (its ``ok``, and 24x14: <= 3 px off by > 1e-4; 128x72: <= 1% of pixels
   off by > 1e-3), ``bitident_check`` grid == mega in exact and fast mode,
   ``merge_check``, ``bandsplit_check`` and ``fast_check``; paged == mega on
   the 100k-sphere field exactly at 128x72, depth 4, the ``pallas`` and
   ``matmul`` backends at 24x14 under the JAX package's statistical rules,
   grid == mega exactly through ``ray_trace`` at 128x72 x 2 spp, depth 8,
   and at 1920x1080 x 16 spp, depth 50; and at 1920x1080 x 16 spp in exact
   and fast mode, the merged render (4 spp per call, 4 calls per dispatch)
   == the host loop and the balanced render (``balance_spp=8``) == the
   unbalanced one, 0 px differing;
5. main path, with every launch count set to 0 just before it and read
   just after it: ``ray_trace(samples=16, width=1920, height=1080,
   store_render_result=True)`` on the book scene, exact and fast (grid
   kernel); ``render_image`` of the three-sphere scene at the same size
   (brute-force megakernel); ``render_image`` of ``random_sphere_field(100_000)``
   at 3840x2160 x 8 spp, exact and fast (paged kernel; the re-bucket's sort
   and gather per launch, their share of the wall and the live lanes at the
   first and last launches are printed); ``ray_trace(samples=2, width=1920,
   height=1080, backend="pallas")`` (fused intersect kernel); the
   ``matmul`` backend on the three-sphere scene at 480x270, 1 spp, depth 8;
   and the headline, the JAX bench's operating point: the book scene at
   1920x1080 x 10,000 spp in fast mode through ``Renderer`` with
   ``balance_spp=32``, ``samples_per_call=2500`` and ``calls_per_exec=4``,
   timed once after a warm-up call that runs the probe (with
   ``return_iters``, whose lane slots must be 128 per tile iteration), with its launches,
   samples x pixels per second, the balance statistics and the 1-spp frame
   loop ((t(65 merged 1-spp calls) - t(one call)) / 64, bench.py's
   measure).  Each kernel must have launched, and no plain version.
6. bands and frames: first the grid and paged kernels against their plain
   versions, as in phase 3, on the state of the first of four bands (the
   book's 1920x270 band at M=1, the 100k field's 3840x540 band at M=8, each
   in its whole image's viewport); then each path with the launch counts
   set to 0 just before it and read just after it (its kernel must have
   launched, and no plain version): ``MultiChipRenderer`` over four bands
   of the one card (every band stepped from one thread as soon as its last
   launch is done, each on a CUDA stream of its own) at 1920x1080 x 16 spp,
   exact, on the
   book scene (grid kernel) and the three-sphere scene (megakernel), 0 px
   differing from ``Renderer.render_call``, both walls, each band's state
   reckoned from its rows and lanes and the measured peak of device memory;
   ``HeteroRenderer`` on the same four bands in global-seed mode:
   ``render_frame(16)`` 0 px differing, ``per_dev``, the frame time, and
   the rows after 5 ``tune_round``s (then 0 px again); the 100k-sphere field
   at 3840x2160 x 8 spp, exact, over four bands sharing one copy of its
   tables (paged kernel), 0 px differing; ``FrameLoop.run(frames=20)`` at
   1920x1080 x 1 spp, animated, with the scene generation's and
   ``set_scene``'s shares of its duration_per_frame; and
   ``ProductionLoop(port=0)`` over the four bands for 3 frames at 1920x1080
   x 16 spp, its ``/frame.png`` (PNG signature) and ``/state`` (rows summing
   to 1080) read over HTTP from localhost;
7. runtime ops, autotune, C ABI and entry file, each path that renders in
   this process with the launch counts set to 0 just before it and read
   just after it (the grid kernel must have launched, and no plain
   version): ``chips.profile_for`` of the card is the H100 row and the
   main path's operating point (M=2 at 1920x1080, K=40, J=2, grid kernel
   block 128) is the profile's; ``device_trace`` around one 1920x1080 x 16
   spp book render writes a trace whose CUDA kernel events of the grid
   kernel number the launches counted; ``FrameStats`` over ten 1-spp 1080p
   frames; ``autotune`` at 1920x1080 x 32 spp fast over
   ``default_candidates`` of the profile's seed (a cache file in a
   temporary directory, deleted after), every candidate's accumulator
   bit-identical, ns per sample each; ``sweep_block`` over blocks 64, 128
   and 256 in worker processes, each one's accumulator equal to block
   128's, with registers, spills and ns per sample per block; the C ABI
   shim loaded by ctypes: ``ray_trace(16, True, 1920, 1080, 1)`` writes a
   PNG that decodes to the in-process ``ray_trace``'s image, and the demo
   executable (``--bogus`` warned about, exit 0) writes the same; the entry
   file's ``entry()`` band on the card == the same band on the CPU, and
   ``dryrun_multichip(4)`` over four bands of the card.
8. gather: the lane-gather probe and its loop baseline
   (``raytrace_tpu_torch.scripts.bench_gather``, the port of
   ``scripts/bench_gather.py``) at the script's [16, 1024] table: the
   registers and spills of both gather instances (ptxas) and their loops
   with adds (``cuobjdump -sass``: instructions, adds and shared loads);
   for axis 1 and 0 and every index case of ``CHECK_MODES`` (random and
   per-lane indices, wrapping ones per entry and per lane, a launch whose
   warps take both axis-1 paths, and per-lane indices on the row path),
   at 1, 7 and 2048 iterations, and for the baseline, the kernel over one
   block per SM == the plain version on every block's slice (0 columns
   differing, NaNs in the same places); times at one block and at one
   block per SM, the clocks an iteration at the card's maximum SM clock
   against the shared-memory bound (one 32-word wavefront per clock per
   SM: 512 per [16, 1024] gather) and against the wavefronts that
   ``shared_wavefronts`` counts for the case under both 128-bit rules;
   then its entry point ``main()`` as a user runs it, with the launch
   counts set to 0 just before it and read just after it (both kernels
   must launch); and the grid and paged kernels' ``gather_floor_frac``:
   the cell-record and winner-attribute values their phase-3 launch loads
   (a lower count, from the plain versions' tally), times the probe's ns
   per value over the card (per-lane indices; beside it the row path's on
   the same indices), over the launch's time.  The probe's ``bound_ms`` is
   the shared-memory bound (``bound_by`` "bytes": 128 B a wavefront), or
   the launch's device-memory bytes and fp32 operations where larger.
9. bench: the JAX system's own measurement entry points as the port runs
   them, in this process, each with every launch count set to 0 just
   before it and read just after it (its kernels must launch, and no plain
   version; the bench's gather tally runs the plain body through
   ``gridkernel.grid_step_work``, which counts no launch):
   ``raytrace_tpu_torch.bench.main()`` at its defaults (the
   book scene at 1920x1080 x 10,000 spp, fast, ``balance_spp=32``, 2500
   spp per call, 4 calls per dispatch), whose last line must parse as JSON
   with ``measured == "full"``, every gate ok, the frame loop's M = 16, a
   ``gather_floor_frac`` and ``device`` = the card's name and power limit,
   printed whole as the ``[bench]`` line; ``scripts.baseline_configs`` 1-3
   (``matmul`` on the CPU, ``mega`` and ``grid`` on the card);
   ``scripts.stretch_bench`` at 320x180x8 and 3840x2160x8 on the 100k field
   (paged kernel); ``scripts.spp1_loop_sweep`` at M = 2, 8, 16 over 2
   rounds.
10. scripts: the JAX system's remaining scripts as the port runs them, in
   this process, counted as in phase 9 (under ``[scripts]``; each script's
   own assertions uncaught): ``scripts.hw_validate`` at its scenes and
   sizes (the megakernel, grid and paged kernels: one-sample grid == mega
   and paged == mega bit for bit on the book scene, the 5-value varied
   field, the paged varied field, the textured grid field and the paged
   textured field; pitch 2 == pitch 1 and balanced == strided at 16 spp);
   ``scripts.stretch_reps`` (5 repeats of the 100k field at 3840x2160 x 8
   spp, fast); at 1920x1080 on the book scene at the card's M = 2,
   ``scripts.lane_balance``, ``scripts.balance_ab`` (balanced == strided
   images), ``scripts.balance_policy_ab`` (serpentine == LPT images) and
   ``scripts.grid_pitchsweep`` (pitches 1, 1.5, 2 and 3, every image
   bit-identical); on the 100k field at 1920x1080, ``scripts.paged_ksweep``
   at K = 10, 20, 40, 80 with ``K_AUTO`` off (every image bit-identical) and
   ``scripts.paged_cellsweep``; 3 timed rounds per sweep.
11. probes: the grid and paged kernels' section-cost probes.  Every
   variant library is built at once (the grid kernel's seven duplications,
   ``freeze`` and ``freeze`` with each of its nine removals; the paged
   kernel's ``freeze`` and ``freeze`` with each of its nine), and the
   production library's ptxas lines must equal phase 2's; each variant's
   registers, frame, spills and SASS instruction count at the main path's
   instance (book scene; 100k field), every duplication's SASS longer than
   production's; each duplication's first launch from the 1920x1080 x 1
   spp exact state (every lane and pixel) and its ``Renderer`` image of
   that frame (``gridkernel.ABLATE``) bit-equal to the production
   kernel's; ``freeze`` and each removal under it, grid and paged, bit-equal
   to its plain version on one launch from the scripts' frozen mid-flight
   states (book at 1080p, M = 64, one production launch, the live lanes;
   the 100k field at 1080p, M = 64, a launch, the re-bucket, a launch),
   every lane, key and accumulator pixel, NaN equal to NaN; then in this
   process, counted as in phase 9 (their launches also by variant):
   ``scripts.grid_ablate`` at its defaults and with ``--mode fast`` at
   M = 2, ``scripts.grid_iterbench`` exact and fast, and
   ``scripts.paged_iterbench``, each over 3 rounds (the iterbenches at 60
   and 30 launches a round, against the JAX scripts' 300 and 60).

Every time is printed beside the card's name and power limit.  Before the
last line it prints the kernels' JSON record (``launches`` are the counts
of phases 5, 6, 7, 9, 10 and 11, and for the gather probe of phases 8 and
9; the grid and paged rows also list phase 11's launches by variant);
the last line is ``{"ok": true, "device": {...}}``.
Images and the build log are written under ``build/smoke/`` (gitignored).
"""

from __future__ import annotations

import faulthandler
import json
import os
import statistics
import struct
import subprocess
import sys
import threading
import time
import urllib.request
import zlib

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "build", "smoke")
MAIN_SPP, MAIN_W, MAIN_H = 16, 1920, 1080
# the JAX bench's operating point (bench.py:86-98)
HEAD_SPP, HEAD_SPP_PER_CALL, HEAD_CALLS_PER_EXEC, HEAD_BALANCE_SPP = 10_000, 2500, 4, 32
FRAME_LOOP_CALLS = 65
# phase 9's spp1_loop_sweep: its Ms and rounds
LOOP_SWEEP_MS, LOOP_SWEEP_ROUNDS = (2, 8, 16), 2
# phase 10: the scripts' environment knobs (unset around each run), the
# card's pixels per lane for the book-scene sweeps, the timed rounds of
# every sweep, stretch_reps' repeats and paged_ksweep's Ks (around the 80
# that scaled_k picks for the 100k field's 1080p and 4K lane counts)
SCRIPT_KNOBS = ("SWEEP_", "AB_", "PROBE_SPP", "PITCHES", "VARIANTS", "KS", "SCALES",
                "STRETCH_MODE")
SWEEP_M, SWEEP_ROUNDS, STRETCH_REPS, PAGED_KS = 2, 3, 5, (10, 20, 40, 80)
# phase 11: the probes' environment knobs, timed rounds and launches a round
PROBE_KNOBS = ("SWEEP_", "ABLATE_VARIANTS", "M", "INVOKES", "ROUNDS", "VARIANTS",
               "PITCH", "N_SPHERES", "CARRY")
PROBE_ROUNDS, GRID_INVOKES, PAGED_INVOKES = 3, 60, 30
DENSE_SPP, DENSE_W, DENSE_H, DENSE_N = 8, 3840, 2160, 100_000
N_BANDS, TUNE_ROUNDS, LOOP_FRAMES, PROD_FRAMES = 4, 5, 20, 3
# the autotuner's phase: spp of each candidate's render, the block sweep's
# candidates
TUNE_SPP, SWEEP_BLOCKS = 32, (64, 128, 256)
# past this many seconds every thread's stack is printed and the run exits 1,
# inside the 1200 s a run may take
WATCHDOG_S = 1150
# H100 SXM peaks (NVIDIA data sheet): device memory and fp32 outside the
# tensor cores
HBM_BYTES_PER_S, FP32_OPS_PER_S = 3.35e12, 67e12
# 32-bit integer operations: 64 a clock per SM (the Hopper white paper) over
# 132 SMs at the 1980 MHz maximum SM clock; a band set-up's lane does two
# 16-round TEA hashes (8 a half-round) and four LCG draws (2 each)
INT32_OPS_PER_S = 64 * 132 * 1.98e9
PACK_INT_OPS = 2 * 32 * 8 + 4 * 2
# fp32 operations counted from csrc/wavefront.cuh (sqrt, divide, sin one
# each): a ray-sphere quadratic; a live lane-iteration's ray terms; a
# segment's end (shading, throughput, regeneration)
OPS_QUADRATIC, OPS_LANE_ITER, OPS_SEGMENT = 22, 16, 150


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


def bound(nbytes, ops):
    """(least ms on the card, what bounds it) for moving ``nbytes`` once and
    doing ``ops`` fp32 operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(kern, plain):
    """(columns differing in any row, max |diff| over finite f32 entries)
    of two tuples of [rows, columns] tensors."""
    import torch

    bad = None
    err = 0.0
    for k, p in zip(kern, plain):
        same = (k == p) | (torch.isnan(k) & torch.isnan(p)) if k.is_floating_point() else k == p
        col_bad = ~same.reshape(same.shape[0], -1).all(dim=0) if same.dim() > 1 else ~same
        bad = col_bad if bad is None else bad | col_bad
        if k.is_floating_point():
            fin = torch.isfinite(k) & torch.isfinite(p)
            err = max(err, float(torch.where(fin, (k - p).abs(), torch.zeros_like(k)).max()))
    return int(bad.sum()), err


def counted_path(tag, label, kernels, fn, launches, counters, plain_names, totals):
    """Run ``fn()`` with every launch count at 0; each of ``kernels`` must
    launch and no plain version.  Adds the counts to ``totals``; returns
    ``fn()``'s result."""
    import torch

    for c in counters:
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    ran = launches()
    phase(tag, f"{label}: launches {({k: v for k, v in ran.items() if v})}")
    if any(ran[k] == 0 for k in kernels) or any(ran[p] for p in plain_names):
        raise RuntimeError(f"{label}: launches {ran}, want {kernels} and no plain "
                           f"version")
    for k, v in ran.items():
        totals[k] += v
    return out


def bands_and_frames(dev, smi, launches, counters, plain_names) -> dict:
    """Phase 6: row bands over four bands of the one card, the tuned bands,
    the animated frame loop and the production loop behind its HTTP server.
    Each path runs with the launch counts set to 0 just before it; returns
    the kernels' launches summed over the paths."""
    import numpy as np
    import torch

    from raytrace_tpu_torch import RenderConfig
    from raytrace_tpu_torch.models.scene import (random_sphere_field,
                                                 three_sphere_scene)
    from raytrace_tpu_torch.ops import trace
    from raytrace_tpu_torch.parallel.hetero import HeteroRenderer
    from raytrace_tpu_torch.parallel.sharding import MultiChipRenderer
    from raytrace_tpu_torch.runtime import frames as frames_mod
    from raytrace_tpu_torch.runtime import renderer as rmod
    from raytrace_tpu_torch.runtime.production import ProductionLoop

    card = f"({smi})"
    four = [dev] * N_BANDS
    totals = dict.fromkeys(launches(), 0)

    def path(label, kernel, fn):
        return counted_path("bands", label, (kernel,), fn, launches, counters,
                            plain_names, totals)

    def wall(fn, reps=3):
        """(result, median seconds of ``reps`` synchronised calls after a
        warm-up call)."""
        out = [fn()]
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[0] = fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return out[0], statistics.median(times)

    def state_mb(r, dsc, backend, rows):
        """A band's wavefront state (f32 and int32 rows x padded lanes) and
        home-order accumulator, reckoned from its rows, in MB."""
        m, chunk = rmod.band_layout(r.config, dev, backend, rows)
        mk, rf = trace._state_module(dsc, backend, m)
        p = r.config.width * chunk
        n_pad = -(-(-(-p // m)) // trace.LANE_PAD) * trace.LANE_PAD
        return m, n_pad, ((rf + mk.U_ROWS) * 4 * n_pad + 12 * p) / 1e6

    def bands_vs_whole(label, kernel, backend, cfg, scene, spp):
        single = rmod.Renderer(cfg, scene=scene, device=dev)
        whole, t_whole = wall(lambda: single.render_call(spp))
        r = MultiChipRenderer(cfg, scene=scene, devices=four)
        torch.cuda.reset_peak_memory_stats(dev)
        banded, t_bands = path(f"{label} over {N_BANDS} bands", kernel,
                               lambda: wall(lambda: r.render_call(spp)))
        peak = torch.cuda.max_memory_allocated(dev) / 1e6
        n_diff = int((banded != whole).any(dim=2).sum())
        m, n_pad, mb = state_mb(r, r.device_scenes[dev], r.backend, r.band_h)
        tables = sum(t.numel() * t.element_size() for t in r.device_scenes[dev].paged or ()
                     if torch.is_tensor(t)) / 1e6
        phase("bands", f"{label} {cfg.width}x{cfg.height} x {spp} spp, backend {r.backend}: "
              f"{N_BANDS} bands of {r.band_h} rows {n_diff} px differ from the whole; wall "
              f"whole {t_whole * 1e3:.3f} ms, {N_BANDS} bands {t_bands * 1e3:.3f} ms "
              f"(median of 3 after a warm-up); each band's state {mb:.1f} MB (M={m}, "
              f"{n_pad} lanes), {N_BANDS * mb:.1f} MB for the {N_BANDS}; "
              f"{len(r.device_scenes)} copy of the tables"
              f"{f' ({tables:.1f} MB of paged tables)' if tables else ''}; device memory "
              f"peak {peak:.1f} MB over the banded renders {card}")
        if n_diff or r.backend != backend:
            raise RuntimeError(f"{label}: the {N_BANDS} bands differ from the whole on "
                               f"{n_diff} px (backend {r.backend})")
        return whole

    # the book scene and the three-sphere scene over four bands
    book_cfg = RenderConfig(samples=MAIN_SPP, width=MAIN_W, height=MAIN_H)
    whole = bands_vs_whole("book scene", "grid_megakernel_step", "grid", book_cfg,
                           None, MAIN_SPP)
    bands_vs_whole("three-sphere scene", "megakernel_step", "mega", book_cfg,
                   three_sphere_scene(), MAIN_SPP)

    # the same four bands tuned, global seeds: every frame is the whole's
    def hetero():
        hr = HeteroRenderer(book_cfg, devices=four, reference_banding=False)
        accum, frame_s, per_dev = hr.render_frame(MAIN_SPP)
        n_diff = int((accum != whole.cpu().numpy()).any(axis=2).sum())
        dpfs = [hr.tune_round(MAIN_SPP, frames=1)[1] for _ in range(TUNE_ROUNDS)]
        after = int((hr.render_frame(MAIN_SPP)[0] != whole.cpu().numpy()).any(axis=2).sum())
        phase("bands", f"hetero book scene {MAIN_W}x{MAIN_H} x {MAIN_SPP} spp over "
              f"{N_BANDS} bands: {n_diff} px differ from the whole; frame "
              f"{frame_s * 1e3:.3f} ms, per_dev {[round(p * 1e3, 3) for p in per_dev]} ms; "
              f"after {TUNE_ROUNDS} tune_rounds (duration_per_frame "
              f"{[round(d * 1e3, 3) for d in dpfs]} ms) rows {hr.rows}, {after} px differ "
              f"{card}")
        if n_diff or after or sum(hr.rows) != MAIN_H:
            raise RuntimeError(f"hetero: {n_diff} / {after} px differ, rows {hr.rows}")

    path("hetero book scene", "grid_megakernel_step", hetero)

    # the 100k-sphere field over four bands sharing one copy of its tables
    bands_vs_whole(f"{DENSE_N}-sphere field", "paged_megakernel_step", "paged",
                   RenderConfig(samples=DENSE_SPP, width=DENSE_W, height=DENSE_H),
                   random_sphere_field(DENSE_N), DENSE_SPP)

    # the animated frame loop: scene generation and set_scene timed per frame
    def frame_loop():
        fl = frames_mod.FrameLoop(RenderConfig(samples=1, width=MAIN_W, height=MAIN_H),
                                  device=dev)
        spent = {"scene": [], "set_scene": []}

        def timed(fn, key):
            def wrapped(*args):
                t0 = time.perf_counter()
                out = fn(*args)
                spent[key].append(time.perf_counter() - t0)
                return out
            return wrapped

        orig_gen = frames_mod.generate_random_scene
        frames_mod.generate_random_scene = timed(orig_gen, "scene")
        fl.renderer.set_scene = timed(fl.renderer.set_scene, "set_scene")
        try:
            dpf, n = fl.run(frames=LOOP_FRAMES)
        finally:
            frames_mod.generate_random_scene = orig_gen
        gen, ss = (sum(spent[k][-n:]) / n for k in ("scene", "set_scene"))
        phase("frames", f"FrameLoop {MAIN_W}x{MAIN_H} x 1 spp animated, {n} frames: "
              f"duration_per_frame {dpf * 1e3:.3f} ms, of it scene generation "
              f"{gen * 1e3:.3f} ms ({gen / dpf:.1%}) and set_scene {ss * 1e3:.3f} ms "
              f"({ss / dpf:.1%}), backend {fl.renderer.backend} {card}")
        if n != LOOP_FRAMES or not dpf > 0:
            raise RuntimeError(f"frame loop: {n} frames, dpf {dpf}")

    path("frame loop", "grid_megakernel_step", frame_loop)

    # the production loop behind its HTTP server on localhost
    def production():
        loop = ProductionLoop(RenderConfig(samples=MAIN_SPP, width=MAIN_W, height=MAIN_H),
                              port=0, devices=four, device=dev)
        port = loop.start_server()
        try:
            errors = []

            def run():
                try:
                    loop.render_loop(max_frames=PROD_FRAMES)
                except BaseException as e:  # raised below, on the main thread
                    errors.append(e)

            th = threading.Thread(target=run, daemon=True)
            t0 = time.perf_counter()
            th.start()
            th.join(timeout=300)
            sec = time.perf_counter() - t0
            if errors:
                raise errors[0]
            if th.is_alive():
                raise RuntimeError("production loop: no end within 300 s")

            def get(p):
                with urllib.request.urlopen(f"http://127.0.0.1:{port}{p}", timeout=30) as res:
                    return res.read()

            png, state = get("/frame.png"), json.loads(get("/state"))
        finally:
            loop.stop()
        phase("frames", f"ProductionLoop {MAIN_W}x{MAIN_H} x {MAIN_SPP} spp over {N_BANDS} "
              f"bands, {PROD_FRAMES} frames in {sec:.3f} s: /frame.png {len(png)} B, "
              f"/state {state} {card}")
        if (png[:8] != b"\x89PNG\r\n\x1a\n" or sum(state["rows"]) != MAIN_H
                or state["frame"] != PROD_FRAMES - 1 or not state["duration_per_frame"] > 0):
            raise RuntimeError(f"production loop: png {png[:8]!r}, state {state}")

    path("production loop", "grid_megakernel_step", production)
    return totals


def gather_probe(dev, smi, records, step_work) -> None:
    """Phase 8: the gather probe and its baseline against their plain
    versions on every block's slice, for every index case of
    ``bench_gather.CHECK_MODES`` (both axis-1 paths, alone and in one
    launch); timed against the shared-memory bound and the wavefronts that
    ``bench_gather.shared_wavefronts`` counts for each case; the kernels'
    registers, spills and compiled loops; the entry point as a user runs it,
    its launches counted; the grid and paged kernels' gather floor.  Adds
    the two kernels' rows to ``records`` and ``gather_floor_frac`` to the
    grid and paged rows."""
    import torch

    from raytrace_tpu_torch import _build
    from raytrace_tpu_torch.scripts import bench_gather as bg

    card = f"({smi})"
    r_, t_, iters_max = bg.R, bg.T, bg.ITERS
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", f"--id={dev.index}", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    tab_np, _ = bg.inputs()
    tab = torch.from_numpy(tab_np).to(dev)
    idx_np = {m: bg.check_inputs(m)[1] for m in bg.CHECK_MODES}
    idx = {k: torch.from_numpy(v).to(dev) for k, v in idx_np.items()}
    values = sms * r_ * t_ * iters_max  # gathered (or scaled) values at one block per SM
    moved = {"run": (2 + sms) * r_ * t_ * 4, "run_base": (1 + sms) * r_ * t_ * 4}
    # shared memory serves one wavefront (32 words) per clock per SM: the
    # least clocks per [R, T] gather per SM, and the least ms of a launch at
    # the card's maximum SM clock
    ideal = r_ * t_ / 32
    smem_ms = ideal * iters_max / (mhz * 1e3)

    # registers and spills (ptxas) and the compiled loops (cuobjdump -sass)
    info = _build.build()
    regs = _build.ptxas_report(info["log"], "gather_bench_kernel")
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    loops = bg.sass_loops(subprocess.run([cuobjdump, "-sass", str(info["lib"])],
                                         capture_output=True, text=True,
                                         check=True).stdout)
    compiled = {}
    for fn, axis in ((f, 1 if "ILi1E" in f else 0) for f in regs):
        hot = [dict(instructions=lp["instructions"], fadd=lp["ops"].get("FADD", 0),
                    lds={k: v for k, v in lp["ops"].items() if k.startswith("LDS")})
               for lp in loops.get(fn, []) if lp["ops"].get("FADD")]
        compiled[f"axis{axis}"] = dict(regs[fn], loops=hot)
        phase("gather", f"gather_bench_kernel<{axis}>: {regs[fn]['registers']} registers, "
              f"{regs[fn]['spill_stores']} B spill stores; loops with adds "
              f"(instructions, FADD, shared loads, instructions per FADD): "
              + "; ".join(f"{h['instructions']}, {h['fadd']}, {h['lds']}, "
                          f"{h['instructions'] / h['fadd']:.2f}" for h in hot))
    if set(compiled) != {"axis0", "axis1"}:
        raise RuntimeError(f"ptxas reported gather kernel instances {list(regs)}")

    def check(label, kern, plain):
        """(columns differing, NaN in the kernel, NaN in the plain version
        x blocks, max |diff|) over every block's slice."""
        out = kern(blocks=sms, per_block=True)
        ref = plain()
        torch.cuda.synchronize()
        n_bad, err = compare((out.permute(1, 0, 2).reshape(r_, sms * t_),),
                             (ref.repeat(1, sms),))
        nan_k, nan_p = int(out.isnan().sum()), int(ref.isnan().sum()) * sms
        if n_bad or nan_k != nan_p:
            raise RuntimeError(f"{label}: {n_bad} columns differ, NaN {nan_k} vs {nan_p}")
        return n_bad, nan_k, nan_p, err

    err = {"run": 0.0, "run_base": 0.0}
    ms, plain_ms, counted = {}, {}, {}
    for axis in (1, 0):
        for mode in bg.CHECK_MODES:
            def kern(iters=iters_max, **kw):
                return bg.run(tab, idx[mode], iters=iters, axis=axis, **kw)

            def plain(iters=iters_max):
                return bg.run_plain(tab, idx[mode], iters=iters, axis=axis)

            label = f"run axis={axis} idx={mode}"
            res = {iters: check(f"{label} iters={iters}", lambda **kw: kern(iters, **kw),
                                lambda: plain(iters))
                   for iters in (1, 7, iters_max)}
            err["run"] = max([err["run"]] + [r[3] for r in res.values()])
            ms[(axis, mode)] = {b: cuda_ms(lambda: kern(blocks=b), 5) for b in (1, sms)}
            if mode in bg.INDEX_MODES:
                plain_ms[(axis, mode)] = cuda_ms(plain, 2)
            n = counted[(axis, mode)] = bg.shared_wavefronts(idx_np[mode], axis)
            t1, tn = ms[(axis, mode)][1], ms[(axis, mode)][sms]
            clocks = t1 * 1e-3 / iters_max * mhz * 1e6
            n.update(clocks=clocks, share_of_512=ideal / clocks,
                     share_of_count_warp=n["warp"] / clocks,
                     share_of_count_quarter=n["quarter"] / clocks)
            phase("gather", f"{label}: {sms} blocks x [{r_},{t_}] == plain at iterations 1, 7, "
                  f"{iters_max} (0 columns differ; NaN "
                  f"{', '.join(f'{r[1]}/{r[2]}' for r in res.values())}; max |diff| "
                  f"{max(r[3] for r in res.values())}); {n['record_warps']} of "
                  f"{t_ // bg.WARP} warps on the record path; 1 block {t1:.4f} ms = "
                  f"{clocks:.0f} clocks an iteration at {mhz:.0f} MHz, {sms} blocks "
                  f"{tn:.4f} ms ({tn * 1e6 / values:.6f} ns per value over the card); "
                  f"wavefronts counted {n['warp']:g} (warp rule) / {n['quarter']:g} "
                  f"(quarter rule), reached {n['share_of_count_warp']:.3f} / "
                  f"{n['share_of_count_quarter']:.3f}, of the {ideal:.0f}-wavefront bound "
                  f"{n['share_of_512']:.3f}"
                  + (f"; plain {plain_ms[(axis, mode)]:.3f} ms" if mode in bg.INDEX_MODES
                     else "") + f" {card}")

    def base(iters=iters_max, **kw):
        return bg.run_base(tab, idx["rand"], iters=iters, **kw)

    def base_plain(iters=iters_max):
        return bg.run_base_plain(tab, idx["rand"], iters=iters)

    for iters in (1, 7, iters_max):
        err["run_base"] = max(err["run_base"], check(
            f"run_base iters={iters}", lambda **kw: base(iters, **kw),
            lambda: base_plain(iters))[3])
    base_ms = {b: cuda_ms(lambda: base(blocks=b), 5) for b in (1, sms)}
    base_plain_ms = cuda_ms(base_plain, 2)
    base_bound = bound(moved["run_base"], 2 * values)
    phase("gather", f"run_base: == plain at iterations 1, 7, {iters_max}; 1 block "
          f"{base_ms[1]:.4f} ms ({base_ms[1] * 1e-3 / iters_max * mhz * 1e6:.0f} clocks an "
          f"iteration), {sms} blocks {base_ms[sms]:.4f} ms; plain {base_plain_ms:.3f} ms; "
          f"bound {base_bound[0]:.4f} ms ({base_bound[1]}) {card}")

    # the entry point as a user runs it, with its launches counted
    wrappers = (bg.run, bg.run_base, bg.run_plain, bg.run_base_plain)
    for w in wrappers:
        w.launches = 0
    bg.main([])
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in wrappers}
    phase("gather", f"python -m raytrace_tpu_torch.scripts.bench_gather: launches {counts} "
          f"(the plain versions: its own check at one iteration)")
    if not (counts["run"] and counts["run_base"]):
        raise RuntimeError(f"the gather entry point did not launch both kernels: {counts}")

    # the probe's bound: shared memory's 512 wavefronts per iteration per SM
    # at the card's maximum SM clock, or the bytes and operations of the
    # launch at device memory's and fp32's peaks, whichever is larger
    hbm_ops_ms, hbm_ops_by = bound(moved["run"], values)
    run_bound = max(smem_ms, hbm_ops_ms)
    extra = {f"axis{a}_{m}_ms": t[sms] for (a, m), t in ms.items()}
    extra.update({f"axis{a}_{m}_1block_ms": t[1] for (a, m), t in ms.items()})
    records["bench_gather.run"] = dict(
        name="bench_gather.run", route="cuda", source="raytrace_tpu_torch/csrc/bench_gather.cu",
        replaces="scripts/bench_gather.py:38", launches=counts["run"],
        max_abs_err=err["run"], ms=ms[(1, "lane")][sms], plain_ms=plain_ms[(1, "lane")],
        bound_ms=run_bound, bound_by="bytes" if run_bound == smem_ms else hbm_ops_by,
        bound_note=(f"shared memory: {ideal:.0f} wavefronts of 128 B per iteration per SM "
                    f"at {mhz:.0f} MHz; device memory and fp32 operations: "
                    f"{hbm_ops_ms:.4f} ms ({hbm_ops_by})"),
        library_ms=None, blocks=sms, iters=iters_max, clocks_max_sm_mhz=mhz,
        wavefronts={f"axis{a}_{m}": n for (a, m), n in counted.items()},
        compiled=compiled, **extra)
    records["bench_gather.run_base"] = dict(
        name="bench_gather.run_base", route="cuda",
        source="raytrace_tpu_torch/csrc/bench_gather.cu",
        replaces="scripts/bench_gather.py:61", launches=counts["run_base"],
        max_abs_err=err["run_base"], ms=base_ms[sms], plain_ms=base_plain_ms,
        bound_ms=base_bound[0], bound_by=base_bound[1], library_ms=None, blocks=sms,
        iters=iters_max, one_block_ms=base_ms[1])
    phase("gather", f"bench_gather.run: bound {run_bound:.4f} ms "
          f"({records['bench_gather.run']['bound_note']}); per-lane indices "
          f"{ms[(1, 'lane')][sms]:.4f} ms = {run_bound / ms[(1, 'lane')][sms]:.3f} of it {card}")

    # the gather floor of the main path's wavefront kernels: the cell-record
    # and winner-attribute values of their phase-3 launch (the plain
    # versions' ``table_values`` tally: a lower count of the kernels' on-chip
    # reads -- the grid kernel's globals come from shared memory, the paged
    # kernel's globals and id scans are left out) at the probe's whole-card
    # ns per value (per-lane indices, axis 1), over the launch's measured
    # time; beside it the same at the row path's rate on those indices
    # ("lane-row").  The kernels read L1 and L2 through __ldg, the probe
    # shared memory, so this is a floor, not the kernels' cost.
    ns_value = {m: bg.ns_per_value(ms[(1, m)][sms], iters_max, sms)
                for m in ("lane", "lane-row")}
    for name in ("grid_megakernel_step", "paged_megakernel_step"):
        n_values = step_work[name]["table_values"]
        frac = {m: bg.gather_floor_frac(n_values, v, records[name]["ms"])
                for m, v in ns_value.items()}
        records[name]["gather_floor_frac"] = frac["lane"]
        records[name]["gather_floor_frac_row_path"] = frac["lane-row"]
        phase("gather", f"{name}: gather_floor_frac {frac['lane']:.4f} = {n_values} table "
              f"values (a lower count) x {ns_value['lane']:.6f} ns per value over the card / "
              f"{records[name]['ms']:.3f} ms per launch; at the row path's "
              f"{ns_value['lane-row']:.6f} ns per value {frac['lane-row']:.4f} {card}")


def script_runner(tag, smi, counters, plain_names, unset):
    """(path, totals): ``path(label, kernels, fn, env=None)`` runs ``fn()``
    through ``counted_path`` with its stdout captured and printed line by
    line under ``[tag]``, with the environment variables named in ``unset``
    removed (a name ending in "_" is a prefix) and ``env`` set for the call
    (restored after); returns (``fn()``'s result, its stdout).  ``totals``
    sums the launches of every path."""
    import contextlib
    import io

    def launches():
        return {c.__name__: c.launches for c in counters}

    totals = dict.fromkeys(launches(), 0)

    def path(label, kernels, fn, env=None):
        saved = dict(os.environ)
        for k in [k for k in os.environ
                  if k in unset or k.startswith(tuple(u for u in unset if u.endswith("_")))]:
            del os.environ[k]
        os.environ.update(env or {})
        buf = io.StringIO()

        def captured():
            with contextlib.redirect_stdout(buf):
                return fn()

        t0 = time.perf_counter()
        try:
            out = counted_path(tag, label, kernels, captured, launches, counters,
                               plain_names, totals)
        finally:
            os.environ.clear()
            os.environ.update(saved)
        phase(tag, f"{label}: {time.perf_counter() - t0:.1f} s ({smi}); its output:")
        for line in buf.getvalue().splitlines():
            if line.strip():
                phase(tag, line)
        return out, buf.getvalue()

    return path, totals


def bench_phase(dev, smi, kind, counters, plain_names) -> dict:
    """Phase 9: the JAX system's bench and scripts as the port runs them,
    in this process, each with every launch count set to 0 just before it
    and read just after it (its kernels must launch, and no plain
    version): ``raytrace_tpu_torch.bench.main()`` at its defaults, BASELINE
    configs 1-3, the stretch bench at 320x180x8 and 3840x2160x8 on the 100k
    field, and the 1-spp frame-loop sweep at M = 2, 8, 16 over 2 rounds.
    Their output is printed line by line under ``[bench]``.  Returns the
    kernels' launches summed over the runs."""
    from raytrace_tpu_torch import bench
    from raytrace_tpu_torch.scripts import baseline_configs
    from raytrace_tpu_torch.scripts import bench_gather as bg
    from raytrace_tpu_torch.scripts import spp1_loop_sweep, stretch_bench

    counters = tuple(counters) + (bg.run, bg.run_base, bg.run_plain, bg.run_base_plain)
    plain_names = list(plain_names) + [bg.run_plain.__name__, bg.run_base_plain.__name__]
    path, totals = script_runner("bench", smi, counters, plain_names, ("BENCH_",))

    # the JAX bench's JSON line at its defaults: 1920x1080 x 10,000 spp,
    # fast, balance_spp=32, 2500 spp per call, the profile's 4 calls per
    # dispatch; its gates, the frame loop at M = 16, the probe and the
    # gather floor run inside it
    rc, text = path("python -m raytrace_tpu_torch.bench",
                    ("grid_megakernel_step", "megakernel_step", "run"), bench.main)
    rec = json.loads(text.strip().splitlines()[-1])
    bad = bench.failed_gates({k: rec.get(k) or {} for k in (
        "numeric_check", "numeric_check_multitile", "bitident_check", "fast_check",
        "merge_check", "bandsplit_check")})  # each present, and ok
    if (rc != 0 or rec.get("measured") != "full" or bad or rec.get("device") != smi
            or kind not in rec["device"] or rec.get("spp1_frame_loop_m") != bench.FRAME_LOOP_M
            or not (rec["utilization"] or {}).get("gather_floor_frac")):
        raise RuntimeError(f"bench: rc {rc}, measured {rec.get('measured')}, gates not ok "
                           f"{bad}, device {rec.get('device')!r}: {rec}")

    recs, _ = path("baseline_configs 1 2 3", ("grid_megakernel_step", "megakernel_step"),
                   lambda: baseline_configs.main(["1", "2", "3"]))
    if ([r["backend"] for r in recs] != ["matmul", "mega", "grid"]
            or any(r["nonfinite"] for r in recs)
            or not recs[0]["device"].startswith("cpu") or recs[1]["device"] != smi):
        raise RuntimeError(f"baseline_configs: {recs}")

    recs, _ = path(f"stretch_bench {DENSE_N} 320x180x8 3840x2160x8",
                   ("paged_megakernel_step",),
                   lambda: stretch_bench.main([str(DENSE_N), "320x180x8", "3840x2160x8"]))
    if any(r["backend"] != "paged" or r["nonfinite"] for r in recs) or len(recs) != 2:
        raise RuntimeError(f"stretch_bench: {recs}")

    env = {"MS": ",".join(map(str, LOOP_SWEEP_MS)), "SWEEP_ROUNDS": str(LOOP_SWEEP_ROUNDS)}
    med, _ = path(f"spp1_loop_sweep MS={env['MS']} SWEEP_ROUNDS={env['SWEEP_ROUNDS']}",
                  ("grid_megakernel_step",), lambda: spp1_loop_sweep.main([]), env=env)
    if sorted(med) != list(LOOP_SWEEP_MS) or not all(v > 0 for v in med.values()):
        raise RuntimeError(f"spp1_loop_sweep: {med}")
    return totals


def scripts_phase(smi, counters, plain_names) -> dict:
    """Phase 10: the JAX system's remaining scripts as the port runs them,
    in this process, each through ``script_runner`` (its kernels must
    launch, and no plain version; its own assertions uncaught): hw_validate
    (kernels 1-3; its one-sample grid == mega and paged == mega on every
    layout, pitch 2 == pitch 1, balanced == strided), stretch_reps on the
    100k field at 3840x2160 x 8 spp, lane_balance, balance_ab and
    balance_policy_ab (serpentine == LPT images) and grid_pitchsweep (every
    pitch bit-identical) at 1920x1080 and the card's M = 2, paged_ksweep
    (every K bit-identical, ``K_AUTO`` off) and paged_cellsweep on the 100k
    field at 1920x1080.  Returns the kernels' launches summed over the
    runs."""
    from raytrace_tpu_torch.scripts import (balance_ab, balance_policy_ab, grid_pitchsweep,
                                            hw_validate, lane_balance, paged_cellsweep,
                                            paged_ksweep, stretch_reps)

    path, totals = script_runner("scripts", smi, counters, plain_names, SCRIPT_KNOBS)
    grid, mega, paged = "grid_megakernel_step", "megakernel_step", "paged_megakernel_step"

    out, _ = path("hw_validate", (grid, mega, paged), lambda: hw_validate.main([]))
    layouts = ("book grid", "varied grid", "paged-varied paged", "ttab grid", "paged-tex paged")
    if (sorted(out["one_sample"]) != sorted(layouts) or any(out["one_sample"].values())
            or out["pitch2_px"] or out["balanced_px"]):
        raise RuntimeError(f"hw_validate: {out}")

    rec, _ = path(f"stretch_reps {STRETCH_REPS} {DENSE_W}x{DENSE_H}x{DENSE_SPP}", (paged,),
                  lambda: stretch_reps.main([str(STRETCH_REPS),
                                             f"{DENSE_W}x{DENSE_H}x{DENSE_SPP}"]))
    if rec["backend"] != "paged" or len(rec["reps"]) != STRETCH_REPS or rec["device"] != smi:
        raise RuntimeError(f"stretch_reps: {rec}")

    book = {"SWEEP_M": str(SWEEP_M), "SWEEP_ROUNDS": str(SWEEP_ROUNDS)}
    res, _ = path(f"lane_balance SWEEP_M={SWEEP_M}", (grid,), lambda: lane_balance.main([]),
                  env=book)
    if not res["strided"]["max/mean"] >= res["lpt"]["max/mean"] >= 1.0:
        raise RuntimeError(f"lane_balance: {res}")
    for mod, want in ((balance_ab, ["strided", "balanced"]),
                      (balance_policy_ab, ["serpentine", "lpt"])):
        name = mod.__name__.rsplit(".", 1)[-1]
        med, _ = path(f"{name} SWEEP_M={SWEEP_M} SWEEP_ROUNDS={SWEEP_ROUNDS}", (grid,),
                      lambda mod=mod: mod.main([]), env=book)
        if list(med) != want:
            raise RuntimeError(f"{name}: {med}")
    med, _ = path(f"grid_pitchsweep SWEEP_M={SWEEP_M} SWEEP_ROUNDS={SWEEP_ROUNDS}", (grid,),
                  lambda: grid_pitchsweep.main([]), env=book)
    if (1.0, 2) not in med or (2.0, 2) not in med:
        raise RuntimeError(f"grid_pitchsweep: {med}")

    dense = {"SWEEP_ROUNDS": str(SWEEP_ROUNDS), "KS": ",".join(map(str, PAGED_KS))}
    med, _ = path(f"paged_ksweep KS={dense['KS']} SWEEP_ROUNDS={SWEEP_ROUNDS}", (paged,),
                  lambda: paged_ksweep.main([]), env=dense)
    if sorted(med) != sorted(PAGED_KS):
        raise RuntimeError(f"paged_ksweep: {med}")
    med, _ = path(f"paged_cellsweep SWEEP_ROUNDS={SWEEP_ROUNDS}", (paged,),
                  lambda: paged_cellsweep.main([]), env={"SWEEP_ROUNDS": str(SWEEP_ROUNDS)})
    if 1.0 not in med:
        raise RuntimeError(f"paged_cellsweep: {med}")
    return totals


def probes_phase(dev, smi, counters, plain_names, ptxas_lines) -> dict:
    """Phase 11: the section-cost probes.  Builds every variant library at
    once, holds the production library's ptxas lines to phase 2's, prints
    each variant's compiled figures (every duplication's SASS longer than
    production's), holds each duplication's first launch and 1080p x 1 spp
    image bit-equal to production's and ``freeze`` and each removal under
    it, grid and paged, bit-equal to its plain version on the scripts'
    frozen mid-flight states; then runs the three probe scripts in this
    process through ``script_runner``.  Returns (the kernels' launches over
    the scripts, {kernel: {variant: launches}})."""
    import torch

    from raytrace_tpu_torch import RenderConfig, _build
    from raytrace_tpu_torch.models.scene import generate_random_scene, random_sphere_field
    from raytrace_tpu_torch.ops import gridkernel as gk
    from raytrace_tpu_torch.ops import pagedkernel as pk
    from raytrace_tpu_torch.ops import trace
    from raytrace_tpu_torch.runtime import renderer as rmod
    from raytrace_tpu_torch.scripts import (grid_ablate, grid_iterbench, paged_iterbench,
                                            probe_runs)

    cuts = lambda switches: [("freeze", c) for c in switches if c.startswith("cut_")]  # noqa: E731
    grid_sets = [(d,) for d in gk.DUPLICATIONS] + [("freeze",)] + cuts(gk.SWITCHES)
    paged_sets = [("freeze",)] + cuts(pk.SWITCHES)
    gmask = {s: gk.switch_mask(s) for s in grid_sets}
    pmask = {s: pk.switch_mask(s, pk.SWITCHES, "paged") for s in paged_sets}
    t0 = time.perf_counter()
    infos = _build.build_many([(None, 0, 0)] + [(None, m, 0) for m in gmask.values()]
                              + [(None, 0, m) for m in pmask.values()])
    phase("probes", f"{len(infos) - 1} variant libraries ({len(gmask)} grid, {len(pmask)} "
          f"paged) built at once in {time.perf_counter() - t0:.1f} s")
    lines = [ln.strip() for ln in infos[0]["log"].splitlines() if "registers" in ln]
    if lines != ptxas_lines:
        raise RuntimeError(f"the production library's ptxas lines changed: {lines}")
    phase("probes", "the production library's ptxas lines == phase 2's")

    book_np = trace.prepare_scene(generate_random_scene(0.0))
    ds = trace.device_scene_from_numpy(book_np, dev)
    dds = trace.device_scene_from_numpy(trace.prepare_scene(random_sphere_field(DENSE_N)), dev)
    five, textured = pk.layout(dds.paged)[:2]
    reps = {"grid": probe_runs.compiled(dev, "grid", [0, *gmask.values()],
                                        probe_runs.grid_instance(ds.grid.five,
                                                                 ds.grid.n_slots)),
            "paged": probe_runs.compiled(dev, "paged", [0, *pmask.values()],
                                         probe_runs.paged_instance(five, textured))}
    for kernel, masks in (("grid", gmask), ("paged", pmask)):
        rep = reps[kernel]
        phase("probes", f"{kernel} production: {probe_runs.compiled_text(rep[0])}")
        for sw, m in masks.items():
            phase("probes", f"{kernel} {'+'.join(sw)}: "
                  f"{probe_runs.compiled_text(rep[m], rep[0])}")
            if sw[0] in gk.DUPLICATIONS and rep[m]["sass"] <= rep[0]["sass"]:
                raise RuntimeError(f"{sw[0]}: the compiler removed the duplicate")

    # the duplications: the first launch from the 1080p x 1 spp state and
    # the frame, bit-equal to the production kernel's
    cam = rmod.reference_camera()
    skip = trace.tmax_never_binds(generate_random_scene(0.0), cam)
    m_main = int(-(-(MAIN_W * MAIN_H) // rmod.lanes_target(dev, "grid")))
    f0, u0, scal, vpr, geom = trace.pack_state(
        ds, trace.viewport_arrays(cam, MAIN_W, MAIN_H), backend="grid", band_h=MAIN_H,
        width=MAIN_W, y0=0, seed_y0=0, offset_x=0, spp=1, number=0, pixels_per_lane=m_main)
    kw = dict(geom, max_depth=50, skip_tmax=skip, k_steps=gk.K_STEPS, j_steps=gk.J_STEPS)

    def launch(ablate):
        acc = trace.home_accum(None, geom["p_total"], dev)
        f, u = gk.grid_megakernel_step(scal, vpr, ds.grid, f0, u0, acc, ablate=ablate, **kw)
        return f, u, acc

    cfg = RenderConfig(samples=1, width=MAIN_W, height=MAIN_H)
    r = rmod.Renderer(cfg, device=dev)
    fb, ub, accb = launch(())
    img_b = r.render_call(1)
    ablate0 = gk.ABLATE
    try:
        for dup in gk.DUPLICATIONS:
            fd, ud, accd = launch((dup,))
            n_bad, _ = compare((fd, ud), (fb, ub))
            acc_bad, _ = compare((accd.T,), (accb.T,))
            gk.ABLATE = frozenset({dup})
            px_bad = int((r.render_call(1) != img_b).any(dim=2).sum())
            phase("probes", f"{dup}: first launch from the {MAIN_W}x{MAIN_H} x 1 spp state "
                  f"(M={m_main}): {n_bad} of {fd.shape[1]} lanes and {acc_bad} pixels differ "
                  f"from production; the frame: {px_bad} px differ")
            if n_bad or acc_bad or px_bad:
                raise RuntimeError(f"{dup} changes the image")
    finally:
        gk.ABLATE = ablate0

    phase("probes", f"builds, compiled figures and the duplications' checks in "
          f"{time.perf_counter() - t0:.1f} s")

    # freeze and the removals vs their plain versions on the scripts' states
    def frozen_check(kernel, step, plain, sets, f1, u1, kw1, tables):
        for sw in sets:
            outs = []
            for fn in (step, plain):
                acc = acc1.clone()
                out = fn(scal1, vpr1, tables, f1, u1, acc, ablate=sw, **kw1)
                outs.append((out, acc))
            torch.cuda.synchronize()
            n_bad, err = compare(outs[0][0], outs[1][0])
            acc_bad, _ = compare((outs[0][1].T,), (outs[1][1].T,))
            phase("probes", f"{kernel} {'+'.join(sw)} vs plain, one launch of {kw1['k_steps']} "
                  f"iterations on {f1.shape[1]} frozen lanes: {n_bad} lanes and {acc_bad} "
                  f"pixels differ, max |diff| {err}")
            if n_bad or acc_bad:
                raise RuntimeError(f"{kernel} {sw} differs from its plain version")

    f, u, scal1, vpr1, geom1 = trace.pack_state(
        ds, trace.viewport_arrays(cam, MAIN_W, MAIN_H), backend="grid", band_h=MAIN_H,
        width=MAIN_W, y0=0, seed_y0=0, offset_x=0, spp=grid_iterbench.SPP, number=0,
        pixels_per_lane=grid_iterbench.M)
    acc1 = trace.home_accum(None, geom1["p_total"], dev)
    kw1 = dict(geom1, max_depth=50, skip_tmax=True, k_steps=gk.K_STEPS, j_steps=gk.J_STEPS)
    f, u = gk.grid_megakernel_step(scal1, vpr1, ds.grid, f, u, acc1, **kw1)
    f, u = trace.gather_lanes(f, u, trace.live_lanes(u[gk.U_ALIVE]))
    frozen_check("grid", gk.grid_megakernel_step, gk.grid_megakernel_step_plain,
                 [s for s in grid_sets if s[0] == "freeze"], f, u, kw1, ds.grid)
    f, u, scal1, vpr1, geom1 = trace.pack_state(
        dds, trace.viewport_arrays(cam, MAIN_W, MAIN_H), backend="paged", band_h=MAIN_H,
        width=MAIN_W, y0=0, seed_y0=0, offset_x=0, spp=paged_iterbench.SPP, number=0,
        pixels_per_lane=paged_iterbench.M)
    acc1 = trace.home_accum(None, geom1["p_total"], dev)
    kw1 = dict(geom1, max_depth=50, skip_tmax=True, k_steps=pk.K_STEPS)
    f, u, key = pk.paged_megakernel_step(scal1, vpr1, dds.paged, f, u, acc1, **kw1)
    f, u = trace.gather_lanes(f, u, trace.live_order(key))
    f, u, _ = pk.paged_megakernel_step(scal1, vpr1, dds.paged, f, u, acc1, **kw1)
    frozen_check("paged", pk.paged_megakernel_step, pk.paged_megakernel_step_plain,
                 paged_sets, f, u, kw1, dds.paged)

    phase("probes", f"the frozen checks done at {time.perf_counter() - t0:.1f} s")

    # the three scripts, counted (and by variant)
    path, totals = script_runner("probes", smi, counters, plain_names, PROBE_KNOBS)
    for fn in (gk.grid_megakernel_step, pk.paged_megakernel_step):
        fn.variant_launches = {}
    rounds = {"SWEEP_ROUNDS": str(PROBE_ROUNDS), "ROUNDS": str(PROBE_ROUNDS)}
    grid, paged = "grid_megakernel_step", "paged_megakernel_step"
    dup_variants = ["base", *gk.DUPLICATIONS]
    for label, argv, env in (("exact", [], {}),
                             ("fast M=2", ["--mode", "fast"], {"M": str(SWEEP_M)})):
        med, _ = path(f"grid_ablate {label} SWEEP_ROUNDS={PROBE_ROUNDS}", (grid,),
                      lambda argv=argv: grid_ablate.main(argv), env=dict(rounds, **env))
        if sorted(med) != sorted(dup_variants):
            raise RuntimeError(f"grid_ablate {label}: {med}")
    for mode in ("exact", "fast"):
        env = dict(rounds, INVOKES=str(GRID_INVOKES), SWEEP_MODE=mode)
        med, _ = path(f"grid_iterbench SWEEP_MODE={mode} INVOKES={GRID_INVOKES} "
                      f"ROUNDS={PROBE_ROUNDS}", (grid,), lambda: grid_iterbench.main([]),
                      env=env)
        if len(med) != len(grid_iterbench.VARIANTS.split(",")):
            raise RuntimeError(f"grid_iterbench {mode}: {med}")
    med, _ = path(f"paged_iterbench INVOKES={PAGED_INVOKES} ROUNDS={PROBE_ROUNDS}", (paged,),
                  lambda: paged_iterbench.main([]),
                  env=dict(rounds, INVOKES=str(PAGED_INVOKES)))
    if len(med) != len(paged_iterbench.VARIANTS.split(",")):
        raise RuntimeError(f"paged_iterbench: {med}")
    by_variant = {grid: dict(gk.grid_megakernel_step.variant_launches),
                  paged: dict(pk.paged_megakernel_step.variant_launches)}
    phase("probes", f"launches by variant: {by_variant}")
    return totals, by_variant


def decode_png(path):
    """The u8 [H, W, 3] image of an RGB PNG written by ``utils/png.py``
    (8-bit RGB, filter 0 on every row)."""
    import numpy as np

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise RuntimeError(f"{path}: not a PNG")
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            if (depth, ctype) != (8, 2):
                raise RuntimeError(f"{path}: bit depth {depth}, colour type {ctype}")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if raw[:, 0].any():
        raise RuntimeError(f"{path}: a row filter other than 0")
    return raw[:, 1:].reshape(h, w, 3)


def port_runtime(dev, smi, kind, launches, counters, plain_names) -> dict:
    """Phase 7: the runtime ops (chip profile, device trace, FrameStats),
    the autotuner (M, J, K in-process; the block in worker processes), the
    C ABI through ctypes and its demo executable, and the entry file.  Each
    path that renders in this process runs with the launch counts set to 0
    just before it; returns the kernels' launches summed over them."""
    import ctypes
    import glob
    import shutil
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    import __graft_entry_torch__ as graft
    import raytrace_tpu_torch
    from raytrace_tpu_torch import RenderConfig, _build
    from raytrace_tpu_torch.ops import gridkernel
    from raytrace_tpu_torch.runtime import autotune, chips, profiling
    from raytrace_tpu_torch.runtime import renderer as rmod

    card = f"({smi})"
    totals = dict.fromkeys(launches(), 0)

    def path(tag, label, kernels, fn):
        return counted_path(tag, label, kernels, fn, launches, counters, plain_names,
                            totals)

    # ---- ops: the card's profile, a device trace, FrameStats ---------------
    prof = chips.profile_for(kind)
    m_main = rmod.band_layout(RenderConfig(width=MAIN_W, height=MAIN_H), dev, "grid",
                              MAIN_H)[0]
    block = _build.grid_block()
    env_block = os.environ.get(_build.GRID_BLOCK_ENV)
    phase("ops", f"profile_for({kind!r}): {prof.kind_substr!r} row (matched by name: "
          f"{prof.kind_substr in kind.lower()}), lanes_per_thread {prof.lanes_per_thread}, "
          f"block {prof.block}, K {prof.k_steps}, J {prof.j_steps}; the main path at "
          f"{MAIN_W}x{MAIN_H}: M={m_main}, K={gridkernel.K_STEPS}, J={gridkernel.J_STEPS}, "
          f"grid kernel block {block} (library {_build.build_dir(block).name}"
          f"{f', {_build.GRID_BLOCK_ENV}={env_block}' if env_block else ''})")
    if (prof is not chips.DEFAULT or m_main != 2
            or (gridkernel.K_STEPS, gridkernel.J_STEPS) != (prof.k_steps, prof.j_steps)
            or (block != prof.block and not env_block)):
        raise RuntimeError("the main path's operating point moved off the H100 profile")

    trace_dir = os.path.join(OUT, "trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    book = rmod.Renderer(RenderConfig(samples=MAIN_SPP, width=MAIN_W, height=MAIN_H),
                         device=dev)
    book.render()  # warm

    def traced():
        t0 = time.perf_counter()
        with profiling.device_trace(trace_dir, device=dev):
            book.render()
        return time.perf_counter() - t0

    sec = path("ops", "device_trace book render", ("grid_megakernel_step",), traced)
    counted = totals["grid_megakernel_step"]
    files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    if len(files) != 1:
        raise RuntimeError(f"device_trace wrote {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"]
    grid_ev = [e for e in kern if "grid_megakernel_step_kernel" in e.get("name", "")]
    grid_us = sum(float(e.get("dur", 0)) for e in grid_ev)
    phase("ops", f"device_trace around Renderer.render {MAIN_W}x{MAIN_H} x {MAIN_SPP} spp: "
          f"{sec:.3f} s with the profiler, {os.path.getsize(files[0])} B trace, "
          f"{len(kern)} CUDA kernel events, {len(grid_ev)} of the grid kernel "
          f"({grid_us / 1e3:.3f} ms) against {counted} launches counted {card}")
    if len(grid_ev) != counted:
        raise RuntimeError(f"the trace holds {len(grid_ev)} grid kernel events, the "
                           f"counter {counted}")

    one = rmod.Renderer(RenderConfig(samples=1, width=MAIN_W, height=MAIN_H), device=dev)
    one.render_call(1)  # warm
    stats = profiling.FrameStats()

    def frames():
        for _ in range(10):
            with stats.frame():
                one.render_call(1)
                torch.cuda.synchronize()

    path("ops", "FrameStats 10 frames", ("grid_megakernel_step",), frames)
    rep = stats.report()
    phase("ops", f"FrameStats {MAIN_W}x{MAIN_H} x 1 spp, 10 frames: {rep}, adaptive "
          f"window {stats.adaptive_frame_count()} frames {card}")
    if rep["frames"] != 10 or not rep["duration_per_frame"] > 0:
        raise RuntimeError(f"FrameStats: {rep}")

    # ---- autotune: (M, J, K) in-process, the block across processes ---------
    tmp = tempfile.mkdtemp(prefix="autotune-")
    saved_cache = autotune.CACHE_PATH
    autotune.CACHE_PATH = Path(tmp) / "tune.json"
    try:
        res = path("autotune", "autotune", ("grid_megakernel_step",),
                   lambda: autotune.autotune(MAIN_W, MAIN_H, spp=TUNE_SPP, rounds=2,
                                             mode="fast", verbose=False, device=dev))
        want = autotune.default_candidates(m_main, prof.j_steps, prof.k_steps)
        phase("autotune", f"{MAIN_W}x{MAIN_H} x {TUNE_SPP} spp fast, ns per sample by "
              f"MxJxK {res['candidates']}, best {res['m']}x{res['j']}x{res['k']}; every "
              f"candidate's accumulator {res['acc_hash']} {card}")
        if list(res["candidates"]) != [f"{m}x{j}x{k}" for m, j, k in want]:
            raise RuntimeError(f"autotune swept {list(res['candidates'])}, want {want}")
        if (gridkernel.K_STEPS, gridkernel.J_STEPS) != (prof.k_steps, prof.j_steps):
            raise RuntimeError("autotune left the grid kernel's J or K changed")
        t0 = time.perf_counter()
        blk = autotune.sweep_block(SWEEP_BLOCKS, MAIN_W, MAIN_H, spp=TUNE_SPP, rounds=3,
                                   m=m_main, j=prof.j_steps, k=prof.k_steps,
                                   mode="fast", verbose=False, device=dev)
        phase("autotune", f"sweep_block {SWEEP_BLOCKS} at {MAIN_W}x{MAIN_H} x {TUNE_SPP} "
              f"spp fast, M={m_main}: ns per sample {blk['block_candidates']}, best "
              f"{blk['block']}; registers, spill stores (ptxas, the most over the grid "
              f"kernel's instances), local bytes and blocks per SM (the book instance) "
              f"{blk['block_ptxas']}; refused {blk['block_refused']}; accumulator "
              f"{blk['acc_hash']}; {time.perf_counter() - t0:.1f} s {card}")
        if blk["block_refused"] or blk["acc_hash"] != res["acc_hash"]:
            raise RuntimeError("a block's image differs from block 128's or the sweep's "
                               "from the in-process one")
    finally:
        autotune.CACHE_PATH = saved_cache
        shutil.rmtree(tmp, ignore_errors=True)
    phase("autotune", f"main path library: grid kernel block {_build.grid_block()} "
          f"({_build.build_dir(_build.grid_block()).name}), K={gridkernel.K_STEPS}, "
          f"J={gridkernel.J_STEPS}")

    # ---- abi: the shim through ctypes, then the demo executable -------------
    abi = _build.abi_library()
    abi_dir, demo_dir = os.path.join(OUT, "abi"), os.path.join(OUT, "abi", "demo")
    shutil.rmtree(abi_dir, ignore_errors=True)
    os.makedirs(demo_dir)
    os.environ.pop("RAYTRACE_TORCH_DEVICE", None)
    lib = ctypes.CDLL(str(abi["lib"]))
    lib.ray_trace.argtypes = [ctypes.c_uint32, ctypes.c_bool, ctypes.c_uint32,
                              ctypes.c_uint32, ctypes.c_uint32]
    lib.ray_trace.restype = None

    def shim():
        cwd = os.getcwd()
        os.chdir(abi_dir)
        try:
            t0 = time.perf_counter()
            lib.ray_trace(MAIN_SPP, True, MAIN_W, MAIN_H, 1)
            torch.cuda.synchronize()
            return time.perf_counter() - t0
        finally:
            os.chdir(cwd)

    t_abi = path("abi", "ray_trace through the C ABI", ("grid_megakernel_step",), shim)
    ref_png = os.path.join(abi_dir, "in_process.png")

    def in_process():
        t0 = time.perf_counter()
        img = raytrace_tpu_torch.ray_trace(MAIN_SPP, True, MAIN_W, MAIN_H,
                                           out_path=ref_png)
        return img, time.perf_counter() - t0

    ref, t_ref = path("abi", "ray_trace in-process", ("grid_megakernel_step",), in_process)
    t0 = time.perf_counter()
    demo = subprocess.run(
        [str(abi["demo"]), "--samples", str(MAIN_SPP), "--width", str(MAIN_W),
         "--height", str(MAIN_H), "--store", "--bogus"],
        cwd=demo_dir, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=600)
    t_demo = time.perf_counter() - t0
    shim_img = decode_png(os.path.join(abi_dir, "render.png"))
    demo_png = os.path.join(demo_dir, "render.png")
    demo_img = decode_png(demo_png) if os.path.exists(demo_png) else None
    dpf = [ln for ln in demo.stdout.splitlines() if ln.startswith("duration_per_frame")]
    phase("abi", f"ray_trace({MAIN_SPP}, True, {MAIN_W}, {MAIN_H}, 1): through ctypes "
          f"{t_abi:.3f} s, in-process {t_ref:.3f} s, its PNG == the in-process image "
          f"{np.array_equal(shim_img, ref)}; demo exe {t_demo:.3f} s (a process: "
          f"interpreter, torch and CUDA start) rc {demo.returncode}, {dpf}, stderr "
          f"{demo.stderr.strip().splitlines()[:1]}, its PNG == the in-process image "
          f"{demo_img is not None and np.array_equal(demo_img, ref)} {card}")
    if not np.array_equal(shim_img, ref):
        raise RuntimeError("the C ABI's PNG differs from the in-process render")
    if (demo.returncode != 0 or "unknown argument: --bogus" not in demo.stderr or not dpf
            or demo_img is None or not np.array_equal(demo_img, ref)):
        raise RuntimeError(f"demo exe: rc {demo.returncode}\n{demo.stdout[-2000:]}\n"
                           f"{demo.stderr[-4000:]}")

    # ---- entry: the entry file's band step and its multi-device dry run -----
    fn, args = graft.entry()
    out = path("entry", "entry() on the card", ("grid_megakernel_step",),
               lambda: fn(*args))
    fn_cpu, args_cpu = graft.entry("cpu")
    plain = fn_cpu(*args_cpu)
    same = torch.equal(out.cpu(), plain)
    phase("entry", f"entry(): {tuple(out.shape)} on the card == the same fn on the CPU "
          f"(plain version): {same}")
    if not same:
        raise RuntimeError("entry(): the card's band differs from the CPU's")
    dry = path("entry", f"dryrun_multichip({N_BANDS})",
               ("grid_megakernel_step", "paged_megakernel_step"),
               lambda: graft.dryrun_multichip(N_BANDS))
    phase("entry", f"dryrun_multichip({N_BANDS}) over {[str(dev)] * N_BANDS}: "
          f"{ {k: (v.shape, float(v.sum())) for k, v in dry.items()} }")
    return totals


def main() -> int:
    import torch

    t_start = time.perf_counter()
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    import raytrace_tpu_torch
    from raytrace_tpu_torch import RenderConfig, _build, bench
    from raytrace_tpu_torch.models.scene import (generate_random_scene,
                                                 random_sphere_field,
                                                 three_sphere_scene)
    from raytrace_tpu_torch.ops import (gridkernel, megakernel, pagedkernel,
                                        pallas_intersect, trace)
    from raytrace_tpu_torch.ops.image import accum_to_u8
    from raytrace_tpu_torch.runtime import balance, validation
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
    phase("build", f"{info['seconds']:.1f} s (0 = cached), {info['lib'].name} (grid "
          f"kernel block {info['block']}) from "
          f"{', '.join(_build.SOURCES)}; PTX clean of {', '.join(_build.FORBIDDEN_PTX)}; "
          f"ptxas: {regs}")
    _build.library()

    # ---- 3. kernels vs plain versions at the main path's shapes ------------
    scene = generate_random_scene(0.0)
    ds = trace.device_scene_from_numpy(trace.prepare_scene(scene), dev)
    cam = rmod.reference_camera()
    skip = trace.tmax_never_binds(scene, cam)
    atab = ds.table[:, 8:24].T.contiguous()
    dense_scene = random_sphere_field(DENSE_N)
    dds = trace.device_scene_from_numpy(trace.prepare_scene(dense_scene), dev)
    if dds.paged is None:
        raise RuntimeError("the 100k-sphere field built no paged tables")
    dense_skip = trace.tmax_never_binds(dense_scene, cam)
    records = {}
    step_work = {}  # "name label": the plain version's exact-mode work tally

    def nbytes(*tensors):
        return sum(t.numel() * t.element_size() for t in tensors if t is not None)

    def lanes_m(backend, w, h):
        """The renderer's M for (w, h) on this card."""
        return int(np.clip(-(-(w * h) // rmod.lanes_target(dev, backend)), 1, rmod.M_MAX))

    def step_state(backend, dsc, w, h, spp, full_h=None, m=None, **pack):
        """A band state at (w, h)'s lane count (the renderer's M, or ``m``):
        the top band of an image ``full_h`` rows high (default: the whole
        image)."""
        m = m or lanes_m(backend, w, h)
        vp = trace.viewport_arrays(cam, w, full_h or h)
        return m, trace.pack_state(
            dsc, vp, backend=backend, band_h=h, width=w, y0=0, seed_y0=0,
            offset_x=0, spp=spp, number=0, pixels_per_lane=m, **pack)

    def step_timing(ms, plain_ms, work, moved):
        ops = (OPS_QUADRATIC * work["quadratics"] + OPS_LANE_ITER * work["lane_iters"]
               + OPS_SEGMENT * work.get("segments", 0))
        bound_ms, bound_by = bound(moved, ops)
        text = (f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms per launch, "
                f"bound {bound_ms:.4f} ms ({bound_by}: {moved} B, {ops} ops; work {work})")
        return bound_ms, bound_by, text

    def check_step(name, backend, dsc, w, h, spp, skip_tmax, kern, plain, call,
                   tables, label="", accum=False, compact=None, check=None,
                   pack=None, strict=False, full_h=None, m=None, timed=True):
        """Pack a band state at (w, h)'s lane count, take it two launches
        in, then one kernel launch and one plain call from there in exact and
        fast mode; time both in exact mode.  ``call(k, scal, vpr, f, u, g,
        acc, **x)`` runs step ``k``; ``accum``: it adds into a home-order
        accumulator, compared pixel for pixel; ``compact(out)``: the
        driver's live lanes (f, u) of a step's output or of the packed state,
        taken before every launch; ``check(out)``: (count, what) of a further
        disagreement in the kernel's output; ``pack``: further arguments of
        ``pack_state``; ``strict``: every lane must be bit-equal (else
        99.9%); ``full_h``: the state is the top band of an image that
        high; ``m``: pixels per lane in place of the renderer's; ``timed``:
        time the exact-mode launch (else its times are None).  Returns
        (exact-mode input, max |diff|, ms, plain ms, bound ms, bound by)."""
        m, (f0, u0, scal, vpr, geom) = step_state(backend, dsc, w, h, spp, full_h, m,
                                                  **(pack or {}))
        live = compact or (lambda out: out[:2])
        max_err, res = 0.0, None
        for mode, rr in (("exact", None), ("fast", RenderConfig(mode="fast").rr)):
            g = dict(geom, max_depth=50, skip_tmax=skip_tmax, rr=rr)
            acc = trace.home_accum(None, geom["p_total"], dev) if accum else None
            out = (f0, u0)
            for _ in range(2):
                out = call(kern, scal, vpr, *live(out), g, acc)
            f1, u1 = live(out)
            acc_k, acc_p = (acc.clone(), acc.clone()) if accum else (None, None)
            work = {}
            out_k = call(kern, scal, vpr, f1, u1, g, acc_k)
            out_p = call(plain, scal, vpr, f1, u1, g, acc_p, work=work)
            torch.cuda.synchronize()
            n_bad, err = compare(out_k, out_p)
            acc_bad, acc_err = compare((acc_k.T,), (acc_p.T,)) if accum else (0, 0.0)
            n_odd, odd = check(out_k) if check else (0, "")
            max_err = max(max_err, err, acc_err)
            n = f1.shape[1]
            timing = ""
            if mode == "exact" and not timed:
                res = ((f1, u1), None, None, None, None)
            elif mode == "exact":
                acc_t = acc.clone() if accum else None
                ms = cuda_ms(lambda: call(kern, scal, vpr, f1, u1, g, acc_t), 5)
                plain_ms = cuda_ms(lambda: call(plain, scal, vpr, f1, u1, g, acc_t), 2)
                # the lanes' state in and out, any further output (a key
                # row), each flushed pixel's slot read and written, the
                # tables once
                moved = (2 * nbytes(f1, u1) + nbytes(*out_k[2:])
                         + (24 * work.get("flushes", 0) if accum else 0)
                         + nbytes(scal, vpr, *tables))
                bound_ms, bound_by, timing = step_timing(ms, plain_ms, work, moved)
                res = ((f1, u1), ms, plain_ms, bound_ms, bound_by)
                step_work[f"{name}{label}"] = work
            pix = f", {acc_bad} of {geom['p_total']} accumulator pixels differ" if accum else ""
            odd_txt = f", {n_odd} {odd}" if check else ""
            phase("kernel", f"{name}{label} {mode}: {n} lanes of {geom['n_lanes']} (M={m}), "
                  f"{n_bad} lanes differ from the plain version{pix}{odd_txt}, max |diff| "
                  f"{max(err, acc_err)}{timing}")
            if n_bad > (0 if strict else n // 1000) or acc_bad or n_odd:
                raise RuntimeError(f"{name}{label} {mode}: {n_bad}/{n} lanes, {acc_bad} "
                                   f"pixels{odd_txt} differ")
        return res[0], max_err, *res[1:]

    def record(name, src, repl, max_err, ms, plain_ms, bound_ms, bound_by, **extra):
        records[name] = dict(name=name, route="cuda", source=src, replaces=repl,
                             launches=0, max_abs_err=max_err, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=None, **extra)

    # what the card makes of the redesigned kernels' instances
    for five, n_slots, iterstats in ((0, 4, 0), (0, 6, 0), (1, 6, 0), (0, 4, 1)):
        occ = _build.occupancy("grid", five, n_slots, iterstats, dev.index)
        phase("occupancy", f"grid kernel, {5 if five else 4}-value layout, "
              f"{n_slots} slots{', iterstats' if iterstats else ''}: {occ}")
    occ = _build.occupancy("intersect", dev.index)
    phase("occupancy", f"fused intersect kernel: {occ}")

    # the grid kernel two launches into the 1080p frame, on the driver's live
    # lanes, with its home-order accumulator
    def grid_live(out):
        return trace.gather_lanes(out[0], out[1], trace.live_lanes(out[1][gridkernel.U_ALIVE]))

    def grid_call(dsc=ds, **step):
        return lambda k, s, v, f, u, g, acc, **x: k(s, v, dsc.grid, f, u, acc, **g, **step, **x)

    grid_tables = [t for t in ds.grid if torch.is_tensor(t)]
    _, g_err, *g_res = check_step(
        "grid_megakernel_step", "grid", ds, MAIN_W, MAIN_H, MAIN_SPP, skip,
        gridkernel.grid_megakernel_step, gridkernel.grid_megakernel_step_plain,
        grid_call(), grid_tables, accum=True, compact=grid_live, strict=True)
    # the variants: a merged state (4 calls of 16 spp, the last of 5), a
    # balanced table from a real probe (2 spp at M=2), the iterstats
    # instance; and phase 9's 1-spp frame loops, 65 merged calls of 1 spp
    # under the balanced table of their M (the probe's per-pixel costs, as
    # balance_msweep shares one probe over its Ms): spp1_loop_sweep's Ms and
    # the bench's M = 16
    m_main = lanes_m("grid", MAIN_W, MAIN_H)
    vp_main = trace.viewport_arrays(cam, MAIN_W, MAIN_H)
    cost = balance.measure_cost_map(dict(
        scene=ds, vp=vp_main, band_h=MAIN_H, width=MAIN_W, y0=0, seed_y0=0, offset_x=0,
        number=0, max_depth=50, backend="grid", pixels_per_lane=m_main, skip_tmax=skip,
        rr=RenderConfig(mode="fast").rr), 2)
    tables = {m: torch.from_numpy(balance.build_passign(cost, m, trace.LANE_PAD)).to(dev)
              for m in {m_main, bench.FRAME_LOOP_M, *LOOP_SWEEP_MS}}
    table = tables[m_main]
    loop = dict(n_calls=bench.FRAME_LOOP_CALLS, spp_last=1)
    variants = {"merged": (MAIN_SPP, m_main, dict(n_calls=4, spp_last=5), {}),
                "balanced": (MAIN_SPP, m_main, dict(passign=table), dict(passign=table)),
                "iterstats": (MAIN_SPP, m_main, {}, dict(iterstats=True))}
    for m in sorted({bench.FRAME_LOOP_M, *LOOP_SWEEP_MS}):
        m_loop, chunk = rmod.band_layout(RenderConfig(width=MAIN_W, height=MAIN_H,
                                                      pixels_per_lane=m), dev, "grid", MAIN_H)
        if (m_loop, chunk) != (m, MAIN_H):
            raise RuntimeError(f"the frame loop at M={m} renders {chunk}-row bands at "
                               f"M={m_loop}, not the state checked here")
        variants[f"frame_loop_m{m}"] = (1, m, dict(loop, passign=tables[m]),
                                        dict(passign=tables[m]))
    variant_ms = {}
    for label, (spp, m, pack, step) in variants.items():
        _, v_err, v_ms, v_plain_ms, *_ = check_step(
            "grid_megakernel_step", "grid", ds, MAIN_W, MAIN_H, spp, skip,
            gridkernel.grid_megakernel_step, gridkernel.grid_megakernel_step_plain,
            grid_call(**step), grid_tables + ([step["passign"]] if "passign" in step else []),
            label=f" ({label})", accum=True, compact=grid_live, pack=pack, strict=True, m=m)
        g_err = max(g_err, v_err)
        variant_ms[f"{label}_ms"], variant_ms[f"{label}_plain_ms"] = v_ms, v_plain_ms
    record("grid_megakernel_step", "raytrace_tpu_torch/csrc/gridkernel.cu",
           "raytrace_tpu/ops/gridkernel.py:1123", g_err, *g_res, **variant_ms)

    # the brute-force kernel scans the valid prefix of the table; its plain
    # version scans every row
    def mega_call(dsc, at=None):
        n_valid = int(dsc.valid.sum())
        at = dsc.table[:, 8:24].T.contiguous() if at is None else at

        def call(k, s, v, f, u, g, acc, **x):
            if k is megakernel.megakernel_step:
                x = dict(x, n_valid=n_valid)
            return k(s, v, dsc.table, at, f, u, **g, **x)
        return call

    # row 1: the three-sphere state, the path that launches the kernel;
    # the book-scene state as a second figure
    three = three_sphere_scene()
    ds3 = trace.device_scene_from_numpy(trace.prepare_scene(three), dev)
    atab3 = ds3.table[:, 8:24].T.contiguous()
    (_, err3, *res3), ((f_mid, _), errb, *resb) = (
        check_step("megakernel_step", "mega", dsc, MAIN_W, MAIN_H, MAIN_SPP, sk,
                   megakernel.megakernel_step, megakernel.megakernel_step_plain,
                   mega_call(dsc, at), [dsc.table, at], label=label)
        for label, dsc, at, sk in (
            (" (three-sphere)", ds3, atab3, trace.tmax_never_binds(three, cam)),
            (" (book)", ds, atab, skip)))
    record("megakernel_step", "raytrace_tpu_torch/csrc/megakernel.cu",
           "raytrace_tpu/ops/megakernel.py:473", max(err3, errb), *res3,
           book_ms=resb[0], book_plain_ms=resb[1], book_bound_ms=resb[2])

    # the paged kernel on the driver's sorted and compacted live lanes, two
    # launches into the 100k frame; its home-order accumulator and its key
    # row are checked too
    gs = dds.paged.gscal

    def paged_live(out, dsc=dds):  # the packed state has no key row yet
        key = (out[2] if len(out) > 2
               else trace._rebucket_key(out[0], out[1], dsc.paged.gscal))
        return trace.gather_lanes(out[0], out[1], trace.live_order(key))

    def paged_on(dsc, k_steps=None):
        """The paged step on ``dsc``'s tables at ``k_steps`` iterations
        (default: ``scaled_k`` of the lane count, as the driver)."""
        def call(k, s, v, f, u, g, acc, **x):
            return k(s, v, dsc.paged, f, u, acc, **g, **x,
                     k_steps=k_steps or pagedkernel.scaled_k(g["n_lanes"]))
        return call

    paged_call = paged_on(dds)

    def key_check(out, dsc=dds):
        return (int((out[2] != trace._rebucket_key(out[0], out[1], dsc.paged.gscal)).sum()),
                "key rows differ from _rebucket_key")

    def paged_tables(dsc):
        g = dsc.paged
        return [g.geom, g.lids, g.attrs, g.gtab, g.gscal]

    _, p_err, *p_res = check_step(
        "paged_megakernel_step", "paged", dds, DENSE_W, DENSE_H, DENSE_SPP, dense_skip,
        pagedkernel.paged_megakernel_step, pagedkernel.paged_megakernel_step_plain,
        paged_call, [dds.paged.geom, dds.paged.lids, dds.paged.attrs, dds.paged.gtab, gs],
        accum=True, compact=paged_live, check=key_check)
    record("paged_megakernel_step", "raytrace_tpu_torch/csrc/pagedkernel.cu",
           "raytrace_tpu/ops/pagedkernel.py:794", p_err, *p_res)

    # the band set-up kernel against its plain version (``pack_state_plain``
    # on the card) at the cells' states: the book's 1080p band at the
    # renderer's M with and without its balanced table, the 1-spp frame's
    # call (65 merged calls under the M = 16 table), the 100k field's 4K band
    # with its first sort key, the three-sphere mega state with a carried
    # accumulator, and a band below the top with an x offset and no samples;
    # every row and lane bit-equal.  Timed: the kernel alone (CUDA events
    # between launches queued behind a spin, so the host's dispatch is off
    # the device's clock; median of 5) against the bytes it writes and reads
    # at 3.35 TB/s or its integer operations (two TEA hashes, ~520 a lane)
    # at 64 a clock per SM at 1980 MHz, whichever is larger; the plain
    # version by ``cuda_ms``.
    def pack_kernel_ms(out, dsc, backend, kw, reps=5):
        f, u, s, v, geom = out[:5]
        lane0 = {"grid": gridkernel.U_LANE0, "paged": pagedkernel.U_LANE0}.get(backend, -1)
        args = dict(vpr_host=v.cpu().numpy(), scal_host=s.cpu().numpy(), lane0_row=lane0,
                    n_lanes=geom["n_lanes"], p_total=geom["p_total"], width=geom["width"])
        gscal = dsc.paged.gscal if backend == "paged" else None
        events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)  # ~10 ms: the launches queue behind it
        for i in range(reps):
            events[i].record()
            trace.pack_kernel(f, u, out[5] if len(out) > 5 else None, v, s,
                              kw.get("passign"), gscal, **args)
        events[reps].record()
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in zip(events, events[1:]))

    def check_pack(label, backend, dsc, w, h, spp, m, timed=False, **pack):
        vp_ = trace.viewport_arrays(cam, w, h + pack.get("y0", 0))
        kw = dict(backend=backend, band_h=h, width=w, y0=0, seed_y0=0, offset_x=0,
                  spp=spp, number=0, pixels_per_lane=m, first_key=backend == "paged")
        kw.update(pack)
        out_k = trace.pack_state(dsc, vp_, **kw)
        out_p = trace.pack_state_plain(dsc, vp_, **kw)
        torch.cuda.synchronize()
        names = ("fstate", "ustate", "scal", "vpr", "geom", "key")
        bad = {name: int((a.view(torch.int32) != b.view(torch.int32))
                         .reshape(a.shape[0] if a.dim() > 1 else 1, -1).any(dim=0).sum())
               for name, a, b in zip(names, out_k, out_p) if name != "geom"}
        n = out_k[0].shape[1]
        text, res = "", (None, None, None, None)
        if timed:
            ms = pack_kernel_ms(out_k, dsc, backend, kw)
            plain_ms = cuda_ms(lambda: trace.pack_state_plain(dsc, vp_, **kw), 2)
            moved = (nbytes(*[t for i, t in enumerate(out_k) if i != 4])
                     + (n * 4 if "passign" in pack else 0))
            t_bytes = moved / HBM_BYTES_PER_S * 1e3
            t_ops = PACK_INT_OPS * n / INT32_OPS_PER_S * 1e3
            bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                                               "operations")
            text = (f"; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms per set-up, bound "
                    f"{bound_ms:.4f} ms ({bound_by}: {moved} B, {PACK_INT_OPS * n} integer "
                    f"ops)")
            res = (ms, plain_ms, bound_ms, bound_by)
        phase("kernel", f"pack_state ({label}): {n} lanes (M={m}, {backend}), lanes "
              f"differing from the plain version {bad}, geometry equal "
              f"{out_k[4] == out_p[4]}{text}")
        if any(bad.values()) or out_k[4] != out_p[4]:
            raise RuntimeError(f"pack_state ({label}): kernel != plain {bad}")
        return res

    three_acc = torch.rand((MAIN_H, MAIN_W, 3), device=dev)
    pack_ms = {}
    for key, label, backend, dsc, w, h, spp, m, timed, pack in (
            ("book", f"book {MAIN_W}x{MAIN_H}", "grid", ds, MAIN_W, MAIN_H, MAIN_SPP, m_main,
             True, {}),
            ("balanced", f"book {MAIN_W}x{MAIN_H} balanced", "grid", ds, MAIN_W, MAIN_H,
             MAIN_SPP, m_main, True, dict(passign=table)),
            ("frame", "the 1-spp frame's call", "grid", ds, MAIN_W, MAIN_H, 1,
             bench.FRAME_LOOP_M, True, dict(loop, passign=tables[bench.FRAME_LOOP_M])),
            ("field", f"{DENSE_N}-sphere field {DENSE_W}x{DENSE_H}", "paged", dds, DENSE_W,
             DENSE_H, DENSE_SPP, lanes_m("paged", DENSE_W, DENSE_H), True, {}),
            ("three", "three-sphere, carried accumulator", "mega", ds3, MAIN_W, MAIN_H,
             MAIN_SPP, lanes_m("mega", MAIN_W, MAIN_H), False, dict(accum_init=three_acc)),
            ("book_band", "book band y0=270 offset_x=64, 0 spp", "grid", ds, MAIN_W - 64, 270,
             0, m_main, False, dict(y0=270, seed_y0=270, offset_x=64)),
            ("field_band", "field band y0=540 offset_x=64", "paged", dds, DENSE_W - 64, 540,
             DENSE_SPP, 3, False, dict(y0=540, seed_y0=540, offset_x=64))):
        pack_ms[key] = check_pack(label, backend, dsc, w, h, spp, m, timed, **pack)
    timings = {f"{key}{suffix}": r[i] for key, r in pack_ms.items() if key != "book"
               and r[0] is not None for i, suffix in ((0, "_ms"), (1, "_plain_ms"),
                                                      (2, "_bound_ms"))}
    record("pack_state", "raytrace_tpu_torch/csrc/packstate.cu",
           "none (port only: raytrace_tpu/ops/trace.py pack_state is one XLA fusion)", 0.0,
           *pack_ms["book"], **timings)

    # the layouts and operating points that phase 10's scripts launch beyond
    # the main path's, each at the script's scene, size, M and spp (every
    # lane and accumulator pixel bit-equal, exact and fast; untimed):
    # hw_validate's fields (the 5-value varied grid, the grid's ttab, the
    # paged varied and has_tex fields) on their kernel and on the
    # megakernel, its book at M = 64 on both and its pitch-2 grid;
    # grid_pitchsweep's 16-slot grids at the card's M = 2; paged_ksweep's
    # K = 10 with K_AUTO off and paged_cellsweep's cell scale 0.7 on the
    # 100k field at 1920x1080
    from raytrace_tpu_torch.models import paged_grid
    from raytrace_tpu_torch.models.grid import build_grid
    from raytrace_tpu_torch.ops.intersect import sphere_table
    from raytrace_tpu_torch.scripts import grid_pitchsweep as gps
    from raytrace_tpu_torch.scripts import hw_validate as hv

    def on_card(host):
        return trace.device_scene_from_numpy(host, dev)

    fields = {name: on_card(trace.prepare_scene(sc)) for name, sc in (
        ("varied", hv.varied_field()), ("ttab", hv.ttab_field()),
        ("paged varied", hv.paged_field()), ("paged has_tex", hv.paged_field(textured=True)))}
    book_host, book_table = trace.prepare_scene(scene), sphere_table(scene)
    grids = [("book", ds, hv.BOOK_W, hv.BOOK_H, hv.BOOK_M, hv.BOOK_SPP),
             ("5-value varied", fields["varied"], hv.W, hv.H, hv.M, hv.VARIED_SPP),
             ("ttab", fields["ttab"], hv.W, hv.H, hv.M, hv.TTAB_SPP),
             ("pitch 2", on_card(book_host._replace(grid=build_grid(
                 scene, book_table, pitch=2.0))), hv.W, hv.H, hv.M, hv.PITCH_SPP)]
    for p in [float(p) for p in gps.PITCHES.split(",")][1:]:
        g = build_grid(scene, book_table, pitch=p, max_slots=gps.MAX_SLOTS)
        if g is None:
            raise RuntimeError(f"the book scene's grid at pitch {p} does not build")
        grids.append((f"pitch {p}, {gps.MAX_SLOTS} slots", on_card(book_host._replace(grid=g)),
                      MAIN_W, MAIN_H, SWEEP_M, gps.SPP))
    for label, dsc, w, h, m, spp in grids:
        _, err, *_ = check_step(
            "grid_megakernel_step", "grid", dsc, w, h, spp, True,
            gridkernel.grid_megakernel_step, gridkernel.grid_megakernel_step_plain,
            grid_call(dsc), [t for t in dsc.grid if torch.is_tensor(t)],
            label=f" ({label}, M={m})", accum=True, compact=grid_live, strict=True, m=m,
            timed=False)
        records["grid_megakernel_step"]["max_abs_err"] = max(
            records["grid_megakernel_step"]["max_abs_err"], err)
    field_spp = {"varied": hv.VARIED_SPP, "ttab": hv.TTAB_SPP, "paged varied": hv.PAGED_SPP,
                 "paged has_tex": hv.PAGED_TEX_SPP}
    megas = [("book", ds, hv.BOOK_W, hv.BOOK_H, hv.BOOK_M, 1)] + [
        (name, dsc, hv.W, hv.H, hv.M, field_spp[name]) for name, dsc in fields.items()]
    for label, dsc, w, h, m, spp in megas:
        _, err, *_ = check_step(
            "megakernel_step", "mega", dsc, w, h, spp, True,
            megakernel.megakernel_step, megakernel.megakernel_step_plain, mega_call(dsc),
            [dsc.table], label=f" ({label}, M={m})", strict=True, m=m, timed=False)
        records["megakernel_step"]["max_abs_err"] = max(
            records["megakernel_step"]["max_abs_err"], err)
    s0 = paged_grid.CELL_SIZE_SCALE
    paged_grid.CELL_SIZE_SCALE = 0.7
    try:
        dds07 = on_card(trace.prepare_scene(dense_scene))
    finally:
        paged_grid.CELL_SIZE_SCALE = s0
    if dds07.paged is None:
        raise RuntimeError("the 100k field built no paged tables at cell scale 0.7")
    pageds = [(name, fields[name], hv.W, hv.H, hv.M, field_spp[name], None)
              for name in ("paged varied", "paged has_tex")]
    pageds += [(f"K={PAGED_KS[0]}, K_AUTO off", dds, MAIN_W, MAIN_H, None, DENSE_SPP,
                PAGED_KS[0]),
               ("cell scale 0.7", dds07, MAIN_W, MAIN_H, None, DENSE_SPP, None)]
    for label, dsc, w, h, m, spp, k_steps in pageds:
        _, err, *_ = check_step(
            "paged_megakernel_step", "paged", dsc, w, h, spp, True,
            pagedkernel.paged_megakernel_step, pagedkernel.paged_megakernel_step_plain,
            paged_on(dsc, k_steps), paged_tables(dsc), label=f" ({label})", accum=True,
            compact=lambda out, dsc=dsc: paged_live(out, dsc),
            check=lambda out, dsc=dsc: key_check(out, dsc), strict=True, m=m, timed=False)
        records["paged_megakernel_step"]["max_abs_err"] = max(
            records["paged_megakernel_step"]["max_abs_err"], err)

    # the fused intersect kernel on the rays of the book-scene state two
    # launches into a 1080p render (259,200 camera and bounce rays)
    # (the kernel scans the valid prefix; the plain version every row)
    o = f_mid[0:3].T.contiguous()
    d = f_mid[3:6].T.contiguous()
    n_valid = int(ds.valid.sum())

    def pk_call():
        return pallas_intersect.intersect_shade_pallas(o, d, ds.table, n_valid=n_valid)

    out_k = pk_call()
    out_p = pallas_intersect.intersect_shade_pallas_plain(o, d, ds.table)
    torch.cuda.synchronize()
    n_bad, err = compare([x.reshape(x.shape[0], -1).T for x in out_k],
                         [x.reshape(x.shape[0], -1).T for x in out_p])
    ms = cuda_ms(pk_call, 10)
    plain_ms = cuda_ms(lambda: pallas_intersect.intersect_shade_pallas_plain(o, d, ds.table), 3)
    n_rays = o.shape[0]
    ops = OPS_QUADRATIC * n_rays * n_valid + OPS_LANE_ITER * n_rays
    moved = nbytes(o, d, ds.table, *out_k[0:1], out_k[2])
    bound_ms, bound_by = bound(moved, ops)
    phase("kernel", f"intersect_shade_pallas: {n_rays} rays x {ds.table.shape[0]} rows, "
          f"{n_bad} rays differ from the plain version, max |diff| {err}, "
          f"{int(out_k[1].sum())} hits, {n_valid} valid rows scanned; kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms per call, bound {bound_ms:.4f} ms "
          f"({bound_by}: {moved} B, {ops} ops)")
    if n_bad > n_rays // 1000:
        raise RuntimeError(f"intersect_shade_pallas: {n_bad}/{n_rays} rays differ (> 0.1%)")
    records["intersect_shade_pallas"] = dict(
        name="intersect_shade_pallas", route="cuda",
        source="raytrace_tpu_torch/csrc/intersect.cu",
        replaces="raytrace_tpu/ops/pallas_intersect.py:104", launches=0,
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None)

    # ---- 4. gates ----------------------------------------------------------
    def render(dsc, backend, w, h, spp, depth, m_, skip_tmax=skip):
        vp_ = trace.viewport_arrays(cam, w, h)
        out = trace.render_band(
            dsc, vp_, band_h=h, width=w, y0=0, seed_y0=0, offset_x=0, spp=spp,
            number=0, max_depth=depth, backend=backend, pixels_per_lane=m_,
            skip_tmax=skip_tmax)
        return out.cpu().numpy()

    # the JAX package's gates (runtime/validation.py), on the card
    g24 = np.load(validation.GOLDEN)
    for backend in ("bruteforce", "mega", "grid"):
        single = validation.golden_check(backend, device=dev)
        multi = validation.golden_check(backend, multi_tile=True, device=dev)
        out24, _ = validation._render_golden_config(backend, False, device=dev)
        off24 = int((np.abs(out24 - g24).max(axis=2) > 1e-4).sum())
        phase("golden", f"golden_check {backend}: 24x14 {single}, {off24}/336 px off by > "
              f"1e-4; 128x72 {multi}")
        if not (single["ok"] and multi["ok"]) or off24 > 3 or multi["bad_px"] > 9216 // 100:
            raise RuntimeError(f"{backend} disagrees with the oracle goldens")
    gates = [validation.bitident_check("grid", "mega", mode=mode, device=dev)
             for mode in ("exact", "fast")]
    gates += [validation.merge_check(device=dev), validation.bandsplit_check(device=dev)]
    for res in gates:
        phase("golden", f"{res}")
        if not res["bit_identical"]:
            raise RuntimeError(f"gate failed: {res}")
    res = validation.fast_check(device=dev)
    phase("golden", f"{res}")
    if not res["ok"]:
        raise RuntimeError(f"gate failed: {res}")
    a = render(ds, "grid", 128, 72, 2, 4, 1)
    b = render(ds, "mega", 128, 72, 2, 4, 1)
    n_diff = int((a != b).any(axis=2).sum())
    phase("golden", f"grid == mega at 128x72 depth 4: {n_diff} px differ")
    if n_diff:
        raise RuntimeError("grid and mega differ at depth 4")
    a = render(dds, "paged", 128, 72, 2, 4, 1, dense_skip)
    b = render(dds, "mega", 128, 72, 2, 4, 1, dense_skip)
    n_diff = int((a != b).any(axis=2).sum())
    phase("golden", f"paged == mega on the {DENSE_N}-sphere field at 128x72 depth 4: "
          f"{n_diff} px differ (mean of the color sums {float(a.mean()):.4f})")
    if n_diff:
        raise RuntimeError("paged and mega differ at depth 4")
    bf = render(ds, "bruteforce", 24, 14, 2, 12, 1)
    pk = render(ds, "pallas", 24, 14, 2, 12, 4)
    mm = render(ds, "matmul", 24, 14, 2, 12, 1)
    pk_close = float((np.abs(bf - pk).max(axis=2) < 0.05).mean())
    pk_mean = abs(bf.mean() - pk.mean()) / bf.mean()
    mm_close = float((np.abs(mm - g24).max(axis=2) < 0.05).mean())
    mm_mean = abs(mm.mean() - g24.mean()) / g24.mean()
    phase("golden", f"pallas vs bruteforce at 24x14: {pk_close:.2%} px within 0.05 "
          f"(rule > 85%), mean off {pk_mean:.4f} (rule < 0.05); matmul vs golden: "
          f"{mm_close:.2%} within 0.05 (rule > 80%), mean off {mm_mean:.4f} (rule < 0.1)")
    if not (pk_close > 0.85 and pk_mean < 0.05 and mm_close > 0.80 and mm_mean < 0.1):
        raise RuntimeError("the pallas or matmul backend fails its statistical rule")

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
    # and at the main path's full width, exact mode (the renders through
    # Renderer here: the merged against the host loop, the balanced against
    # the unbalanced, exact and fast)
    for mode in ("exact", "fast"):
        def full(**kw):
            cfg = RenderConfig(samples=MAIN_SPP, width=MAIN_W, height=MAIN_H, mode=mode, **kw)
            return rmod.Renderer(cfg, device=dev).render()[0]
        host = full(samples_per_call=4)
        merged = full(samples_per_call=4, calls_per_exec=4)
        plain_map = full()
        balanced = full(balance_spp=8)
        n_merge = int((merged != host).any(dim=2).sum())
        n_bal = int((balanced != plain_map).any(dim=2).sum())
        phase("golden", f"{MAIN_W}x{MAIN_H} x {MAIN_SPP} spp {mode}: merged (4 spp per call, "
              f"4 calls per dispatch) vs host loop {n_merge} px differ; balanced "
              f"(balance_spp=8) vs unbalanced {n_bal} px differ")
        if n_merge or n_bal:
            raise RuntimeError(f"merged or balanced render differs ({mode})")
    walls = {}
    for backend in ("grid", "mega"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        raytrace_tpu_torch.ray_trace(samples=MAIN_SPP, width=MAIN_W, height=MAIN_H,
                                     backend=backend)
        torch.cuda.synchronize()
        walls[backend] = time.perf_counter() - t0
        imgs[backend] = seen["accum"]
    n_diff = int((imgs["grid"] != imgs["mega"]).any(dim=2).sum())
    phase("golden", f"ray_trace grid == mega at {MAIN_W}x{MAIN_H} x {MAIN_SPP} spp, "
          f"depth 50: {n_diff} px differ (walls {walls})")
    if n_diff:
        raise RuntimeError("grid and mega differ at full width")

    # ---- 5. main path ------------------------------------------------------
    plains = (gridkernel.grid_megakernel_step_plain, megakernel.megakernel_step_plain,
              pagedkernel.paged_megakernel_step_plain,
              pallas_intersect.intersect_shade_pallas_plain, trace.pack_state_plain)
    counters = (gridkernel.grid_megakernel_step, megakernel.megakernel_step,
                pagedkernel.paged_megakernel_step,
                pallas_intersect.intersect_shade_pallas, trace.pack_state) + plains
    plain_names = [c.__name__ for c in plains]
    sort_events, gather_events, live = [], [], []
    orig_order, orig_gather = trace.live_order, trace.gather_lanes

    def timed(fn, events):  # CUDA events around each call
        def wrapped(*args):
            a_, b_ = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a_.record()
            out = fn(*args)
            b_.record()
            events.append((a_, b_))
            return out
        return wrapped

    def timed_order(key):
        perm = timed(orig_order, sort_events)(key)
        live.append(perm.numel())
        return perm

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

    def dense(mode):
        cfg = RenderConfig(samples=DENSE_SPP, width=DENSE_W, height=DENSE_H, mode=mode)
        for lst in (sort_events, gather_events, live):
            lst.clear()
        trace.live_order = timed_order
        trace.gather_lanes = timed(orig_gather, gather_events)
        try:
            t0 = time.perf_counter()
            img = raytrace_tpu_torch.render_image(cfg, scene=random_sphere_field(DENSE_N),
                                                  device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            trace.live_order, trace.gather_lanes = orig_order, orig_gather
        srt, gat = (sum(a_.elapsed_time(b_) for a_, b_ in ev) / 1e3
                    for ev in (sort_events, gather_events))
        n_rb = len(gather_events)
        return img, (f"re-bucket (sort {srt:.4f} s + gather {gat:.4f} s) in {n_rb} "
                     f"launches = {(srt + gat) / n_rb * 1e3:.3f} ms per launch, "
                     f"{(srt + gat) / wall:.2%} of the wall; live lanes at the first "
                     f"launch {live[0]}, at the last {live[-2]}")

    def pallas():
        img = raytrace_tpu_torch.ray_trace(samples=2, width=MAIN_W, height=MAIN_H,
                                           backend="pallas", device="cuda")
        return img, ""

    def matmul():  # BASELINE config 1
        cfg = RenderConfig(samples=1, width=480, height=270, max_depth=8, backend="matmul")
        return raytrace_tpu_torch.render_image(cfg, scene=three_sphere_scene(),
                                               device="cuda"), ""

    def synced(fn):
        """Seconds of ``fn()``, synchronised with the card."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def headline():
        """The JAX bench's operating point: a warm-up call (it runs the
        balance probe), the 10,000-spp render timed once, then the 1-spp
        frame loop as bench.py measures it."""
        cfg = RenderConfig(samples=HEAD_SPP, width=MAIN_W, height=MAIN_H, mode="fast",
                           balance_spp=HEAD_BALANCE_SPP, samples_per_call=HEAD_SPP_PER_CALL,
                           calls_per_exec=HEAD_CALLS_PER_EXEC)
        r = rmod.Renderer(cfg, device=dev)
        out = {}
        warm = synced(lambda: out.update(iters=r.render_call(4, return_iters=True)))
        _, tile_iters, lane_slots = out["iters"]
        if tile_iters <= 0 or lane_slots != tile_iters * trace.LANE_PAD:
            raise RuntimeError(f"return_iters: {tile_iters} tile iterations, {lane_slots} "
                               "lane slots")
        before = gridkernel.grid_megakernel_step.launches
        sec = synced(lambda: out.update(res=r.render()))
        n_launch = gridkernel.grid_megakernel_step.launches - before
        accum, total = out["res"]
        one, many = [], []
        for _ in range(4):  # the first of each warms up
            one.append(synced(lambda: r.render_call(1)))
            many.append(synced(lambda: r.render_call(1, n_calls=FRAME_LOOP_CALLS, spp_last=1)))
        t_one, t_many = sorted(one[1:])[1], sorted(many[1:])[1]
        loop_ms = (t_many - t_one) / (FRAME_LOOP_CALLS - 1) * 1e3
        stats = {y: {k: round(v, 4) if isinstance(v, float) else v for k, v in st.items()}
                 for y, st in r.balance_stats.items()}
        phase("headline", f"{MAIN_W}x{MAIN_H} x {HEAD_SPP} spp fast, M={r.pixels_per_lane}, "
              f"{HEAD_SPP_PER_CALL} spp per call, {HEAD_CALLS_PER_EXEC} calls per dispatch, "
              f"balance_spp={HEAD_BALANCE_SPP}: render {sec:.3f} s "
              f"({HEAD_SPP * MAIN_W * MAIN_H / sec:.4g} samples*px/s) in {n_launch} grid "
              f"launches; warm-up call with the probe {warm:.3f} s ({tile_iters} tile "
              f"iterations, {lane_slots} lane slots); balance {stats}; 1-spp "
              f"frame loop {loop_ms:.3f} ms per frame (one call {t_one * 1e3:.3f} ms, "
              f"{FRAME_LOOP_CALLS} merged {t_many * 1e3:.3f} ms)")
        return accum_to_u8(accum, total).cpu().numpy(), f"render {sec:.3f} s"

    runs = (("book scene exact", book, ("exact",), "grid", MAIN_SPP, MAIN_W, MAIN_H),
            ("book scene fast", book, ("fast",), "grid", MAIN_SPP, MAIN_W, MAIN_H),
            ("three-sphere scene exact", gridless, (), "mega", MAIN_SPP, MAIN_W, MAIN_H),
            (f"{DENSE_N}-sphere field exact", dense, ("exact",), "paged",
             DENSE_SPP, DENSE_W, DENSE_H),
            (f"{DENSE_N}-sphere field fast", dense, ("fast",), "paged",
             DENSE_SPP, DENSE_W, DENSE_H),
            ("book scene pallas backend", pallas, (), "pallas", 2, MAIN_W, MAIN_H),
            ("three-sphere scene matmul backend", matmul, (), "matmul", 1, 480, 270),
            ("book scene headline", headline, (), "grid", HEAD_SPP, MAIN_W, MAIN_H))
    step_of = {"grid": "grid_megakernel_step", "mega": "megakernel_step",
               "paged": "paged_megakernel_step", "pallas": "intersect_shade_pallas"}
    results = []
    for c in counters:
        c.launches = 0
    for label, fn, args, want, spp, w, h in runs:
        before = launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, extra = fn(*args)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        ran = {k: v - before[k] for k, v in launches().items()}
        results.append((label, sec, img, ran, dict(seen), extra, want, spp, w, h))
    main_counts = launches()
    rmod.Renderer.render = orig_render

    for label, sec, img, ran, got, extra, want, spp, w, h in results:
        finite = bool(torch.isfinite(got["accum"]).all())
        mean = float(img.mean())
        ran_nz = {k: v for k, v in ran.items() if v}
        phase("main", f"{label} {w}x{h} {spp} spp: {sec:.3f} s, "
              f"{spp * w * h / sec:.4g} samples*px/s, backend {got['backend']} "
              f"(M={got['m']}), launches {ran_nz}, finite {finite}, "
              f"u8 mean {mean:.2f} {extra}")
        if got["backend"] != want or (want in step_of and ran[step_of[want]] == 0):
            raise RuntimeError(f"{label}: the main path did not run the {want} backend")
        if not finite or img.shape != (h, w, 3) or not 20.0 < mean < 235.0:
            raise RuntimeError(f"{label}: implausible image")
    phase("main", f"launches over the main path {main_counts}")
    if any(main_counts[p] for p in plain_names):
        raise RuntimeError("a plain version ran on the main path")

    # ---- 6. bands and frames -------------------------------------------------
    # the grid and paged kernels against their plain versions on the state of
    # the first of the four bands, at the shapes the bands give them: the
    # book's 270-row band (M=1) and the 100k field's 540-row band (M=8)
    band_checks = (
        ("grid_megakernel_step", "grid", ds, MAIN_W, MAIN_H, MAIN_SPP, skip,
         gridkernel.grid_megakernel_step, gridkernel.grid_megakernel_step_plain,
         grid_call(), grid_tables, dict(compact=grid_live, strict=True)),
        ("paged_megakernel_step", "paged", dds, DENSE_W, DENSE_H, DENSE_SPP, dense_skip,
         pagedkernel.paged_megakernel_step, pagedkernel.paged_megakernel_step_plain,
         paged_call, [dds.paged.geom, dds.paged.lids, dds.paged.attrs, dds.paged.gtab, gs],
         dict(compact=paged_live, check=key_check)))
    for name, backend, dsc, w, h, spp, sk, kern, plain, call, tables, kw in band_checks:
        band_h = h // N_BANDS
        m_band, chunk = rmod.band_layout(RenderConfig(width=w, height=h), dev, backend,
                                         band_h)
        if chunk != band_h or m_band != lanes_m(backend, w, band_h):
            raise RuntimeError(f"{name}: a {band_h}-row band renders in chunks of {chunk} "
                               f"rows at M={m_band}, not the state checked here")
        _, b_err, b_ms, b_plain_ms, *_ = check_step(
            name, backend, dsc, w, band_h, spp, sk, kern, plain, call, tables,
            label=f" (first of {N_BANDS} bands of {w}x{h})", accum=True, full_h=h, **kw)
        records[name].update(max_abs_err=max(records[name]["max_abs_err"], b_err),
                             band_ms=b_ms, band_plain_ms=b_plain_ms)
    band_counts = bands_and_frames(dev, smi, launches, counters, plain_names)

    # ---- 7. runtime ops, autotune, C ABI, entry file --------------------------
    port_counts = port_runtime(dev, smi, kind, launches, counters, plain_names)
    for name in records:
        n = main_counts[name] + band_counts[name] + port_counts[name]
        if n == 0:
            raise RuntimeError(f"{name} did not launch on the main path")
        records[name]["launches"] = n

    # ---- 8. the gather probe and the card's gather floor ----------------------
    gather_probe(dev, smi, records, step_work)

    # ---- 9. the bench and the scripts its operating point rests on -----------
    t9 = time.perf_counter()
    bench_counts = bench_phase(dev, smi, kind, counters, plain_names)
    for name in records:  # "bench_gather.run" counts as "run"
        records[name]["launches"] += bench_counts[name.rsplit(".", 1)[-1]]
    phase("bench", f"phase 9 in {time.perf_counter() - t9:.1f} s, launches "
          f"{({k: v for k, v in bench_counts.items() if v})}")

    # ---- 10. the JAX system's remaining scripts ----------------------------
    t10 = time.perf_counter()
    script_counts = scripts_phase(smi, counters, plain_names)
    for name in records:
        records[name]["launches"] += script_counts.get(name, 0)
    for name in ("grid_megakernel_step", "megakernel_step", "paged_megakernel_step"):
        if script_counts[name] == 0:
            raise RuntimeError(f"{name} did not launch in phase 10")
    phase("scripts", f"phase 10 in {time.perf_counter() - t10:.1f} s, launches "
          f"{({k: v for k, v in script_counts.items() if v})}")

    # ---- 11. the section-cost probes ----------------------------------------
    t11 = time.perf_counter()
    probe_counts, by_variant = probes_phase(dev, smi, counters, plain_names, regs)
    for name in records:
        records[name]["launches"] += probe_counts.get(name, 0)
    for name, counts in by_variant.items():
        if not counts:
            raise RuntimeError(f"{name} launched no variant in phase 11")
        records[name]["variant_launches"] = counts
    phase("probes", f"phase 11 in {time.perf_counter() - t11:.1f} s, launches "
          f"{({k: v for k, v in probe_counts.items() if v})}")

    phase("done", f"every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
