"""Microbenchmark: a per-lane gather from on-chip memory, and its loop baseline.

Port of ``scripts/bench_gather.py``, whose two Pallas kernels (``run``,
body ``_kernel``; ``run_base``, body ``_kernel_base``) become the CUDA
kernels of ``csrc/bench_gather.cu``.  For a [R, T] = [16, 1024] f32 table
and [16, 1024] i32 indices, summed over ``iters`` iterations in order from 0:

- ``run(axis=1)``: out[r, t] = sum_i tab[r, (idx[r, t] + i) mod T], a
  per-lane gather (the grid kernels' use: one cell id per lane);
- ``run(axis=0)``: out[r, t] = sum_i tab[(idx[r, t] + i) mod T, t], a row
  gather.  At R = 16 most row indices are out of range, and an out-of-range
  row gives NaN, as JAX's ``take_along_axis`` does in its default fill mode
  (the TPU kernel in Pallas interpret mode gives NaN there and a numpy
  gather's bits elsewhere).  The JAX script's own numpy check raises
  ``IndexError`` on axis 0, and on the TPU axis 0 at R = 16 does not
  compile (a sublane gather takes at most 8 rows);
- ``run_base``: out = sum_i tab * 1.0000001f, the same loop with no gather,
  which isolates the loop's own cost (``idx`` is taken and not read).

``mod`` is floor modulo, as ``%`` is on JAX's ints, so a negative index
gives what JAX gives.  The TPU program had the whole chip; here each CUDA
block computes the whole problem into its own slice of a [blocks, R, T]
output, so one block measures one SM and one block per SM the card.  ``run``
and ``run_base`` launch the kernels for CUDA tensors and run the plain torch
versions ``run_plain`` and ``run_base_plain`` for CPU tensors; each counts
its launches in its ``launches`` attribute.

Run ``python -m raytrace_tpu_torch.scripts.bench_gather [--device cpu]
[--iters N] [--blocks B]``: on the GPU by default (it raises without one
unless given ``--device cpu``), it prints for each (axis, index mode)
whether the kernel equals its plain version at one iteration, the time per
[16, 1024] gather at one block and at ``--blocks`` (default: one per SM),
and then the baseline's time per iteration and each gather's ns per value
net of it, with the card's name and power limit beside every time.  On the
CPU the times are the plain versions' on the host clock.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import numpy as np
import torch

from ..ops import launches

T = 1024
R = 16
ITERS = 2048
BASE_SCALE = 1.0000001  # rounded to f32, as jnp.float32(1.0000001) is
REPS = 5  # timed launches (median) after one warm-up
INDEX_MODES = ("rand", "lane")


def inputs():
    """(tab [R, T] f32, {"rand": idx, "lane": idx} [R, T] i32), numpy, from
    ``default_rng(0)`` in the JAX script's order: random indices per entry,
    and one random index per lane broadcast over the rows."""
    rng = np.random.default_rng(0)
    tab = rng.standard_normal((R, T)).astype(np.float32)
    idx0 = rng.integers(0, T, size=(R, T)).astype(np.int32)
    idx_lane = np.broadcast_to(
        rng.integers(0, T, size=(1, T)).astype(np.int32), (R, T)).copy()
    return tab, {"rand": idx0, "lane": idx_lane}


def _check(tab, idx, iters, axis=1):
    if tab.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"tab {tab.dtype}, idx {idx.dtype}: want float32 and int32")
    if tuple(tab.shape) != (R, T) or tuple(idx.shape) != (R, T):
        raise ValueError(f"tab {tuple(tab.shape)}, idx {tuple(idx.shape)}: want [{R}, {T}]")
    if tab.device != idx.device:
        raise ValueError("tab and idx must be on one device")
    if int(iters) < 0 or int(axis) not in (0, 1):
        raise ValueError(f"iters {iters}, axis {axis}: want iters >= 0 and axis 0 or 1")
    return int(iters), int(axis)


def run(tab, idx, *, iters, axis, blocks=None, per_block=False):
    """The gather probe: [R, T] (or, with ``per_block``, every block's
    [blocks, R, T]; the CPU repeats its one result ``blocks`` times, default
    1).  CUDA tensors launch the kernel over ``blocks`` blocks (default: one
    per SM); CPU tensors run the plain version."""
    iters, axis = _check(tab, idx, iters, axis)
    if tab.device.type == "cpu":
        out = run_plain(tab, idx, iters=iters, axis=axis)
        return out.expand(blocks or 1, R, T) if per_block else out
    out = _out(tab, blocks)
    from .. import _build

    tab, idx = tab.contiguous(), idx.contiguous()
    err = _build.library().rt_gather_bench(
        tab.data_ptr(), idx.data_ptr(), out.data_ptr(), iters, axis, out.shape[0],
        tab.device.index, torch.cuda.current_stream(tab.device).cuda_stream)
    if err:
        raise RuntimeError(f"gather kernel launch failed: {_build.error_string(err)}")
    launches.count(run)
    return out if per_block else out[0]


run.launches = 0


def run_base(tab, idx, *, iters, blocks=None, per_block=False):
    """The loop baseline, as ``run`` (``idx`` is checked and not read)."""
    iters, _ = _check(tab, idx, iters)
    if tab.device.type == "cpu":
        out = run_base_plain(tab, idx, iters=iters)
        return out.expand(blocks or 1, R, T) if per_block else out
    out = _out(tab, blocks)
    from .. import _build

    tab = tab.contiguous()
    err = _build.library().rt_gather_base(
        tab.data_ptr(), out.data_ptr(), iters, out.shape[0], tab.device.index,
        torch.cuda.current_stream(tab.device).cuda_stream)
    if err:
        raise RuntimeError(f"gather baseline launch failed: {_build.error_string(err)}")
    launches.count(run_base)
    return out if per_block else out[0]


run_base.launches = 0


def _out(tab, blocks):
    """A fresh [blocks, R, T] output on ``tab``'s CUDA device (``blocks``
    default: one per SM)."""
    if tab.device.type != "cuda":
        raise ValueError(f"unsupported device {tab.device}")
    if blocks is None:
        blocks = torch.cuda.get_device_properties(tab.device).multi_processor_count
    if int(blocks) < 1:
        raise ValueError(f"blocks {blocks}: want >= 1")
    return torch.empty((int(blocks), R, T), dtype=torch.float32, device=tab.device)


def run_plain(tab, idx, *, iters, axis):
    """The plain torch version of ``run``: the JAX loop, one ``gather`` an
    iteration on the clamped index, NaN where the index is out of range."""
    launches.count(run_plain)
    iters, axis = _check(tab, idx, iters, axis)
    size = tab.shape[axis]
    nan = torch.full((), float("nan"), dtype=torch.float32, device=tab.device)
    acc = torch.zeros((R, T), dtype=torch.float32, device=tab.device)
    for i in range(iters):
        j = torch.remainder(idx + i, T)  # floor modulo of the int32 sum
        g = torch.gather(tab, axis, j.clamp(max=size - 1).long())
        acc = acc + torch.where(j < size, g, nan)
    return acc


run_plain.launches = 0


def run_base_plain(tab, idx, *, iters):
    """The plain torch version of ``run_base``."""
    launches.count(run_base_plain)
    iters, _ = _check(tab, idx, iters)
    scale = torch.tensor(BASE_SCALE, dtype=torch.float32, device=tab.device)
    acc = torch.zeros((R, T), dtype=torch.float32, device=tab.device)
    for _ in range(iters):
        acc = acc + tab * scale
    return acc


run_base_plain.launches = 0


def card_label(device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or what
    ran the CPU numbers."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu: the plain torch versions, host clock"
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        res = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        res = None
    if res is not None and res.returncode == 0 and res.stdout.strip():
        return res.stdout.strip().splitlines()[0]
    return f"{torch.cuda.get_device_name(device)}, power limit not read"


def time_ms(fn, device, reps=REPS) -> float:
    """Median time of ``fn()`` over ``reps`` calls after one warm-up call, in
    ms: CUDA events on the device's current stream, else the host clock."""
    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            stream = torch.cuda.current_stream(device)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record(stream)
            fn()
            b.record(stream)
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main(argv=None) -> dict:
    """Run the probe (see the module docstring); returns what it printed as
    a dict: ``card``, ``iters``, ``blocks``, ``gather`` {"axis=A idx=M":
    {"correct", "ms": {blocks: ms per launch}}}, ``base_ms`` {blocks: ms}."""
    from ..runtime.renderer import render_device

    ap = argparse.ArgumentParser(prog="python -m raytrace_tpu_torch.scripts.bench_gather",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--iters", type=int, default=ITERS, help=f"timed iterations ({ITERS})")
    ap.add_argument("--blocks", type=int, default=None,
                    help="blocks of the whole-card run (default: one per SM)")
    args = ap.parse_args(argv)
    if args.iters < 1 or (args.blocks is not None and args.blocks < 1):
        ap.error("--iters and --blocks must be >= 1")
    dev = render_device(args.device)
    card = card_label(dev)
    if dev.type == "cuda":
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        blocks = sorted({1, args.blocks or sms})
    else:
        blocks = [1]
    tab_np, idx_np = inputs()
    tab = torch.from_numpy(tab_np).to(dev)
    per_value = args.iters * R * T
    print(f"bench_gather: {dev}, [{R},{T}] f32 table, {args.iters} iterations, blocks "
          f"{blocks} ({card})", flush=True)
    res = dict(card=card, iters=args.iters, blocks=blocks, gather={}, base_ms={})
    for axis in (1, 0):
        for name in INDEX_MODES:
            idx = torch.from_numpy(idx_np[name]).to(dev)
            got = run(tab, idx, iters=1, axis=axis, blocks=blocks[-1], per_block=True)
            want = run_plain(tab, idx, iters=1, axis=axis)
            ok = bool(((got == want) | (got.isnan() & want.isnan())).all())
            ms = {b: time_ms(lambda: run(tab, idx, iters=args.iters, axis=axis, blocks=b), dev)
                  for b in blocks}
            key = f"axis={axis} idx={name}"
            res["gather"][key] = dict(correct=ok, ms=ms)
            ns = ms[1] * 1e6 / args.iters
            whole = "; ".join(
                f"{b} blocks: {ms[b] * 1e6 / args.iters:.1f} ns per gather per block, "
                f"{ms[b] * 1e6 / (per_value * b):.6f} ns per value over the card"
                for b in blocks if b > 1)
            print(f"{key}: correct={ok}; 1 block: {ns:.1f} ns per [{R},{T}] gather "
                  f"({ns / R:.2f} ns/row, {ns / (R * T) * 1024:.3f} ns/lane/16rows)"
                  f"{'; ' + whole if whole else ''} ({card})", flush=True)
    idx = torch.from_numpy(idx_np["rand"]).to(dev)
    res["base_ms"] = {b: time_ms(lambda: run_base(tab, idx, iters=args.iters, blocks=b), dev)
                      for b in blocks}
    b = blocks[-1]
    net = ", ".join(
        f"{k} {(g['ms'][b] - res['base_ms'][b]) * 1e6 / (per_value * b):.6f}"
        for k, g in res["gather"].items())
    print("baseline add loop: " + "; ".join(
        f"{bb} block{'s' if bb > 1 else ''} {res['base_ms'][bb] * 1e6 / args.iters:.1f} ns "
        f"per iter" for bb in blocks)
          + f"; gather net of the baseline at {b} block{'s' if b > 1 else ''}, ns per value: "
          f"{net} ({card})", flush=True)
    return res


if __name__ == "__main__":
    main()
