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
gives what JAX gives.  On axis 1 the kernel has two paths, chosen per warp
on the card: a warp whose lanes each have one index for all R rows reads
each lane's record (the column tab[:, j]) from a record-major copy placed
by ``record_slot``, four 128-bit loads an iteration in the order of
``record_quad``; any other warp reads one word per row from the row-major
copy.  ``shared_wavefronts`` counts the shared-memory wavefronts that the
kernel's loads need for given indices, the least time the probe can take
on an SM; ``CHECK_MODES`` and ``check_inputs`` are the index cases that
hold the kernel against its plain version (the script's two, and
wrapping, broadcast-wrapping, mixed-path and row-path per-lane indices).
The TPU program had the whole chip; here each CUDA block computes the
whole problem into its own slice of a [blocks, R, T] output, so one block
measures one SM and one block per SM the card.  ``run`` and ``run_base``
launch the kernels for CUDA tensors and run the plain torch versions
``run_plain`` and ``run_base_plain`` for CPU tensors; each counts its
launches in its ``launches`` attribute.

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
import re
import statistics
import subprocess
import time
from collections import Counter

import numpy as np
import torch

from ..ops import launches

T = 1024
R = 16
ITERS = 2048
BASE_SCALE = 1.0000001  # rounded to f32, as jnp.float32(1.0000001) is
REPS = 5  # timed launches (median) after one warm-up
INDEX_MODES = ("rand", "lane")
CHECK_MODES = INDEX_MODES + ("wide", "wide-lane", "mixed", "lane-row")
WARP = 32
QUADS = R // 4  # 16-byte slots of one record (rows 4q .. 4q + 3)
LAYOUTS = ("row", "record", "swizzled", "paired")
_COUNT_CHUNK = 128  # iterations counted at once (bounds the counter's memory)


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


def _wrapping(rng, shape):
    """int32 indices over the whole range, every seventh column near the top
    so that ``idx + i`` wraps."""
    w = rng.integers(-2**31, 2**31, size=shape, dtype=np.int64).astype(np.int32)
    w[:, ::7] = np.iinfo(np.int32).max - rng.integers(0, 5, size=(shape[0], len(range(0, T, 7))))
    return w


def check_inputs(mode):
    """(tab, idx) in numpy for one of ``CHECK_MODES``: the script's "rand" and
    "lane"; "wide", wrapping indices per entry; "wide-lane", wrapping
    indices per lane broadcast over the rows; "mixed", the per-lane indices
    in even warps and the random ones in odd warps, except that lane 5 of
    warp 2 differs from its other rows in row 9, so that its warp takes the
    row path; "lane-row", the per-lane indices with lane 0 of every warp
    one more in row 15, so that every warp takes the row path."""
    tab, idx = inputs()
    if mode in INDEX_MODES:
        return tab, idx[mode]
    if mode == "wide":
        return tab, _wrapping(np.random.default_rng(5), (R, T))
    if mode == "wide-lane":
        return tab, np.broadcast_to(_wrapping(np.random.default_rng(6), (1, T)), (R, T)).copy()
    if mode == "mixed":
        odd = (np.arange(T) // WARP) % 2 == 1
        mixed = np.where(odd, idx["rand"], idx["lane"])
        mixed[9, 2 * WARP + 5] = (mixed[9, 2 * WARP + 5] + 1) % T
        return tab, mixed
    if mode == "lane-row":
        lane_row = idx["lane"].copy()
        lane_row[R - 1, ::WARP] = (lane_row[R - 1, ::WARP] + 1) % T
        return tab, lane_row
    raise ValueError(f"index mode {mode!r}: want one of {CHECK_MODES}")


def record_slot(j, q, lane):
    """The 16-byte slot of quad ``q`` (rows 4q .. 4q + 3) of record ``j``
    (the column tab[:, j]) that lane ``lane`` reads in the kernel's
    record-major copy; ints or numpy arrays.  Record j fills the 128-byte
    line j twice, once in each half (copy 0 in slots 0-3, copy 1 in slots
    4-7, quad q in slot q of its half), and a lane reads copy
    (lane >> 2) & 1: lanes 0-3 of a quarter-warp read the bank quads 0-3,
    lanes 4-7 the bank quads 4-7.  ``record_slot`` in
    ``csrc/bench_gather.cu`` mirrors it."""
    return 8 * np.asarray(j) + 4 * ((np.asarray(lane) >> 2) & 1) + q


def record_quad(k, lane):
    """The quad that lane ``lane`` loads at step ``k`` (0 .. 3) of an
    iteration: (k + lane) & 3, so that lanes 0-3 of a quarter-warp, which
    read one half of their lines, load four different quads, one bank quad
    each, whatever their records.  ``record_quad`` in
    ``csrc/bench_gather.cu`` mirrors it."""
    return (k + np.asarray(lane)) & 3


def _xor_slot(j, q):
    """A record-major layout with one copy, for ``shared_wavefronts``'s
    "swizzled" layout: two records a 128-byte line, the slot within the
    line, (j & 1) * 4 + q, XORed with the line's low three bits."""
    j = np.asarray(j)
    line = j >> 1
    return line * 8 + ((((j & 1) << 2) | q) ^ (line & 7))


def _busiest(addr, banks):
    """The most distinct addresses on one bank, for each group of lanes on
    the last axis of ``addr`` (a bank is ``addr % banks``)."""
    a = np.sort(addr.reshape(-1, addr.shape[-1]), axis=1)
    first = np.ones(a.shape, bool)
    first[:, 1:] = a[:, 1:] != a[:, :-1]
    key = np.arange(a.shape[0])[:, None] * banks + a % banks
    per_bank = np.bincount(key[first], minlength=a.shape[0] * banks)
    return per_bank.reshape(-1, banks).max(axis=1).reshape(addr.shape[:-1])


def warp_wavefronts(addr, width=1):
    """(warp rule, quarter rule) wavefronts of warp loads: ``addr`` [..., 32]
    holds each lane's address, in 4-byte words (``width`` 1, a 32-bit load)
    or in 16-byte slots (``width`` 4, a 128-bit load); one count per load.
    A load takes as many wavefronts as its busiest bank (32 of 4 bytes) has
    distinct words.  A 32-bit load counts the same under both rules; a
    128-bit load takes at least 4 over the warp ("warp"), or the count for
    each quarter-warp of 8 lanes, summed ("quarter")."""
    addr = np.asarray(addr)
    if width == 1:
        n = _busiest(addr, WARP)
        return n, n
    if width != 4:
        raise ValueError(f"width {width}: want 1 (32-bit loads) or 4 (128-bit loads)")
    quarters = _busiest(addr.reshape(*addr.shape[:-1], 4, WARP // 4), 8)
    return np.maximum(4, _busiest(addr, 8)), quarters.sum(axis=-1)


def record_warps(idx):
    """[T // WARP] bool: the warps whose lanes each have one index for all
    R rows, which take the record path on axis 1."""
    idx = np.asarray(idx)
    return (idx == idx[:1]).all(axis=0).reshape(-1, WARP).all(axis=1)


def shared_wavefronts(idx, axis=1, layout="paired"):
    """Shared-memory wavefronts per iteration per SM that the gather kernel's
    loads need for the [R, T] indices ``idx`` (one block of T threads),
    averaged over the T iterations of one period of (idx + i) mod T, by the
    two rules of ``warp_wavefronts``.  ``layout`` says what the warps of
    axis 1 that take the record path (``record_warps``) read, four 128-bit
    loads a lane an iteration: "paired", the kernel's copy (``record_slot``
    in the order of ``record_quad``); "swizzled", one copy, quad q at step q
    in ``_xor_slot``; "record", one copy unswizzled, quad q of record j in
    slot 4j + q at step q; "row", the row path as every other warp (one
    32-bit load per row).  Axis 0 loads word (min(j, R), t) of the row copy
    for every value, row R being the NaN row.

    Returns {"warp", "quarter": wavefronts; "record_warps": warps on the
    record path}."""
    if layout not in LAYOUTS or axis not in (0, 1):
        raise ValueError(f"layout {layout!r}, axis {axis}: want one of {LAYOUTS}, axis 0 or 1")
    idx = np.asarray(idx).astype(np.int64)
    warps = T // WARP
    rec = record_warps(idx) if axis == 1 and layout != "row" else np.zeros(warps, bool)
    total = {"warp": 0, "quarter": 0}
    for i0 in range(0, T, _COUNT_CHUNK):
        i = np.arange(i0, min(i0 + _COUNT_CHUNK, T))
        j = (idx[None] + i[:, None, None]) & (T - 1)  # [iterations, R, T]
        if axis == 1:
            words = np.arange(R)[None, :, None] * T + j
        else:
            words = np.minimum(j, R) * T + np.arange(T)
        loads = [(words.reshape(len(i), R, warps, WARP)[:, :, ~rec], 1)]
        if rec.any():
            jr = j[:, 0].reshape(len(i), warps, WARP)[:, rec]
            lane = np.arange(WARP)
            slot = {"paired": lambda k: record_slot(jr, record_quad(k, lane), lane),
                    "swizzled": lambda k: _xor_slot(jr, k),
                    "record": lambda k: 4 * jr + k}[layout]
            loads += [(slot(k), 4) for k in range(QUADS)]
        for addr, width in loads:
            w, qw = warp_wavefronts(addr, width)
            total["warp"] += int(w.sum())
            total["quarter"] += int(qw.sum())
    return dict(warp=total["warp"] / T, quarter=total["quarter"] / T,
                record_warps=int(rec.sum()))


_SASS_FUNCTION = re.compile(r"Function\s*:\s*(\S+)")
_SASS_LABEL = re.compile(r"^\s*(\.L_x_\w+):")
_SASS_INSTR = re.compile(  # /*addr*/ [@predicate] OPCODE args ;
    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def sass_loops(sass, kernel="gather_bench_kernel"):
    """The loops of the functions whose name holds ``kernel`` in the text of
    ``cuobjdump -sass``: {function: [{"instructions": n, "ops": {opcode:
    count}}, ...]}, one entry per backward branch, its body from the
    branch's target to the branch (both in)."""
    funcs, name = {}, None
    for line in sass.splitlines():
        f = _SASS_FUNCTION.search(line)
        if f:
            name = f.group(1)
            funcs[name] = ([], {})
            continue
        if name is None:
            continue
        lab = _SASS_LABEL.match(line)
        if lab:
            funcs[name][1][lab.group(1)] = len(funcs[name][0])
            continue
        ins = _SASS_INSTR.search(line)
        if ins:
            funcs[name][0].append((int(ins.group(1), 16), ins.group(2), ins.group(3)))
    out = {}
    for fn, (body, labels) in funcs.items():
        if kernel not in fn:
            continue
        loops, at = [], {addr: k for k, (addr, _, _) in enumerate(body)}
        for k, (addr, op, args) in enumerate(body):
            if not op.startswith("BRA"):
                continue
            lab = re.search(r"\.L_x_\w+", args)
            hexa = re.search(r"0x([0-9a-f]+)", args)
            if lab:
                start = labels.get(lab.group(0))
            else:
                start = at.get(int(hexa.group(1), 16)) if hexa else None
            if start is None or start > k:
                continue
            ops = dict(Counter(o for _, o, _ in body[start:k + 1]))
            loops.append(dict(instructions=k + 1 - start, ops=ops))
        out[fn] = loops
    return out


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


def ns_per_value(ms, iters, blocks) -> float:
    """ns per gathered value over the card of a launch of ``blocks`` blocks
    at ``iters`` iterations that took ``ms``."""
    return ms * 1e6 / (iters * R * T * blocks)


def card_ns_per_value(device, mode="lane", iters=ITERS) -> float:
    """The card's gather rate: ns per value of the axis-1 probe on
    ``inputs()``'s ``mode`` indices at one block per SM (``time_ms``)."""
    device = torch.device(device)
    blocks = torch.cuda.get_device_properties(device).multi_processor_count
    tab_np, idx_np = inputs()
    tab = torch.from_numpy(tab_np).to(device)
    idx = torch.from_numpy(idx_np[mode]).to(device)
    ms = time_ms(lambda: run(tab, idx, iters=iters, axis=1, blocks=blocks), device)
    return ns_per_value(ms, iters, blocks)


def gather_floor_frac(table_values, ns_value, launch_ms) -> float:
    """The share of a wavefront launch that its table loads take at the
    card's gather rate: ``table_values`` (the plain version's tally, a lower
    count of the kernel's reads) x ``ns_value`` ns per value / the launch's
    ``launch_ms``."""
    return table_values * ns_value / (launch_ms * 1e6)


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
                f"{ns_per_value(ms[b], args.iters, b):.6f} ns per value over the card"
                for b in blocks if b > 1)
            print(f"{key}: correct={ok}; 1 block: {ns:.1f} ns per [{R},{T}] gather "
                  f"({ns / R:.2f} ns/row, {ns / (R * T) * 1024:.3f} ns/lane/16rows)"
                  f"{'; ' + whole if whole else ''} ({card})", flush=True)
    idx = torch.from_numpy(idx_np["rand"]).to(dev)
    res["base_ms"] = {b: time_ms(lambda: run_base(tab, idx, iters=args.iters, blocks=b), dev)
                      for b in blocks}
    b = blocks[-1]
    net = ", ".join(
        f"{k} {ns_per_value(g['ms'][b] - res['base_ms'][b], args.iters, b):.6f}"
        for k, g in res["gather"].items())
    print("baseline add loop: " + "; ".join(
        f"{bb} block{'s' if bb > 1 else ''} {res['base_ms'][bb] * 1e6 / args.iters:.1f} ns "
        f"per iter" for bb in blocks)
          + f"; gather net of the baseline at {b} block{'s' if b > 1 else ''}, ns per value: "
          f"{net} ({card})", flush=True)
    return res


if __name__ == "__main__":
    main()
