"""What the three section-cost probes share (``grid_ablate``,
``grid_iterbench``, ``paged_iterbench``): the arguments, building every
variant's library at once before anything is timed, each variant's
registers, frame and spills (ptxas) and SASS instruction count, the timed
rounds in turns, and the JAX scripts' median lines.

A variant is a switch set of ``ops.gridkernel.SWITCHES`` or
``ops.pagedkernel.SWITCHES`` (``"base"``: none beyond the script's own);
on the card each is a library of its own (``_build.build_many``).  On the
CPU nothing is built and the compiled figures read "not measured"."""

from __future__ import annotations

import argparse
import statistics
import time


def parse(prog, doc, argv, modes=False):
    """(device, card label, args) of a probe's command line: ``--device``
    (cuda by default; it raises without a card) and, with ``modes``,
    ``--mode exact|fast``."""
    from ..runtime.renderer import render_device
    from .bench_gather import card_label

    ap = argparse.ArgumentParser(prog=f"python -m raytrace_tpu_torch.scripts.{prog}",
                                 description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    if modes:
        ap.add_argument("--mode", default="exact", choices=("exact", "fast"))
    args = ap.parse_args(argv)
    device = render_device(args.device)
    return device, card_label(device), args


def variant_sets(variants, always=()) -> dict:
    """{variant: its switch tuple}: ``always`` plus the variant's switches
    ("base": none; "a+b": both)."""
    return {v: tuple(always) + (() if v == "base" else tuple(v.split("+")))
            for v in variants}


def grid_instance(five, n_slots) -> str:
    """The mangled-name part of the grid kernel's template instance for a
    table layout (csrc/gridkernel.cu pick_layout; iterstats off)."""
    ns = 0 if five or n_slots != 4 else 4
    return f"ILb{int(five)}ELi{ns}ELb0E"


def paged_instance(five, textured) -> str:
    """The mangled-name part of the paged kernel's template instance."""
    return f"ILb{int(five)}ELb{int(textured)}E"


def compiled(device, kernel, masks, instance) -> dict:
    """{mask: {"registers", "frame", "spill_stores", "sass"}} of the
    kernel's instance in each variant library, every missing library built
    at once ("grid" or "paged" masks); {} on the CPU."""
    if device.type != "cuda":
        return {}
    from .. import _build

    from concurrent.futures import ThreadPoolExecutor

    keys = [(None, m, 0) if kernel == "grid" else (None, 0, m) for m in masks]
    infos = _build.build_many(keys)
    with ThreadPoolExecutor(8) as ex:  # one cuobjdump per library, 8 at a time
        dumps = list(ex.map(lambda info: _build.sass(info["lib"]), infos))
    out = {}
    for mask, info, dump in zip(masks, infos, dumps):
        regs = [r for name, r in _build.ptxas_report(
            info["log"], f"{kernel}_megakernel_step_kernel").items() if instance in name]
        sass = [ins for name, ins in dump.items()
                if f"{kernel}_megakernel_step_kernel" in name and instance in name]
        if len(regs) != 1 or len(sass) != 1:
            raise RuntimeError(f"{kernel} variant {mask}: no single instance {instance} "
                               f"in its library ({len(regs)} ptxas, {len(sass)} SASS)")
        out[mask] = dict(regs[0], sass=len(sass[0]))
    return out


def compiled_text(rep, base=None) -> str:
    """A variant's registers, frame, spills and SASS count (with its delta
    from ``base``'s), or "not measured" on the CPU."""
    if not rep:
        return "registers, spills, SASS: not measured (CPU)"
    delta = "" if base is None else f" ({rep['sass'] - base['sass']:+d})"
    return (f"{rep['registers']} registers, {rep['frame']} B frame, "
            f"{rep['spill_stores']} B spilled, {rep['sass']} SASS instructions{delta}")


def rounds_in_turns(run, variants, rounds, device):
    """Time ``run(v)`` for every variant in turns, ``rounds`` times: host
    clock to the end of the device's work.  Prints the JAX scripts' round
    lines; returns {v: [seconds]}."""
    import torch

    times = {v: [] for v in variants}
    for rnd in range(rounds):
        for v in variants:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            run(v)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            times[v].append(time.perf_counter() - t0)
        print(f"round {rnd}: " + " ".join(f"{v}={times[v][-1]:.3f}" for v in variants),
              flush=True)
    return times


def launch_rounds(step, f0, u0, acc, sets, rounds, invokes, device):
    """Time each variant's ``invokes`` launches in a host loop, each
    launch's state the last one's output (``step(f, u, acc, switches)`` ->
    (f, u)), from (f0, u0) and a copy of ``acc``, after two warm-up
    launches, in turns over ``rounds``.  Returns ({v: [round seconds]},
    {v: the spread of its launches (CUDA events), or "not measured"})."""
    import torch

    launch_ms = {v: [] for v in sets}

    def run(v, count=invokes):
        fs, us, a = f0, u0, acc.clone()
        events = []
        for _ in range(count):
            if device.type == "cuda":
                e = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                e[0].record()
            fs, us = step(fs, us, a, sets[v])
            if device.type == "cuda":
                e[1].record()
                events.append(e)
        if events:
            torch.cuda.synchronize(device)
            launch_ms[v] += [a_.elapsed_time(b_) for a_, b_ in events]

    for v in sets:
        run(v, 2)
        launch_ms[v].clear()
        print(f"{v}: warm", flush=True)
    times = rounds_in_turns(run, list(sets), rounds, device)
    spread = {}
    for v, t in launch_ms.items():
        t = sorted(t)
        spread[v] = ("launches: not measured (CPU)" if not t else
                     f"a launch {statistics.median(t):.4f} ms (min {t[0]:.4f}, p90 "
                     f"{t[int(0.9 * (len(t) - 1))]:.4f}, max {t[-1]:.4f})")
    return times, spread


def medians(times, reps, card, unit_line) -> dict:
    """Print the base median (``unit_line(base seconds)`` beside it) and
    each variant's median, delta and the spread of its rounds, each with
    its compiled figures from ``reps`` {v: text}; returns {v: median}."""
    med = {v: statistics.median(t) for v, t in times.items()}
    base = med["base"]
    print(f"\nbase median: {base:.4f}s ({unit_line(base)}) rounds {min(times['base']):.4f}-"
          f"{max(times['base']):.4f}s; {reps['base']} ({card})")
    for v, m in med.items():
        if v == "base":
            continue
        print(f"{v:<12} median {m:.4f}s  delta {m - base:+.4f}s ({100 * (m - base) / base:+.1f}%)"
              f" rounds {min(times[v]):.4f}-{max(times[v]):.4f}s; {reps[v]} ({card})",
              flush=True)
    return med
