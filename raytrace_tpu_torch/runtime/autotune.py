"""Startup micro-autotune of the grid kernel's knobs.

Port of ``raytrace_tpu/runtime/autotune.py``.  ``runtime/chips.py`` holds
the operating point measured on one card; this module measures it on the
live one: it sweeps (pixels_per_lane M, j_steps J, K_STEPS) around the
renderer's M and the profile's J and K, warms every candidate first, then
times them in interleaved rounds and takes medians, picks the fastest and
caches it per device kind and mode.  ``sweep_block`` does the same for the
grid kernel's threads per block, a compile-time define, one persistent
worker process per candidate.

The image is bit-identical for every (M, J, K) and block: the sweep hashes
every candidate's accumulator and raises (block: refuses the candidate)
when one differs, so applying a tuned point never changes a pixel.

Opt-in only: nothing reads the (M, J, K) cache unless the caller asks
(``python -m raytrace_tpu_torch --autotune`` or ``apply_tuned()``).  The
block is read at a process's first kernel build (``_build.grid_block``).
The cache is the port's own file, ``~/.cache/raytrace_tpu_torch_autotune.json``
(``RAYTRACE_TORCH_AUTOTUNE_CACHE`` overrides it), never the JAX package's.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import torch

CACHE_PATH = Path(
    os.environ.get("RAYTRACE_TORCH_AUTOTUNE_CACHE",
                   str(Path.home() / ".cache" / "raytrace_tpu_torch_autotune.json")))


def device_kind(device="cuda") -> str:
    """The card's name (``torch.cuda.get_device_name``), or "cpu" when the
    caller asks for the CPU; raises for "cuda" without a CUDA device."""
    from .renderer import render_device

    dev = render_device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _rr_for(mode: str):
    """RR triple for ``mode`` ("exact" -> None, "fast" -> config defaults).
    The sweep runs under the mode the production render will use: RR
    changes the iteration mix, so the cache keeps the modes apart."""
    if mode == "fast":
        from .. import config as _cfg

        return (_cfg.RR_START_DEPTH, _cfg.RR_CAP_DEPTH, _cfg.RR_PMIN)
    return None


def _cache_key(device_kind: str, mode: str) -> str:
    return device_kind if mode == "exact" else f"{device_kind}|{mode}"


def default_candidates(seed_m: int = 2, seed_j: int = 2, seed_k: int = 40) -> list:
    """Cross pattern around the seed: one axis varied at a time, the seed
    first."""
    cands = [
        (seed_m, seed_j, seed_k),
        (max(1, seed_m // 2), seed_j, seed_k),
        (min(128, seed_m * 2), seed_j, seed_k),
        (seed_m, max(1, seed_j - 1), seed_k),
        (seed_m, seed_j + 1, seed_k),
        (seed_m, seed_j, max(5, seed_k // 4)),
    ]
    out = []
    for c in cands:  # dedup, preserve order (center first)
        if c not in out:
            out.append(c)
    return out


def accum_hash(acc: torch.Tensor) -> str:
    """A hash of an accumulator's bits."""
    return hashlib.sha256(acc.detach().cpu().contiguous().numpy().tobytes()).hexdigest()[:16]


class _BookBand:
    """The book scene's whole image as one grid band on ``device``: ``run(m,
    j, k)`` renders it with the grid kernel's J and K set for the call only
    and returns the accumulator, synchronised with the device."""

    def __init__(self, width, height, spp, mode, max_depth, device, scene_time=0.0):
        from ..models.scene import generate_random_scene
        from ..ops.trace import (device_scene_from_numpy, prepare_scene,
                                 tmax_never_binds, viewport_arrays)
        from .renderer import reference_camera

        self.device = device
        scene = generate_random_scene(scene_time)
        self.ds = device_scene_from_numpy(prepare_scene(scene), device)
        if self.ds.grid is None:
            raise RuntimeError("autotune sweeps the grid backend; the book scene "
                               "must build a flat grid")
        cam = reference_camera()
        self.kw = dict(vp=viewport_arrays(cam, width, height), band_h=height, width=width,
                       y0=0, seed_y0=0, offset_x=0, spp=spp, number=0,
                       max_depth=max_depth, backend="grid",
                       skip_tmax=tmax_never_binds(scene, cam), rr=_rr_for(mode))

    def run(self, m, j, k):
        from ..ops import gridkernel as gk
        from ..ops.trace import render_band

        j0, k0 = gk.J_STEPS, gk.K_STEPS
        gk.J_STEPS, gk.K_STEPS = int(j), int(k)
        try:
            acc = render_band(self.ds, pixels_per_lane=int(m), **self.kw)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        finally:
            gk.J_STEPS, gk.K_STEPS = j0, k0
        return acc


def _seed_m(width, height, device):
    from ..config import RenderConfig
    from .renderer import band_layout

    return band_layout(RenderConfig(width=width, height=height), device, "grid", height)[0]


def autotune(width: int = 1920, height: int = 1080, spp: int = 200,
             rounds: int = 3, candidates: Optional[list] = None,
             scene_time: float = 0.0, save: bool = True,
             verbose: bool = True, mode: str = "exact", max_depth: int = 50,
             device="cuda") -> dict:
    """Measure the (M, J, K) candidates on ``device``; return and cache the
    winner.  Default candidates: ``default_candidates`` around the
    renderer's M at (width, height) and the card profile's J and K.
    Returns {"m", "j", "k", "ns_per_sample", "device_kind", "mode", "width",
    "height", "spp", "candidates": {"MxJxK": ns per sample}, "acc_hash"};
    raises if two candidates' accumulators differ."""
    from .chips import profile_for
    from .renderer import render_device

    dev = render_device(device)
    kind = device_kind(dev)
    prof = profile_for(kind)
    if candidates is None:
        candidates = default_candidates(_seed_m(width, height, dev), prof.j_steps,
                                        prof.k_steps)
    candidates = [tuple(int(x) for x in c) for c in candidates]
    band = _BookBand(width, height, spp, mode, max_depth, dev, scene_time)

    hashes = {}
    for c in candidates:  # warm every candidate before any timing
        t0 = time.perf_counter()
        hashes[c] = accum_hash(band.run(*c))
        if verbose:
            print(f"autotune: warm M={c[0]} j={c[1]} K={c[2]} "
                  f"({time.perf_counter() - t0:.1f}s) bits {hashes[c]}", flush=True)
    if len(set(hashes.values())) != 1:
        raise RuntimeError(f"autotune: the candidates' images differ: {hashes}")

    times = {c: [] for c in candidates}
    for _ in range(rounds):
        for c in candidates:
            t0 = time.perf_counter()
            band.run(*c)
            times[c].append(time.perf_counter() - t0)

    medians = {c: statistics.median(ts) for c, ts in times.items()}
    best = min(candidates, key=lambda c: medians[c])
    samples = width * height * spp
    result = {
        "m": best[0], "j": best[1], "k": best[2],
        "ns_per_sample": round(medians[best] / samples * 1e9, 3),
        "device_kind": kind, "mode": mode,
        "width": width, "height": height, "spp": spp,
        "candidates": {f"{c[0]}x{c[1]}x{c[2]}": round(medians[c] / samples * 1e9, 3)
                       for c in candidates},
        "acc_hash": hashes[best],
    }
    if verbose:
        for c in candidates:
            mark = " <- best" if c == best else ""
            print(f"autotune: M={c[0]} j={c[1]} K={c[2]} "
                  f"{medians[c] / samples * 1e9:.3f} ns/sample{mark}", flush=True)
    if save:
        save_tuned(result)
    return result


def _worker_main() -> int:
    """Persistent block-sweep worker (one per block candidate, spawned by
    ``sweep_block`` with ``RAYTRACE_TORCH_GRID_BLOCK`` set).  The block is
    compile-time, so each candidate needs its own process, and the
    interleaved rounds need all of them timeable in turn, hence persistent
    children driven over stdin/stdout:

        warm W H SPP M J K MODE DEVICE -> renders once, prints
            READY <block> <accumulator hash> <local bytes> <resident blocks
            per SM> (the book instance of the grid kernel)
        go    -> one timed render, prints T <seconds>
        quit  -> exits
    """
    from .. import _build
    from ..ops import gridkernel

    band = params = None
    for line in sys.stdin:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "warm":
            w, h, spp, m, j, k = (int(x) for x in parts[1:7])
            dev = torch.device(parts[8])
            band = _BookBand(w, h, spp, parts[7], 50, dev)
            params = (m, j, k)
            digest = accum_hash(band.run(*params))
            five, n_slots, _ = gridkernel.layout(band.ds.grid)
            occ = _build.occupancy("grid", int(five), n_slots, 0, dev.index or 0)
            print(f"READY {_build.grid_block()} {digest} {occ['local_bytes']} "
                  f"{occ['blocks_per_sm']}", flush=True)
        elif parts[0] == "go":
            t0 = time.perf_counter()
            band.run(*params)
            print(f"T {time.perf_counter() - t0:.6f}", flush=True)
        elif parts[0] == "quit":
            break
    return 0


def cuda_device(device) -> torch.device:
    """``device`` as a CUDA device; raises otherwise: the block sweep builds
    the grid kernel once per block size and times it on a card."""
    from .renderer import render_device

    dev = render_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the block sweep (--full) builds and times the grid kernel "
                           "once per block size and needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device() if dev.index is None else dev.index)


def sweep_block(blocks=(64, 128, 256), width: int = 1920, height: int = 1080,
                spp: int = 200, rounds: int = 5, m: Optional[int] = None,
                j: Optional[int] = None, k: Optional[int] = None, save: bool = True,
                verbose: bool = True, mode: str = "exact", device="cuda") -> dict:
    """Cross-process sweep of the grid kernel's threads per block, the
    port's counterpart of the JAX package's TILE sweep (``sweep_tile``).
    Builds every block's library at once, starts one persistent worker per
    block (``--worker``), warms them one after another, refuses a block
    whose accumulator differs from block 128's, times the rest in
    interleaved rounds and caches the fastest as ``block`` in the
    (device kind, mode) row; a later process builds at that block.
    M, J and K default to the cached row's, else the renderer's and the
    card profile's.  Returns the row, with "block_candidates" (ns per
    sample), "block_ptxas" (registers and spill stores of the grid
    kernel's instances) and "block_refused"."""
    from .. import _build
    from .chips import profile_for

    dev = cuda_device(device)
    blocks = [_build.check_block(b) for b in blocks]
    ref_block = _build.DEFAULT_GRID_BLOCK  # every block's image is held against its
    if ref_block not in blocks:
        raise ValueError(f"sweep_block needs block {ref_block}, the reference image, "
                         f"among {blocks}")
    kind = device_kind(dev)
    tuned = load_tuned(kind, mode=mode) or {}
    prof = profile_for(kind)
    m = int(m if m is not None else tuned.get("m", _seed_m(width, height, dev)))
    j = int(j if j is not None else tuned.get("j", prof.j_steps))
    k = int(k if k is not None else tuned.get("k", prof.k_steps))

    with ThreadPoolExecutor(len(blocks)) as ex:  # one nvcc per source and block
        logs = dict(zip(blocks, (b["log"] for b in ex.map(lambda b: _build.build(block=b),
                                                          blocks))))
    ptxas = {}
    for b in blocks:
        rep = _build.ptxas_report(logs[b], "grid_megakernel_step_kernel").values()
        ptxas[b] = {"registers": max((r["registers"] for r in rep), default=0),
                    "spill_stores": max((r["spill_stores"] for r in rep), default=0)}

    env_path = os.pathsep.join([str(_build.REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    workers, ready, times = {}, {}, {}
    try:
        for b in blocks:
            env = dict(os.environ, PYTHONPATH=env_path, **{_build.GRID_BLOCK_ENV: str(b)})
            workers[b] = subprocess.Popen(
                [sys.executable, "-m", "raytrace_tpu_torch.runtime.autotune", "--worker"],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, env=env)

        def cmd(b, line, expect):
            w = workers[b]
            w.stdin.write(line + "\n")
            w.stdin.flush()
            while True:
                out = w.stdout.readline()
                if not out:
                    raise RuntimeError(f"block worker {b} died")
                if out.startswith(expect):
                    return out.split()

        for b in blocks:  # one card: warms one after another
            t0 = time.perf_counter()
            _, got, digest, local, per_sm = cmd(
                b, f"warm {width} {height} {spp} {m} {j} {k} {mode} {dev}", "READY")
            if int(got) != b:
                raise RuntimeError(f"block worker {b} built block {got}")
            ready[b] = dict(hash=digest, local_bytes=int(local), blocks_per_sm=int(per_sm))
            if verbose:
                print(f"sweep_block: warm block={b} ({time.perf_counter() - t0:.1f}s) "
                      f"{ready[b]} ptxas {ptxas[b]}", flush=True)
        ref = ready[ref_block]["hash"]
        refused = {str(b): f"accumulator {ready[b]['hash']} != block {ref_block}'s {ref}"
                   for b in blocks if ready[b]["hash"] != ref}
        timed = [b for b in blocks if str(b) not in refused]
        times = {b: [] for b in timed}
        for rnd in range(rounds):
            for b in timed:
                times[b].append(float(cmd(b, "go", "T ")[1]))
            if verbose:
                print(f"sweep_block round {rnd}: " + " ".join(
                    f"{b}={times[b][-1]:.4f}s" for b in timed), flush=True)
    finally:
        for w in workers.values():
            try:
                w.stdin.write("quit\n")
                w.stdin.close()
                w.wait(timeout=60)
            except (OSError, subprocess.TimeoutExpired):
                w.kill()
                w.wait()

    medians = {b: statistics.median(ts) for b, ts in times.items()}
    best = min(timed, key=lambda b: medians[b])
    samples = width * height * spp
    result = dict(tuned) if tuned else {"m": m, "j": j, "k": k, "device_kind": kind}
    result.update(mode=mode, block=int(best), acc_hash=ref,
                  block_candidates={str(b): round(medians[b] / samples * 1e9, 3)
                                    for b in timed},
                  block_ptxas={str(b): dict(ptxas[b], local_bytes=ready[b]["local_bytes"],
                                            blocks_per_sm=ready[b]["blocks_per_sm"])
                               for b in blocks},
                  block_refused=refused)
    if verbose:
        for b in timed:
            mark = " <- best" if b == best else ""
            print(f"sweep_block: block={b} {medians[b] / samples * 1e9:.3f} "
                  f"ns/sample{mark}", flush=True)
    if save:
        save_tuned(result)
    return result


def save_tuned(result: dict, path: Optional[Path] = None) -> None:
    p = Path(path) if path is not None else CACHE_PATH
    p.parent.mkdir(parents=True, exist_ok=True)
    data = {}
    if p.exists():
        try:
            data = json.loads(p.read_text())
        except (json.JSONDecodeError, OSError):
            data = {}
    data[_cache_key(result["device_kind"], result.get("mode", "exact"))] = result
    p.write_text(json.dumps(data, indent=1))


def _read_cache(path: Optional[Path]) -> dict:
    p = Path(path) if path is not None else CACHE_PATH
    if not p.exists():
        return {}
    try:
        return json.loads(p.read_text())
    except (json.JSONDecodeError, OSError):
        return {}


def load_tuned(device_kind: Optional[str] = None, path: Optional[Path] = None,
               mode: str = "exact") -> Optional[dict]:
    """The cached row of ``device_kind`` (default: CUDA device 0's; None
    without a CUDA device) and ``mode``; a fast-mode lookup falls back to
    the exact row."""
    data = _read_cache(path)
    if not data:
        return None
    if device_kind is None:
        if not torch.cuda.is_available():
            return None
        device_kind = torch.cuda.get_device_name(0)
    tuned = data.get(_cache_key(device_kind, mode))
    if tuned is None and mode != "exact":
        tuned = data.get(device_kind)  # exact-mode fallback
    return tuned


def cached_block(device_kind: str, path: Optional[Path] = None) -> Optional[int]:
    """The grid kernel block cached for ``device_kind`` by ``sweep_block``
    (its exact row's, else any mode's), or None."""
    rows = [row for key, row in _read_cache(path).items()
            if key == device_kind or key.startswith(device_kind + "|")]
    for row in sorted(rows, key=lambda r: r.get("mode", "exact") != "exact"):
        if "block" in row:
            return int(row["block"])
    return None


def apply_tuned(tuned: Optional[dict] = None) -> Optional[dict]:
    """Apply a tuned point: sets ``gridkernel.J_STEPS`` / ``K_STEPS`` (read
    by the driver at every launch) and returns the dict (the caller passes
    ``m`` as ``RenderConfig(pixels_per_lane=...)``).  No-op returning None
    when no tune exists for the live card."""
    if tuned is None:
        tuned = load_tuned()
    if tuned is None:
        return None
    from ..ops import gridkernel as gk

    gk.J_STEPS = int(tuned["j"])
    gk.K_STEPS = int(tuned["k"])
    return tuned


if __name__ == "__main__":
    if "--worker" in sys.argv:
        raise SystemExit(_worker_main())
    raise SystemExit("usage: python -m raytrace_tpu_torch.runtime.autotune --worker")
