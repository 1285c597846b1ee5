"""Single-device render orchestrator.

Port of ``raytrace_tpu/runtime/renderer.py``: backend resolution, the
pixels-per-lane pick, row-band chunking (one ``render_band`` call per band),
progressive multi-call accumulation (on the grid backend merged in the
kernel, ``calls_per_exec`` calls per dispatch), the balanced pixel->lane
tables (``enable_balance``), checkpoint and resume, the frame-loop
benchmark and the u8 display image.

Chunking is seed-transparent: bands seed from global pixel coordinates, so
any ``chunk_rows`` gives bit-identical output to an unchunked render.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import RenderConfig
from ..models.camera import Camera
from ..models.scene import SceneArrays, generate_random_scene
from ..ops import image as imageops
from ..ops import launches
from ..ops.trace import (LANE_PAD, DeviceScene, device_scene_from_numpy,
                         prepare_scene, render_band, tmax_never_binds,
                         viewport_arrays)

# lanes per band: the spec paths materialise [lanes, spheres] (and
# bruteforce [lanes, spheres, 3]) intersection temporaries; the kernel steps
# keep only [rows, lanes] state
_TARGET_LANES = {
    "bruteforce": 1 << 14, "matmul": 1 << 18, "pallas": 1 << 19,
    "mega": 1 << 21, "grid": 1 << 21, "paged": 1 << 21,
}
CPU_LANES_TARGET = 1 << 12  # the plain steps' lane target on the CPU
M_MAX = 64  # pixels-per-lane cap


def reference_camera() -> Camera:
    """Fixed camera of the reference frame loop (ray_trace.cpp:669-670, Q4):
    pos (13,11,-3) looking at the origin; fov/aperture/focus baked in rgen."""
    return Camera(look_from=(13.0, 11.0, -3.0), look_at=(0.0, 0.0, 0.0))


def config_camera(config: RenderConfig) -> Camera:
    """Camera from config overrides (lookAt = pos + dir, shader.rgen:48-49)
    or the reference's."""
    if config.camera_pos is None and config.camera_dir is None:
        return reference_camera()
    pos = config.camera_pos if config.camera_pos is not None else (13.0, 11.0, -3.0)
    d = config.camera_dir if config.camera_dir is not None else (-pos[0], -pos[1], -pos[2])
    return Camera(look_from=tuple(pos),
                  look_at=(pos[0] + d[0], pos[1] + d[1], pos[2] + d[2]))


def resolve_backend(requested: str, device_scene: DeviceScene) -> str:
    """``auto`` -> the grid-DDA kernel when the scene has grid tables, else
    the paged-grid kernel when it has paged tables, else the brute-force
    megakernel — on any device: the step wrapper, not the renderer, picks
    kernel or plain version by the state's device."""
    if requested == "auto":
        if device_scene.grid is not None:
            return "grid"
        return "paged" if device_scene.paged is not None else "mega"
    return requested


def render_device(device) -> torch.device:
    """The device a render runs on: a CUDA device unless the caller asks for
    the CPU.  Raises when a CUDA device is asked for and there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the renderer runs on the GPU; pass device='cpu' "
            "to render on the CPU with the kernels' plain torch versions")
    return device


def lanes_target(device: torch.device, backend: str = "mega") -> int:
    """Lane target of a band: on a CUDA device every SM's thread slots times
    the card profile's ``lanes_per_thread`` for the grid backend (its driver
    launches over the live lanes only, and its 1080p x 16 spp frame took
    the least kernel time at 4, M=2; ``runtime/chips.py``) and 1 for the
    others; a small fixed count for the plain steps on the CPU."""
    if device.type == "cuda":
        from .chips import profile_for

        p = torch.cuda.get_device_properties(device)
        per_thread = profile_for(p.name).lanes_per_thread if backend == "grid" else 1
        return p.multi_processor_count * p.max_threads_per_multi_processor * per_thread
    return CPU_LANES_TARGET


def band_layout(config: RenderConfig, device: torch.device, backend: str,
                rows: int):
    """(pixels_per_lane, chunk_rows) of a band of ``rows`` image rows: the
    config's M, else the fewest pixels per lane that keep the lane count
    within the device's lane target for the backend (output is identical for
    any M), and the rows per ``render_band`` call that keep the lanes within
    the backend's ``_TARGET_LANES``."""
    w = config.width
    if config.pixels_per_lane is not None:
        m = config.pixels_per_lane
    else:
        m = int(np.clip(-(-(w * rows) // lanes_target(device, backend)), 1, M_MAX))
    target = _TARGET_LANES.get(backend, 1 << 14)
    return m, max(1, min(rows, (target * m) // max(w, 1)))


class Renderer:
    """Renders full frames on one device (one ``render_band`` per band).
    ``config.chips`` is not read: like the JAX ``Renderer``, this one renders
    on its one device (``parallel/`` splits rows over several)."""

    def __init__(self, config: RenderConfig, scene: Optional[SceneArrays] = None,
                 device="cuda"):
        if config.accum_dtype not in ("float32", "float64"):
            raise ValueError(f"unsupported accum_dtype: {config.accum_dtype!r}")
        self.config = config
        self.device = render_device(device)
        self.scene = scene if scene is not None else generate_random_scene(config.scene_time)
        self.set_scene(self.scene)
        self.pixels_per_lane, self.chunk_rows = band_layout(
            config, self.device, self.backend, config.height)
        self.vp = viewport_arrays(config_camera(config), config.width, config.height)
        # balanced pixel->lane tables per band (runtime/balance.py), built on
        # demand when config.balance_spp > 0, or by enable_balance
        self._passign = None
        self.balance_stats = None

    def set_scene(self, scene: SceneArrays) -> None:
        """Render ``scene`` from now on: its tables go to the device and the
        backend is resolved again."""
        with launches.span("renderer.set_scene") as rec:
            self.scene = scene
            self.device_scene = device_scene_from_numpy(prepare_scene(scene), self.device)
            self.backend = resolve_backend(self.config.backend, self.device_scene)
            self.skip_tmax = tmax_never_binds(scene, config_camera(self.config))
            rec.set(backend=self.backend)

    def _bands(self):
        h = self.config.height
        for band_y0 in range(0, h, self.chunk_rows):
            yield band_y0, min(self.chunk_rows, h - band_y0)

    def _band_kwargs(self, band_y0, band_h):
        cfg = self.config
        return dict(scene=self.device_scene, vp=self.vp, band_h=band_h,
                    width=cfg.width, y0=band_y0,
                    seed_y0=band_y0,  # global coords: chunk-invariant
                    offset_x=0, max_depth=cfg.max_depth, backend=self.backend,
                    pixels_per_lane=self.pixels_per_lane,
                    skip_tmax=self.skip_tmax, rr=cfg.rr)

    def render_call(self, spp: int, number: int = 0, accum=None, n_calls=None,
                    spp_last=None, return_iters: bool = False):
        """One render call (= one traceRaysKHR dispatch): ``spp`` samples per
        pixel.  Returns the accumulated color sum [H, W, 3] (f32 tensor on
        the device, pre-gamma); ``accum`` carries the running sum.
        ``n_calls``/``spp_last`` (grid backend): merge that many progressive
        calls into this one dispatch (numbers number..number+n_calls-1,
        ``spp`` each, ``spp_last`` for the final one), bit-identical to the
        same calls issued separately.  ``return_iters``: return (accum,
        tile_iters, lane_slots), the launches' iterations summed over their
        blocks of ``LANE_PAD`` lanes and over their lane slots.  The grid
        and paged backends render under their kernel module's ``ABLATE``
        (the section-cost probes' switches, read at call time, as
        ``scripts/grid_ablate.py`` sets them)."""
        from ..ops import gridkernel, pagedkernel

        cfg = self.config
        ablate = tuple(sorted({"grid": gridkernel.ABLATE,
                               "paged": pagedkernel.ABLATE}.get(self.backend, ())))
        if cfg.balance_spp and self.backend == "grid" and self._passign is None:
            self.enable_balance()
        if accum is not None:
            accum = torch.as_tensor(accum, device=self.device)
        bands = []
        tile_iters = lane_slots = 0
        layout = list(self._bands())
        with launches.span("renderer.call", spp=spp, n_calls=n_calls or 1, bands=len(layout)):
            for band_y0, band_h in layout:
                out = render_band(
                    **self._band_kwargs(band_y0, band_h), spp=spp, number=number,
                    accum_init=None if accum is None else accum[band_y0 : band_y0 + band_h],
                    n_calls=n_calls, spp_last=spp_last,
                    passign=None if self._passign is None else self._passign.get(band_y0),
                    ablate=ablate, return_iters=return_iters)
                if return_iters:
                    out, (ti, ls) = out
                    tile_iters += ti
                    lane_slots += ls
                bands.append(out)
            acc = torch.cat(bands, dim=0)
        return (acc, tile_iters, lane_slots) if return_iters else acc

    def enable_balance(self, probe_spp: Optional[int] = None) -> dict:
        """Measure per-pixel costs with the grid kernel's iterstats probe and
        build a balanced pixel->lane table per band (runtime/balance.py).
        The image is bit-identical with or without the tables; only the
        lanes' straggler tail moves.  Returns per-band {max_over_mean, lanes,
        issued_per_sample} diagnostics."""
        from . import balance as bal

        if self.backend != "grid":
            raise ValueError("balanced assignment is a grid-backend feature")
        spp = probe_spp or self.config.balance_spp or 32
        tables, stats = {}, {}
        for band_y0, band_h in self._bands():
            cost = bal.measure_cost_map(
                dict(self._band_kwargs(band_y0, band_h), number=0), spp)
            tab = bal.build_passign(cost, self.pixels_per_lane, LANE_PAD)
            tables[band_y0] = torch.from_numpy(tab).to(self.device)
            stats[band_y0] = bal.balance_stats(cost, tab, self.pixels_per_lane)
            # mean issued (busy) iterations per sample from the probe
            stats[band_y0]["issued_per_sample"] = float(
                np.asarray(cost, np.float64).mean() / spp)
        self._passign = tables
        self.balance_stats = stats
        return stats

    def render(self, samples: Optional[int] = None, on_chunk=None):
        """Full render: ``samples`` total spp, split into progressive calls
        of ``config.samples_per_call``.  Returns (accum_sum [H,W,3], total).

        ``accum_dtype="float64"`` reproduces the reference's dvec3
        accumulation across calls (each call's f32 sum is added into an f64
        accumulator); in-call sums stay f32."""
        cfg = self.config
        total = cfg.samples if samples is None else samples
        per_call = cfg.samples_per_call or total
        number = 0
        done = 0
        accum = None
        if cfg.accum_dtype == "float64":
            while done < total:
                spp = min(per_call, total - done)
                chunk = self.render_call(spp, number=number).to(torch.float64)
                accum = chunk if accum is None else accum + chunk
                done += spp
                number += 1
                if on_chunk is not None:
                    on_chunk(accum, done)
            return accum, total
        # grid backend: up to calls_per_exec progressive calls merged into one
        # dispatch; the output is bit-identical for any grouping, and
        # on_chunk fires once per dispatch
        group_max = max(1, cfg.calls_per_exec) if self.backend == "grid" else 1
        while done < total:
            remaining = total - done
            nc = min(group_max, -(-remaining // per_call))
            if nc > 1:
                spp_last = min(per_call, remaining - (nc - 1) * per_call)
                accum = self.render_call(per_call, number=number, accum=accum,
                                         n_calls=nc, spp_last=spp_last)
                step = (nc - 1) * per_call + spp_last
            else:
                step = min(per_call, remaining)
                accum = self.render_call(step, number=number, accum=accum)
            done += step
            number += nc
            if on_chunk is not None:
                on_chunk(accum, done)
        return accum, total

    def render_u8(self, samples: Optional[int] = None) -> np.ndarray:
        """Render and tonemap to the display image (u8 RGB, host array)."""
        accum, total = self.render(samples)
        return imageops.accum_to_u8(accum, total).cpu().numpy()

    def save_state(self, path: str, accum, samples_done: int, number: int) -> None:
        """Checkpoint a progressive render (accumulator and progress)."""
        np.savez(path, accum=torch.as_tensor(accum).cpu().numpy(),
                 samples_done=samples_done, number=number,
                 width=self.config.width, height=self.config.height)

    def load_state(self, path: str):
        """Returns (accum [H, W, 3] numpy, samples_done, number) for resuming
        ``render``."""
        z = np.load(path)
        if (int(z["width"]), int(z["height"])) != (self.config.width, self.config.height):
            raise ValueError("checkpoint resolution mismatch")
        return z["accum"], int(z["samples_done"]), int(z["number"])

    def render_resumable(self, total: int, checkpoint_path: Optional[str] = None,
                         checkpoint_every: int = 0, max_retries: int = 2):
        """Progressive render with checkpoint/resume and retry: each call's
        accumulator is copied to the host, so a fault loses at most one
        call's work and the call is retried.  Returns (accum [H, W, 3] f32
        CPU tensor, samples done)."""
        cfg = self.config
        if checkpoint_every:
            per_call = cfg.samples_per_call or max(1, checkpoint_every)
        else:
            per_call = cfg.samples_per_call or total
        accum, done, number = None, 0, 0
        if checkpoint_path and os.path.exists(checkpoint_path):
            accum, done, number = self.load_state(checkpoint_path)
            accum = torch.from_numpy(accum)
        retries = 0
        while done < total:
            spp = min(per_call, total - done)
            try:
                out = self.render_call(spp, number=number, accum=accum).cpu()
            except Exception:
                if retries >= max_retries:
                    raise
                retries += 1
                continue  # accum (a host copy) is intact; retry the call
            accum, done, number = out, done + spp, number + 1
            if checkpoint_path and checkpoint_every and done < total:
                self.save_state(checkpoint_path, accum, done, number)
        return accum, done

    def benchmark(self, min_seconds: float = 4.0, warmup: int = 1):
        """Frame-loop benchmark with the reference's adaptive window:
        duration_per_frame over >= (4 s + 50 dpf) / dpf frames
        (ray_trace.cpp:86,741-748), each frame synchronised with the device.
        Returns (dpf seconds, frames)."""
        spp = self.config.samples

        def frame():
            out = self.render_call(spp)
            if out.is_cuda:
                torch.cuda.synchronize(out.device)

        for _ in range(warmup):
            frame()
        t0 = time.perf_counter()
        frame()
        dpf = time.perf_counter() - t0
        frames = max(1, int((min_seconds + 50.0 * dpf) / dpf)) if dpf > 0 else 1
        frames = min(frames, 1000)
        t0 = time.perf_counter()
        for _ in range(frames):
            frame()
        dpf = (time.perf_counter() - t0) / frames
        print(f"duration_per_frame: {dpf * 1000.0:.3f} ms")
        return dpf, frames
