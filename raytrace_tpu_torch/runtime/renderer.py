"""The row-band plan and the single-device renderer.

Port of ``raytrace_tpu/runtime/renderer.py``: backend resolution, the
pixels-per-lane pick, row-band chunking, progressive multi-call
accumulation (on the grid backend merged in the kernel, ``calls_per_exec``
calls per dispatch), the balanced pixel->lane tables (``enable_balance``),
checkpoint and resume, the frame-loop benchmark and the u8 display image.

``BandPlan`` is what the port's three renderers render rows through: this
module's ``Renderer`` (one band of every row, on one device) and the band
renderers of ``parallel/sharding.py`` and ``parallel/hetero.py``.  It binds
a scene to the devices (``set_scene``), picks a band's lane layout once per
device, backend and band height (``layout``), steps a band over its chunks
(``band_steps``) and probes a band for its balanced tables
(``balance_steps``); ``progressive_render`` runs a renderer's progressive
calls through its ``render_call``.

Chunking is seed-transparent: chunks seed from global pixel coordinates, so
any ``chunk_rows`` gives bit-identical output to an unchunked render.
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..config import RenderConfig
from ..models.camera import Camera
from ..models.scene import SceneArrays, generate_random_scene
from ..ops import gridkernel, launches, pagedkernel, trace
from ..ops import image as imageops
from ..ops.trace import (LANE_PAD, DeviceScene, device_scene_from_numpy,
                         prepare_scene, run_steps, tmax_never_binds,
                         viewport_arrays)
from . import balance as bal

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


class Band(NamedTuple):
    """A row band: the device it renders on, its first image row, its rows
    and the image row its seeds start from."""

    device: torch.device
    y0: int
    rows: int
    seed_y0: int


def upload_per_device(scene: SceneArrays, devices: Sequence[torch.device]) -> dict:
    """{device: DeviceScene}: the scene's tables once on each distinct
    device (bands on one device share them).  For a scene the grid refuses
    by its size (``trace.builds_on_device``) only the scene's own arrays go
    up, and each device builds its tables; otherwise ``prepare_scene``
    builds them once on the host and they go up whole."""
    devs = list(dict.fromkeys(devices))
    on_device = trace.builds_on_device(scene)
    host = None if on_device else prepare_scene(scene)
    with launches.span("scene.upload", devices=len(devs)) as rec:
        if on_device:
            sent = {d: trace.scene_to_device(scene, d) for d in devs}
            rec.set(bytes=sum(n_bytes for _, n_bytes in sent.values()))
        else:
            out = {d: device_scene_from_numpy(host, d) for d in devs}
            if rec is not launches.NO_RECORD:
                rec.set(bytes=sum(_nbytes(ds) for ds in out.values()))
    if on_device:
        out = {d: trace.prepare_scene_device(arrays) for d, (arrays, _) in sent.items()}
    return out


def _nbytes(ds: DeviceScene) -> int:
    """The bytes of a DeviceScene's tensors, its tables' included."""
    ts = [getattr(ds, f) for f in DeviceScene._fields if f not in ("grid", "paged")]
    for tables in (ds.grid, ds.paged):
        if tables is not None:
            ts += list(tables)
    return sum(t.numel() * t.element_size() for t in ts if isinstance(t, torch.Tensor))


class BandPlan:
    """The rows of a render as bands over ``devices`` (torch devices; a
    device may repeat): the scene bound to them, each band's lane layout, a
    band stepped over its chunks, and the balanced pixel->lane tables
    (``runtime/balance.py``), one per chunk, keyed by the chunk's first
    image row (chunks never overlap, so one dict serves every band).  The
    image is bit-identical for any chunking and any tables."""

    chunk_rows: Optional[int] = None  # rows per chunk; None: band_layout's
    passign: Optional[dict] = None  # {chunk's first row: table on its device}
    balance_stats: Optional[dict] = None  # {chunk's first row: probe stats}

    def __init__(self, config: RenderConfig, scene: Optional[SceneArrays], devices):
        if config.accum_dtype not in ("float32", "float64"):
            raise ValueError(f"unsupported accum_dtype: {config.accum_dtype!r}")
        self.config = config
        self.devices = [render_device(d) for d in devices]
        self.n = len(self.devices)
        if self.n == 0:
            raise ValueError("no devices to render on")
        self._layouts = {}
        self.vp = viewport_arrays(config_camera(config), config.width, config.height)
        self.set_scene(scene if scene is not None else generate_random_scene(config.scene_time))

    def set_scene(self, scene: SceneArrays) -> None:
        """Render ``scene`` from now on (animation: a new
        ``generate_random_scene(t)`` per frame, ray_trace.cpp:665): its
        tables go once to each distinct device and the backend is resolved
        again.  Bands, balanced tables and tuner state are kept."""
        self.scene = scene
        self.device_scenes = upload_per_device(scene, self.devices)
        self.backend = resolve_backend(self.config.backend, self.device_scenes[self.devices[0]])
        self.skip_tmax = tmax_never_binds(scene, config_camera(self.config))

    def layout(self, band: Band):
        """(pixels per lane, rows per chunk) of ``band``: ``band_layout``'s,
        computed once per device, backend and band height; the rows per
        chunk ``chunk_rows`` where that is set."""
        key = (band.device, self.backend, band.rows)
        if key not in self._layouts:
            self._layouts[key] = band_layout(self.config, band.device, self.backend, band.rows)
        m, rows = self._layouts[key]
        return m, self.chunk_rows or rows

    def chunks(self, band: Band) -> list:
        """The ``render_band_steps`` keywords the plan fixes for each chunk
        of ``band`` (at most ``layout``'s rows each, at the band's M)."""
        cfg = self.config
        m, rows = self.layout(band)
        return [dict(scene=self.device_scenes[band.device], vp=self.vp,
                     band_h=min(rows, band.rows - c0), width=cfg.width, y0=band.y0 + c0,
                     seed_y0=band.seed_y0 + c0, offset_x=0, max_depth=cfg.max_depth,
                     backend=self.backend, pixels_per_lane=m, skip_tmax=self.skip_tmax,
                     rr=cfg.rr)
                for c0 in range(0, band.rows, rows)]

    def band_steps(self, band: Band, spp: int, number: int = 0, accum=None, n_calls=None,
                   spp_last=None, return_iters: bool = False):
        """``band``'s rows as a generator of steps (``render_band_steps``)
        over its chunks, each under its balanced table and its kernel
        module's ``ABLATE`` (the section-cost probes' switches, read at call
        time, as ``scripts/grid_ablate.py`` sets them).  ``accum``: the
        image's running sum (this band's rows are read from it, on any
        device).  ``n_calls``/``spp_last``: the grid backend's merged calls.
        Returns [rows, W, 3] f32 on the band's device; with ``return_iters``
        (sum, tile_iters, lane_slots) (``render_band_steps``)."""
        ablate = tuple(sorted({"grid": gridkernel.ABLATE,
                               "paged": pagedkernel.ABLATE}.get(self.backend, ())))
        out, tile_iters, lane_slots = [], 0, 0
        for kw in self.chunks(band):
            y0, h = kw["y0"], kw["band_h"]
            acc = yield from trace.render_band_steps(
                **kw, spp=spp, number=number, n_calls=n_calls, spp_last=spp_last,
                accum_init=None if accum is None else accum[y0 : y0 + h].to(band.device),
                passign=None if self.passign is None else self.passign.get(y0),
                ablate=ablate, return_iters=return_iters)
            if return_iters:
                acc, (ti, ls) = acc
                tile_iters, lane_slots = tile_iters + ti, lane_slots + ls
            out.append(acc)
        acc = out[0] if len(out) == 1 else torch.cat(out, dim=0)
        return (acc, tile_iters, lane_slots) if return_iters else acc

    def probe_spp(self, probe_spp: Optional[int] = None) -> int:
        """The balance probe's spp; raises off the grid backend."""
        if self.backend != "grid":
            raise ValueError("balanced assignment is a grid-backend feature")
        return probe_spp or self.config.balance_spp or 32

    def balance_steps(self, band: Band, spp: int):
        """Measure the per-pixel costs of ``band``'s chunks with the grid
        kernel's iterstats probe at the production operating point and deal
        each chunk's pixels to lanes by them (``build_passign``), as a
        generator of steps.  Returns ({chunk's first row: table on the
        band's device}, {chunk's first row: {max_over_mean, lanes,
        issued_per_sample}})."""
        tables, stats = {}, {}
        for kw in self.chunks(band):
            cost = yield from bal.cost_map_steps(dict(kw, number=0), spp)
            m, y0 = kw["pixels_per_lane"], kw["y0"]
            tab = bal.build_passign(cost, m, LANE_PAD)
            tables[y0] = torch.from_numpy(tab).to(band.device)
            stats[y0] = dict(bal.balance_stats(cost, tab, m),
                             issued_per_sample=float(np.asarray(cost, np.float64).mean() / spp))
        return tables, stats

    def adopt_tables(self, probes) -> dict:
        """Render under the tables of ``probes`` (``balance_steps``' returns)
        from now on; returns their stats (``balance_stats``)."""
        self.passign = {y0: t for tables, _ in probes for y0, t in tables.items()}
        self.balance_stats = {y0: s for _, stats in probes for y0, s in stats.items()}
        return self.balance_stats

    def tables_on_demand(self) -> None:
        """Build the balanced tables (``enable_balance``) before the first
        call where ``config.balance_spp`` asks for them on the grid
        backend."""
        if self.config.balance_spp and self.backend == "grid" and self.passign is None:
            self.enable_balance()


def progressive_render(r, samples: Optional[int] = None, on_chunk=None):
    """Full render through ``r.render_call``: ``samples`` total spp (None:
    the config's), split into progressive calls of
    ``config.samples_per_call``.  On the grid backend up to
    ``calls_per_exec`` calls are merged into one dispatch; the output is
    bit-identical for any grouping, and ``on_chunk(accum, done)`` fires
    once per dispatch.  Returns (accum_sum [H, W, 3], total).

    ``accum_dtype="float64"`` reproduces the reference's dvec3
    accumulation across calls (each call's f32 sum is added into an f64
    accumulator, one call per dispatch); in-call sums stay f32."""
    cfg = r.config
    total = cfg.samples if samples is None else samples
    per_call = cfg.samples_per_call or total
    f64 = cfg.accum_dtype == "float64"
    group_max = max(1, cfg.calls_per_exec) if r.backend == "grid" and not f64 else 1
    accum, number, done = None, 0, 0
    while done < total:
        remaining = total - done
        nc = min(group_max, -(-remaining // per_call))
        spp_last = min(per_call, remaining - (nc - 1) * per_call)
        if f64:
            out = r.render_call(spp_last, number=number).to(torch.float64)
            accum = out if accum is None else accum + out
        elif nc > 1:
            accum = r.render_call(per_call, number=number, accum=accum, n_calls=nc,
                                  spp_last=spp_last)
        else:
            accum = r.render_call(spp_last, number=number, accum=accum)
        done += (nc - 1) * per_call + spp_last
        number += nc
        if on_chunk is not None:
            on_chunk(accum, done)
    return accum, total


def progressive_u8(r, samples: Optional[int] = None) -> np.ndarray:
    """Render (``r.render``) and tonemap to the display image (u8 RGB, host
    array)."""
    accum, total = r.render(samples)
    return imageops.accum_to_u8(accum, total).cpu().numpy()


class Renderer(BandPlan):
    """Renders full frames on one device: one band of every row, stepped
    over its chunks.  ``config.chips`` is not read: like the JAX
    ``Renderer``, this one renders on its one device (``parallel/`` splits
    rows over several)."""

    def __init__(self, config: RenderConfig, scene: Optional[SceneArrays] = None,
                 device="cuda"):
        super().__init__(config, scene, [device])
        self.device = self.devices[0]
        self.bands = [Band(self.device, 0, config.height, 0)]

    @property
    def device_scene(self) -> DeviceScene:
        """The scene's tables on the device."""
        return self.device_scenes[self.device]

    @property
    def pixels_per_lane(self) -> int:
        """The band's pixels per lane (M)."""
        return self.layout(self.bands[0])[0]

    def set_scene(self, scene: SceneArrays) -> None:
        """Render ``scene`` from now on: its tables go to the device and the
        backend is resolved again."""
        with launches.span("renderer.set_scene") as rec:
            super().set_scene(scene)
            rec.set(backend=self.backend)

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
        blocks of ``LANE_PAD`` lanes and over their lane slots."""
        self.tables_on_demand()
        if accum is not None:
            accum = torch.as_tensor(accum, device=self.device)
        band = self.bands[0]
        with launches.span("renderer.call", spp=spp, n_calls=n_calls or 1,
                           bands=len(self.chunks(band))):
            return run_steps(self.band_steps(band, spp, number, accum, n_calls, spp_last,
                                             return_iters))

    def enable_balance(self, probe_spp: Optional[int] = None) -> dict:
        """Build the balanced table of every chunk (``balance_steps``).  The
        image is bit-identical with or without the tables; only the lanes'
        straggler tail moves.  Returns the tables' stats."""
        spp = self.probe_spp(probe_spp)
        return self.adopt_tables([run_steps(self.balance_steps(self.bands[0], spp))])

    render = progressive_render
    render_u8 = progressive_u8

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
