"""Single-device render orchestrator.

Port of ``raytrace_tpu/runtime/renderer.py``: backend resolution, the
pixels-per-lane pick, row-band chunking (one ``render_band`` call per band),
progressive multi-call accumulation and the u8 display image.

Chunking is seed-transparent: bands seed from global pixel coordinates, so
any ``chunk_rows`` gives bit-identical output to an unchunked render.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import RenderConfig
from ..models.camera import Camera
from ..models.scene import SceneArrays, generate_random_scene
from ..ops import image as imageops
from ..ops.trace import (_TODO_BALANCE, _TODO_MERGE, DeviceScene,
                         device_scene_from_numpy, prepare_scene, render_band,
                         tmax_never_binds, viewport_arrays)

# lanes per band: the spec paths materialise [lanes, spheres] (and
# bruteforce [lanes, spheres, 3]) intersection temporaries; the kernel steps
# keep only [rows, lanes] state
_TARGET_LANES = {
    "bruteforce": 1 << 14, "matmul": 1 << 18, "pallas": 1 << 19,
    "mega": 1 << 21, "grid": 1 << 21, "paged": 1 << 21,
}
CPU_LANES_TARGET = 1 << 12  # the plain steps' lane target on the CPU
# lanes per thread slot of the card, by backend: the grid driver launches
# over its live lanes only, and its 1080p x 16 spp frame took the least
# kernel time at M=2, 4x the card's 2048 threads per SM (PERF.md)
LANES_PER_THREAD = {"grid": 4}
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
    ``LANES_PER_THREAD`` of the backend, a small fixed count for the plain
    steps on the CPU."""
    if device.type == "cuda":
        p = torch.cuda.get_device_properties(device)
        return (p.multi_processor_count * p.max_threads_per_multi_processor
                * LANES_PER_THREAD.get(backend, 1))
    return CPU_LANES_TARGET


class Renderer:
    """Renders full frames on one device (one ``render_band`` per band)."""

    def __init__(self, config: RenderConfig, scene: Optional[SceneArrays] = None,
                 device="cuda"):
        if config.chips > 1:
            raise NotImplementedError(
                "chips > 1: row bands over several devices (ROADMAP queue 1, item 5)")
        if config.calls_per_exec > 1:
            raise NotImplementedError(f"calls_per_exec > 1: {_TODO_MERGE}")
        if config.balance_spp > 0:
            raise NotImplementedError(f"balance_spp > 0: {_TODO_BALANCE}")
        if config.accum_dtype not in ("float32", "float64"):
            raise ValueError(f"unsupported accum_dtype: {config.accum_dtype!r}")
        self.config = config
        self.device = render_device(device)
        self.scene = scene if scene is not None else generate_random_scene(config.scene_time)
        self.device_scene = device_scene_from_numpy(prepare_scene(self.scene),
                                                    self.device)
        self.backend = resolve_backend(config.backend, self.device_scene)
        w, h = config.width, config.height
        if config.pixels_per_lane is not None:
            self.pixels_per_lane = config.pixels_per_lane
        else:
            # fewest pixels per lane that keeps the lane count within the
            # backend's lane target (output is identical for any M)
            target = lanes_target(self.device, self.backend)
            self.pixels_per_lane = int(np.clip(-(-(w * h) // target), 1, M_MAX))
        target = _TARGET_LANES.get(self.backend, 1 << 14)
        self.chunk_rows = max(1, min(h, (target * self.pixels_per_lane) // max(w, 1)))
        cam = config_camera(config)
        self.vp = viewport_arrays(cam, w, h)
        self.skip_tmax = tmax_never_binds(self.scene, cam)

    def render_call(self, spp: int, number: int = 0, accum=None) -> torch.Tensor:
        """One render call (= one traceRaysKHR dispatch): ``spp`` samples per
        pixel.  Returns the accumulated color sum [H, W, 3] (f32 tensor on
        the device, pre-gamma); ``accum`` carries the running sum."""
        cfg = self.config
        w, h = cfg.width, cfg.height
        bands = []
        for band_y0 in range(0, h, self.chunk_rows):
            band_h = min(self.chunk_rows, h - band_y0)
            init = None if accum is None else accum[band_y0 : band_y0 + band_h]
            bands.append(render_band(
                self.device_scene, self.vp, band_h=band_h, width=w,
                y0=band_y0, seed_y0=band_y0,  # global coords: chunk-invariant
                offset_x=0, spp=spp, number=number, accum_init=init,
                max_depth=cfg.max_depth, backend=self.backend,
                pixels_per_lane=self.pixels_per_lane, skip_tmax=self.skip_tmax,
                rr=cfg.rr))
        return torch.cat(bands, dim=0)

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
        while done < total:
            spp = min(per_call, total - done)
            if cfg.accum_dtype == "float64":
                chunk = self.render_call(spp, number=number).to(torch.float64)
                accum = chunk if accum is None else accum + chunk
            else:
                accum = self.render_call(spp, number=number, accum=accum)
            done += spp
            number += 1
            if on_chunk is not None:
                on_chunk(accum, done)
        return accum, total

    def render_u8(self, samples: Optional[int] = None) -> np.ndarray:
        """Render and tonemap to the display image (u8 RGB, host array)."""
        accum, total = self.render(samples)
        return imageops.accum_to_u8(accum, total).cpu().numpy()
