"""Row bands over several devices: the static equal split.

Port of ``raytrace_tpu/parallel/sharding.py`` (the reference's multi-GPU
spatial split, ray_trace.cpp:74-105): the image is split into horizontal
row bands, one per device, the scene replicated.  Where JAX runs one
``shard_map`` program over a device mesh, the port renders each band with
``ops/trace.render_band_steps``, every band stepped from the calling thread
as soon as its last launch has completed, each on a CUDA stream of its own
(``devices.run_in_turns``), and concatenates the bands; devices that are
the same device share one copy of the scene tables.

Seed semantics (``reference_banding``):
- ``False`` (default): every band seeds from global pixel rows, so an
  N-band render is bit-identical to the single-device render.
- ``True``: bands seed from band-local rows like the reference's per-GPU
  launches (shader.rgen:40, per-device offset at :45): statistically the
  same image, another sample stream.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..config import RenderConfig
from ..models.scene import SceneArrays, generate_random_scene
from ..ops import image as imageops
from ..ops.trace import (device_scene_from_numpy, prepare_scene,
                         render_band_steps, tmax_never_binds, viewport_arrays)
from ..runtime.renderer import (band_layout, config_camera, render_device,
                                resolve_backend)
from .devices import pick_devices, run_in_turns


def upload_per_device(scene: SceneArrays, devices: Sequence[torch.device]) -> dict:
    """{device: DeviceScene}: the scene's tables once on each distinct
    device (bands on one device share them)."""
    host = prepare_scene(scene)
    return {d: device_scene_from_numpy(host, d) for d in dict.fromkeys(devices)}


def rows_steps(scene, vp, config: RenderConfig, *, backend, skip_tmax, device,
               y0, rows, seed_y0, spp, number, accum=None):
    """Image rows [y0, y0 + rows) on ``device``, seeded from row ``seed_y0``,
    as a generator of steps (``render_band_steps``) over chunks of at most
    ``band_layout``'s chunk rows (seed transparent: each chunk seeds from its
    own first row).  ``accum``: the running sum of these rows.  Returns
    [rows, W, 3] f32 on the device."""
    m, chunk = band_layout(config, device, backend, rows)
    out = []
    for c0 in range(0, rows, chunk):
        ch = min(chunk, rows - c0)
        out.append((yield from render_band_steps(
            scene, vp, band_h=ch, width=config.width, y0=y0 + c0, seed_y0=seed_y0 + c0,
            offset_x=0, spp=spp, number=number,
            accum_init=None if accum is None else accum[c0 : c0 + ch],
            max_depth=config.max_depth, backend=backend, pixels_per_lane=m,
            skip_tmax=skip_tmax, rr=config.rr)))
    return out[0] if len(out) == 1 else torch.cat(out, dim=0)


class MultiChipRenderer:
    """Renders equal row bands, one per device.  ``devices``: a list of
    torch devices (the same device may repeat: its bands then run
    together on streams of their own); None picks ``config.chips`` devices
    of ``device``'s type, so one GPU gives one band, as JAX truncates its
    mesh to the devices there are."""

    def __init__(self, config: RenderConfig, scene: Optional[SceneArrays] = None,
                 devices: Optional[Sequence] = None, reference_banding: bool = False,
                 device="cuda"):
        self.config = config
        self.scene = scene if scene is not None else generate_random_scene(config.scene_time)
        if devices is None:
            devices = pick_devices(config.chips, render_device(device).type)
        self.devices = [render_device(d) for d in devices]
        self.n = len(self.devices)
        if self.n == 0:
            raise ValueError("no devices to render on")
        self.device_scenes = upload_per_device(self.scene, self.devices)
        self.backend = resolve_backend(config.backend, self.device_scenes[self.devices[0]])
        self.reference_banding = reference_banding
        h = config.height
        # pad the height to a multiple of the band count; the extra rows are
        # rendered and cropped, so every band has the same height
        self.padded_h = -(-h // self.n) * self.n
        self.band_h = self.padded_h // self.n
        self.vp = viewport_arrays(config_camera(config), config.width, h)
        self.skip_tmax = tmax_never_binds(self.scene, config_camera(config))

    def render_call(self, spp: int, number: int = 0, accum=None) -> torch.Tensor:
        """One call of ``spp`` samples over every band; returns the
        accumulated sum [H, W, 3] (f32, on the first device; unpadded).
        ``accum`` carries the running sum."""
        cfg = self.config
        dev0 = self.devices[0]
        if accum is not None:
            accum = torch.as_tensor(accum, dtype=torch.float32)
            pad = self.padded_h - cfg.height
            if pad:
                accum = torch.cat([accum, accum.new_zeros((pad, cfg.width, 3))], dim=0)

        def band(i):
            dev = self.devices[i]
            y0 = i * self.band_h
            acc = None if accum is None else accum[y0 : y0 + self.band_h].to(dev)
            return rows_steps(
                self.device_scenes[dev], self.vp, cfg, backend=self.backend,
                skip_tmax=self.skip_tmax, device=dev, y0=y0, rows=self.band_h,
                seed_y0=0 if self.reference_banding else y0, spp=spp, number=number,
                accum=acc)

        bands, _ = run_in_turns(self.devices, band)
        return torch.cat([b.to(dev0) for b in bands], dim=0)[: cfg.height]

    def render(self, samples: Optional[int] = None):
        """Progressive render in calls of ``config.samples_per_call``;
        returns (accum [H, W, 3], total samples)."""
        cfg = self.config
        total = cfg.samples if samples is None else samples
        per_call = cfg.samples_per_call or total
        accum, number, done = None, 0, 0
        while done < total:
            spp = min(per_call, total - done)
            accum = self.render_call(spp, number=number, accum=accum)
            done += spp
            number += 1
        return accum, total

    def render_u8(self, samples: Optional[int] = None) -> np.ndarray:
        accum, total = self.render(samples)
        return imageops.accum_to_u8(accum, total).cpu().numpy()
