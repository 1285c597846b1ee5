"""Per-device row bands with tuned row counts.

Port of ``raytrace_tpu/parallel/hetero.py``, the analogue of the reference's
multi-GPU architecture (ray_trace.cpp:42-920 and workload_tuner.hpp): each
device renders its own row band independently, and the workload tuner
(``runtime/tuner.py``) re-splits the rows between measurement windows from
each device's busy time.  A re-split only changes band heights.  The
scene binding and each band's chunks are ``runtime/renderer.BandPlan``'s,
as for the port's other renderers.

Dispatch differs from JAX's: the JAX package issues every band and then
fetches them on threads; the port's drivers read their live count on the
host once per launch, so the calling thread steps every band, each on a
CUDA stream of its own, as soon as its last launch has completed
(``devices.run_in_turns``): no band waits on another device's launch.
``per_dev[i]`` is the time from the frame's start to the end of device i's
band, copied to the host: the reference's per-device acquire-present probe
(ray_trace.cpp:609-644), not the bands' serial sum.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np

from ..config import RenderConfig
from ..models.scene import SceneArrays
from ..ops import image as imageops
from ..ops.trace import tmax_never_binds, viewport_arrays
from ..runtime.renderer import Band, BandPlan, config_camera, render_device
from ..runtime.tuner import make_tuner
from .devices import pick_devices, run_in_turns


class HeteroRenderer(BandPlan):
    """Per-device band dispatch with dynamic row rebalancing.  ``devices``:
    a list of torch devices (repeats allowed); None picks ``config.chips``
    devices of ``device``'s type.  ``set_scene`` keeps the band split and
    the tuner state, as the reference keeps its tuner history while it
    animates."""

    def __init__(
        self,
        config: RenderConfig,
        scene: Optional[SceneArrays] = None,
        devices: Optional[Sequence] = None,
        reference_banding: bool = True,
        tuner_seed: int = 0x9E3779B97F4A7C15,
        device="cuda",
    ):
        if devices is None:
            devices = pick_devices(config.chips, render_device(device).type)
        super().__init__(config, scene, devices)
        self.reference_banding = reference_banding
        h = config.height
        # initial split: equal rows, remainder to device 0 (ray_trace.cpp:74-81)
        base = h // self.n
        self.rows: List[int] = [base + (h - base * self.n if i == 0 else 0) for i in range(self.n)]
        self.tuner = make_tuner(h, self.n, tuner_seed)

    def set_camera(self, config: RenderConfig) -> None:
        """Adopt a config with a new camera (the viewer's steering input)."""
        self.config = config
        cam = config_camera(config)
        self.vp = viewport_arrays(cam, config.width, config.height)
        self.skip_tmax = tmax_never_binds(self.scene, cam)

    def _offsets(self) -> List[int]:
        out, acc = [], 0
        for r in self.rows:
            out.append(acc)
            acc += r
        return out

    def render_frame(self, spp: int, number: int = 0):
        """Render one frame over every device; returns (accum [H, W, 3]
        numpy, frame seconds, per-device seconds)."""
        offs = self._offsets()
        busy = [i for i in range(self.n) if self.rows[i] > 0]
        t0 = time.perf_counter()

        def band(j):
            i = busy[j]
            seed_y0 = 0 if self.reference_banding else offs[i]
            acc = yield from self.band_steps(Band(self.devices[i], offs[i], self.rows[i],
                                                  seed_y0), spp, number)
            return acc.cpu().numpy()

        bands, done_s = run_in_turns([self.devices[i] for i in busy], band)
        frame_s = time.perf_counter() - t0
        per_dev = [0.0] * self.n
        for j, i in enumerate(busy):
            per_dev[i] = done_s[j]
        return np.concatenate(bands, axis=0), frame_s, per_dev

    def tune_round(self, spp: int, frames: int = 3, number: int = 0):
        """Render ``frames`` frames, feed the tuner, maybe adopt a new split.
        Returns (accum of the last frame, duration_per_frame, new rows or
        None), the reference's measurement window (ray_trace.cpp:741-776)."""
        total_s = 0.0
        accum = None
        per_dev = [0.0] * self.n
        for _ in range(frames):
            accum, frame_s, pd = self.render_frame(spp, number)
            total_s += frame_s
            per_dev = [a + b for a, b in zip(per_dev, pd)]
        dpf = total_s / frames
        self.tuner.add_frame(list(self.rows), dpf, per_dev)
        new = self.tuner.get_workload()
        if new is not None and any(n_ != o for n_, o in zip(new, self.rows)):
            self.rows = list(new)
        else:
            new = None
        return accum, dpf, new

    def render_u8(self, samples: Optional[int] = None) -> np.ndarray:
        spp = samples or self.config.samples
        accum, _, _ = self.render_frame(spp)
        return imageops.accum_to_u8(accum, spp)
