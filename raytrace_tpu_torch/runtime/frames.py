"""Animated frame loop — the reference's interactive rendering mode.

Port of ``raytrace_tpu/runtime/frames.py``.  The reference regenerates the
scene every frame with wall-clock-animated hero spheres (scene.h:82-116,
quirk Q8) and presents each GPU's band in its own window.  Headless here: a
frame loop that advances the animation time, uploads the scene tables every
frame, measures duration_per_frame with the reference's adaptive window
(ray_trace.cpp:86,741-748) and optionally writes numbered PNGs in place of
presentation.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from ..config import RenderConfig
from ..models.scene import generate_random_scene
from ..ops import image as imageops
from .renderer import Renderer


class FrameLoop:
    """Renders animated frames; one Renderer, the scene swapped per frame."""

    def __init__(self, config: RenderConfig, time_fn: Optional[Callable[[], float]] = None,
                 device="cuda"):
        self.config = config
        self.time_fn = time_fn if time_fn is not None else time.monotonic
        self.renderer = Renderer(config, scene=generate_random_scene(0.0), device=device)

    def render_frame(self, t: Optional[float] = None) -> torch.Tensor:
        """One frame at animation time ``t`` (the wall clock if None, like
        the reference).  Returns the accumulated sum [H, W, 3]."""
        t = self.time_fn() if t is None else t
        self.renderer.set_scene(generate_random_scene(t))
        return self.renderer.render_call(self.config.samples)

    def _finish(self, accum) -> None:
        """Block until the frame's device work is done (the completion
        barrier; the JAX loop fetches the frame to the host instead)."""
        if accum.is_cuda:
            torch.cuda.synchronize(accum.device)

    def run(self, frames: int = 0, min_seconds: float = 4.0,
            store_pattern: Optional[str] = None, animate: bool = True):
        """Frame loop with the reference's measurement-window semantics.

        frames=0: adaptive count = (min_seconds + 50 dpf) / dpf, like
        benchmark_frame_count at ray_trace.cpp:86,748.  Only rendering is
        timed (ray_trace.cpp:741-745): the PNG encode and write of
        ``store_pattern.format(i)`` happen outside the measured span.
        Returns (duration_per_frame seconds, frames rendered)."""
        from ..utils.png import write_png

        self._finish(self.render_frame(0.0))  # warm-up
        t0 = time.perf_counter()
        self._finish(self.render_frame(0.0 if not animate else None))
        dpf = time.perf_counter() - t0
        if frames <= 0:
            frames = max(1, min(int((min_seconds + 50.0 * dpf) / max(dpf, 1e-9)), 1000))
        render_time = 0.0
        for i in range(frames):
            t0 = time.perf_counter()
            accum = self.render_frame(0.0 if not animate else None)
            if store_pattern:
                img = imageops.accum_to_u8(accum, self.config.samples).cpu().numpy()
            else:
                self._finish(accum)
            render_time += time.perf_counter() - t0
            if store_pattern:
                write_png(store_pattern.format(i), img)
        dpf = render_time / frames
        print(f"duration_per_frame: {dpf}")
        return dpf, frames
