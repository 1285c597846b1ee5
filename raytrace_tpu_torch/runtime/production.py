"""Composed production loop — the reference's actual operating mode.

Port of ``raytrace_tpu/runtime/production.py``.  The reference runs
everything in one loop (ray_trace.cpp:579-776): the scene animates with wall
time (:665), every GPU renders its row band and presents it in its own
window (window.hpp:47-54 tiles them), and the workload tuner's measurement
windows re-split the rows between frames (:741-776).  ``ProductionLoop``
composes the port's ``FrameLoop`` animation, ``LiveViewer`` presentation and
camera input, and ``HeteroRenderer`` per-device bands and ``tune_round`` in
one process serving an animated, tuned, multi-device render over HTTP.

It subclasses ``LiveViewer`` (same server, endpoints and camera plumbing)
and replaces the progressive loop with the reference's frame loop:

  per frame: scene <- generate_random_scene(t)      (ray_trace.cpp:665)
             every device renders its band          (:667-707)
             present                                 (window.hpp:47-54)
             feed tuner, adopt any new row split     (:741-776)

Camera input (POST /camera) applies at the next frame boundary.
``animate=False`` pins the scene to ``config.scene_time`` (still tuned and
multi-device).  ``devices`` goes to ``HeteroRenderer`` (None: ``config.chips``
devices of ``device``'s type).

The /state JSON adds ``duration_per_frame`` (the reference's only metric,
ray_trace.cpp:745), ``rows`` (the live band split) and ``resplits`` (tuner
adoptions so far).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

from ..config import RenderConfig
from .viewer import LiveViewer


class ProductionLoop(LiveViewer):
    """Animated + tuned + multi-device live render behind one HTTP server."""

    def __init__(self, config: RenderConfig, scene=None, port: int = 8000,
                 host: str = "127.0.0.1", devices: Optional[Sequence] = None,
                 animate: bool = True, time_fn=None, device="cuda"):
        super().__init__(config, scene=scene, port=port, host=host, device=device)
        self.devices = devices
        self.animate = animate
        self.time_fn = time_fn if time_fn is not None else time.monotonic
        self._state.update(duration_per_frame=None, rows=None, resplits=0)
        self.renderer = None  # the HeteroRenderer, built in render_loop

    def render_loop(self, max_frames: Optional[int] = None) -> None:
        from ..models.scene import generate_random_scene
        from ..parallel.hetero import HeteroRenderer

        cfg = self.config
        hr = HeteroRenderer(cfg, scene=self.scene, devices=self.devices,
                            device=self.device)
        self.renderer = hr
        frames = 0
        resplits = 0
        t_origin = self.time_fn()
        while not self._stop.is_set():
            with self._lock:
                cam = self._new_camera
                self._new_camera = None
                self._state["frame"] = frames
            self._camera_changed.clear()
            if cam is not None:
                cfg = dataclasses.replace(cfg, camera_pos=cam[0],
                                          camera_dir=cam[1])
                hr.set_camera(cfg)
            if self.animate:
                # scene time = seconds since loop start (ray_trace.cpp:665
                # semantics: the hero sphere rides wall time)
                hr.set_scene(generate_random_scene(self.time_fn() - t_origin))
            # one frame = one measurement window entry: render all bands,
            # feed the tuner, adopt any re-split (ray_trace.cpp:741-776)
            accum, dpf, new_rows = hr.tune_round(cfg.samples, frames=1)
            if new_rows is not None:
                resplits += 1
            self._publish(accum, cfg.samples)
            with self._lock:
                self._state["duration_per_frame"] = dpf
                self._state["rows"] = list(hr.rows)
                self._state["resplits"] = resplits
            frames += 1
            if max_frames is not None and frames >= max_frames:
                return
