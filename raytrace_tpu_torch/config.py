"""Render configuration — host mirror of the reference uniform ABI.

Port copy of ``raytrace_tpu/config.py`` (pure Python): ``RenderCallInfo``
mirrors the reference's ``render_call_info.h``; ``RenderConfig`` collects the
CLI-level settings plus the renderer's knobs (sample chunking, backend,
accumulator dtype, exact/fast mode, call merge, balanced lanes, the device
count that ``api.render_image`` splits row bands over).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from .models.camera import Camera


@dataclasses.dataclass(frozen=True)
class RenderCallInfo:
    """One render call's uniform data (render_call_info.h:5-13)."""

    number: int = 0  # progressive call index; reference hard-codes 0 (quirk Q3)
    samples_per_render_call: int = 10
    offset: Tuple[int, int] = (0, 0)  # (x, y) band offset, ray_trace.cpp:667
    image_size: Tuple[int, int] = (1920, 1080)  # (width, height)
    camera_pos: Tuple[float, float, float] = (13.0, 11.0, -3.0)  # ray_trace.cpp:669
    camera_dir: Tuple[float, float, float] = (-13.0, -11.0, 3.0)  # ray_trace.cpp:670

    @property
    def camera(self) -> Camera:
        p = self.camera_pos
        d = self.camera_dir
        return Camera(look_from=p, look_at=(p[0] + d[0], p[1] + d[1], p[2] + d[2]))


# Constants from the ray-gen shader (reference shaders/shader.rgen:26-27)
MAX_RAY_COLLISION_DISTANCE = 10000.0
MAX_DEPTH = 50
T_MIN = 0.001  # traceRayEXT tMin, shader.rgen:75

# Fast-mode Russian-roulette defaults (mode="fast"): start depth, the depth
# past which survival is additionally halved (bounds glass paths whose
# throughput stays ~1), and the survival-probability floor (caps the 1/p
# reweight at 20x).  Unbiased for any values; the same defaults as the JAX
# package so both fast modes draw the same streams.
RR_START_DEPTH = 1
RR_CAP_DEPTH = 16
RR_PMIN = 0.05


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Full-render settings (CLI surface of main.cpp:13-17 + renderer knobs)."""

    samples: int = 10  # --samples, main.cpp:13
    store: bool = False  # --store, main.cpp:14 (PNG out; reference never writes, Q2)
    width: int = 1920  # --width
    height: int = 1080  # --height
    chips: int = 1  # devices to split row bands over (parallel/sharding.py)
    max_depth: int = MAX_DEPTH
    samples_per_call: Optional[int] = None  # None = all in one call (reference Q3)
    calls_per_exec: int = 1  # progressive calls merged into one dispatch (grid)
    backend: str = "auto"  # auto|grid|paged|mega|bruteforce|matmul|pallas
    mode: str = "exact"  # exact|fast.  "exact" reproduces the reference GLSL
    # sample stream bit-for-bit (the test/parity contract).  "fast" is the
    # production mode: Russian-roulette path termination (unbiased — the
    # image statistically matches exact mode; sample values differ).
    rr_params: Optional[Tuple[int, int, float]] = None  # override the
    # (start depth, cap depth, p floor) defaults for mode="fast"
    balance_spp: int = 0  # spp of the cost probe behind the balanced pixel->lane
    # tables (grid; 0 = the strided map)
    scene_time: float = 0.0  # hero-sphere animation time (scene.h:82-83)
    accum_dtype: str = "float32"  # reference uses dvec3 (Q5)
    out_path: str = "render.png"
    pixels_per_lane: Optional[int] = None  # wavefront M (None = auto)
    # camera override (None = the reference frame loop's fixed camera,
    # ray_trace.cpp:669-670 / quirk Q4)
    camera_pos: Optional[Tuple[float, float, float]] = None
    camera_dir: Optional[Tuple[float, float, float]] = None

    @property
    def rr(self) -> Optional[Tuple[int, int, float]]:
        """Kernel-level RR tuple for this config (None in exact mode)."""
        if self.mode == "exact":
            return None
        if self.mode != "fast":
            raise ValueError(f"unknown mode: {self.mode!r} (exact|fast)")
        return self.rr_params or (RR_START_DEPTH, RR_CAP_DEPTH, RR_PMIN)
