"""Camera and viewport math, mirroring the reference ray-gen shader.

Reference: ``Camera``/``Viewport`` structs (reference shaders/structs.glsl:15-30),
``calculateViewport`` (reference shaders/shader.rgen:92-105) and the baked
camera constants fov=25deg, aperture=0, focusDistance=10, up=+Y
(shader.rgen:29).  The look-from/look-at come from the uniform each call:
``camera_pos=(13,11,-3)``, ``camera_dir=(-13,-11,3)``
(reference src/ray_trace.cpp:669-670), i.e. the camera looks at the origin.

In the reference the viewport is recomputed per pixel inside the shader; it is
pixel-independent, so here it is precomputed once on the host in float32 and
shipped to the kernel as constants (TPU-first: hoist uniform work out of the
hot loop).  Per-ray generation (``getCameraRay``, shader.rgen:107-115) lives in
``ops/trace.py`` where it is vectorized over slots.

Port copy of ``raytrace_tpu/models/camera.py``, byte-for-byte in behaviour
(numpy only): the port never imports the JAX package, whose ``__init__``
imports jax.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Camera:
    """Mirror of the GLSL Camera struct (structs.glsl:15-22)."""

    fov: float = 25.0  # degrees, shader.rgen:29
    aperture: float = 0.0
    focus_distance: float = 10.0
    look_from: tuple = (13.0, 11.0, -3.0)  # ray_trace.cpp:669
    look_at: tuple = (0.0, 0.0, 0.0)  # pos + dir = origin, ray_trace.cpp:670
    up: tuple = (0.0, 1.0, 0.0)


@dataclasses.dataclass(frozen=True)
class Viewport:
    """Mirror of the GLSL Viewport struct (structs.glsl:24-30); f32 numpy vecs."""

    horizontal: np.ndarray
    vertical: np.ndarray
    upper_left_corner: np.ndarray
    camera_up: np.ndarray
    camera_right: np.ndarray
    look_from: np.ndarray
    aperture: np.float32


def _normalize(v: np.ndarray) -> np.ndarray:
    return (v / np.sqrt(np.sum(v * v))).astype(np.float32)


def calculate_viewport(camera: Camera, aspect_ratio: float) -> Viewport:
    """calculateViewport, shader.rgen:92-105, in float32."""
    f32 = np.float32
    look_from = np.asarray(camera.look_from, np.float32)
    look_at = np.asarray(camera.look_at, np.float32)
    up = np.asarray(camera.up, np.float32)

    viewport_height = f32(np.tan(np.radians(f32(camera.fov)) / f32(2.0)) * f32(2.0))
    viewport_width = f32(f32(aspect_ratio) * viewport_height)

    forward = _normalize(look_at - look_from)
    right = _normalize(np.cross(up, forward).astype(np.float32))
    cam_up = _normalize(np.cross(forward, right).astype(np.float32))

    focus = f32(camera.focus_distance)
    horizontal = (viewport_width * right * focus).astype(np.float32)
    vertical = (viewport_height * cam_up * focus).astype(np.float32)
    upper_left = (
        look_from - horizontal / f32(2.0) + vertical / f32(2.0) + forward * focus
    ).astype(np.float32)

    return Viewport(
        horizontal=horizontal,
        vertical=vertical,
        upper_left_corner=upper_left,
        camera_up=cam_up,
        camera_right=right,
        look_from=look_from,
        aperture=f32(camera.aperture),
    )
