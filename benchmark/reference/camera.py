"""The reference camera, frozen: calculateViewport (shaders/shader.rgen:92-105)
in float32 for fov 25 degrees, aperture 0, focus distance 10, up +Y, from
(13, 11, -3) towards the origin (src/ray_trace.cpp:669-670)."""

from __future__ import annotations

import numpy as np

_F = np.float32

LOOK_FROM = (13.0, 11.0, -3.0)
LOOK_AT = (0.0, 0.0, 0.0)


def _unit(v: np.ndarray) -> np.ndarray:
    return (v / np.sqrt(np.sum(v * v))).astype(_F)


def viewport(width: int, height: int, fov: float = 25.0, aperture: float = 0.0,
             focus: float = 10.0, look_from=LOOK_FROM, look_at=LOOK_AT) -> dict:
    """The viewport vectors (f32 numpy) and scalars of one image size."""
    frm = np.asarray(look_from, _F)
    forward = _unit(np.asarray(look_at, _F) - frm)
    right = _unit(np.cross(np.asarray((0.0, 1.0, 0.0), _F), forward).astype(_F))
    up = _unit(np.cross(forward, right).astype(_F))
    vh = _F(np.tan(np.radians(_F(fov)) / _F(2.0)) * _F(2.0))
    vw = _F(_F(_F(width) / _F(height)) * vh)
    horizontal = (vw * right * _F(focus)).astype(_F)
    vertical = (vh * up * _F(focus)).astype(_F)
    upper_left = (frm - horizontal / _F(2.0) + vertical / _F(2.0) + forward * _F(focus)).astype(_F)
    return dict(horizontal=horizontal, vertical=vertical, upper_left=upper_left,
                up=up, right=right, look_from=frm, aperture=_F(aperture),
                width=_F(width), height=_F(height))
