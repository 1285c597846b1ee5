"""Scene generators of the benchmark's configurations, frozen.

The *Ray Tracing in One Weekend* final scene as the reference renderer
builds it (src/scene.h:79-157): the ground, three hero spheres whose z
follows the animation time, and a 22x22 grid of small spheres laid out by a
default-seeded ``std::mt19937`` with libstdc++'s float distribution; and the
dense field of the benchmark's 100k-sphere configuration: the same ground
and heroes plus ``count`` small spheres drawn with numpy's ``default_rng``.
Only the valid spheres are kept (no padding rows).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

DIFFUSE, METAL, REFRACTIVE = 0, 1, 2  # scene.h:5-9
SOLID, CHECKERED = 0, 1  # scene.h:11-14

_F = np.float32


class Scene(NamedTuple):
    centers: np.ndarray  # [n, 3] f32
    radii: np.ndarray  # [n] f32
    material: np.ndarray  # [n] i32
    texture: np.ndarray  # [n] i32
    color0: np.ndarray  # [n, 3] f32
    color1: np.ndarray  # [n, 3] f32
    attr: np.ndarray  # [n] f32: metal fuzz or refractive index


class _MT19937:
    """std::mt19937 with its default seed 5489."""

    def __init__(self, seed: int = 5489):
        self.mt = [0] * 624
        self.i = 624
        self.mt[0] = seed
        for k in range(1, 624):
            prev = self.mt[k - 1]
            self.mt[k] = (1812433253 * (prev ^ (prev >> 30)) + k) & 0xFFFFFFFF

    def next_u32(self) -> int:
        mt = self.mt
        if self.i >= 624:
            for k in range(624):
                y = (mt[k] & 0x80000000) | (mt[(k + 1) % 624] & 0x7FFFFFFF)
                mt[k] = mt[(k + 397) % 624] ^ (y >> 1) ^ (0x9908B0DF if y & 1 else 0)
            self.i = 0
        y = mt[self.i]
        self.i += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        return y & 0xFFFFFFFF

    def uniform(self, lo: float = 0.0, hi: float = 1.0) -> np.float32:
        """uniform_real_distribution<float>: generate_canonical<float, 24>
        of one draw (float(x) / 2^32, clamped below 1), scaled in f32."""
        r = _F(_F(self.next_u32()) / _F(4294967296.0))
        if r >= _F(1.0):
            r = _F(np.nextafter(_F(1.0), _F(0.0)))
        return _F(r * (_F(hi) - _F(lo)) + _F(lo))


def _hsv_color(engine: _MT19937) -> tuple:
    """getRandomColor (scene.h:47-77): h drawn, s = 0.75, v = 0.45, in f32."""
    h = _F(math.floor(engine.uniform(0.0, 360.0)))
    c = _F(0.75) * _F(0.45)
    x = c * (_F(1.0) - np.abs(np.fmod(h / _F(60.0), _F(2.0)) - _F(1.0)))
    m = _F(0.45) - c
    z = _F(0)
    sector = [(c, x, z), (x, c, z), (z, c, x), (z, x, c), (x, z, c), (c, z, x)]
    r, g, b = sector[min(int(h // 60), 5)]
    return (r + m, g + m, b + m)


def _heroes(t: float) -> list:
    """Ground and the three hero spheres (scene.h:85-116):
    (center, radius, material, texture, color0, color1, attr)."""
    t32 = _F(t)
    grey, white = (0.05, 0.05, 0.05), (0.95, 0.95, 0.95)
    zero = (0.0, 0.0, 0.0)
    return [
        ((0.0, -1000.0, 1.0), 1000.0, DIFFUSE, CHECKERED, grey, white, 0.0),
        ((-4.0, 1.0, np.cos(_F(2.0) * t32)), 1.0, DIFFUSE, SOLID, (0.6, 0.3, 0.1), zero, 0.0),
        ((4.0, 1.0, np.cos(_F(3.0) * t32)), 1.0, METAL, SOLID, (0.8, 0.8, 0.8), zero, 0.0),
        ((0.0, 1.0, np.cos(t32)), 1.0, REFRACTIVE, SOLID, (1.0, 1.0, 1.0), zero, 1.5),
    ]


def _pack(rows: list) -> Scene:
    cols = list(zip(*rows))
    return Scene(centers=np.array(cols[0], _F), radii=np.array(cols[1], _F),
                 material=np.array(cols[2], np.int32), texture=np.array(cols[3], np.int32),
                 color0=np.array(cols[4], _F), color1=np.array(cols[5], _F),
                 attr=np.array(cols[6], _F))


def book_scene(t: float = 0.0) -> Scene:
    """The final scene at animation time ``t``: 488 spheres."""
    rows = _heroes(t)
    engine = _MT19937()
    zero = (0.0, 0.0, 0.0)
    for a in range(-11, 11):
        for b in range(-11, 11):
            # the reference's vec4 argument list is evaluated right to left
            # by g++: the first draw is z, the second x (scene.h:124-125)
            cz = _F(b) + _F(0.9) * engine.uniform()
            cx = _F(a) + _F(0.9) * engine.uniform()
            p = engine.uniform()
            if p < 0.7:
                rows.append(((cx, 0.2, cz), 0.2, DIFFUSE, SOLID, _hsv_color(engine), zero, 0.0))
            elif p < 0.85:
                cb = engine.uniform(0.5, 1.0)  # right to left again: b, g, r
                cg = engine.uniform(0.5, 1.0)
                cr = engine.uniform(0.5, 1.0)
                rows.append(((cx, 0.2, cz), 0.2, METAL, SOLID, (cr, cg, cb), zero, 0.0))
            else:
                rows.append(((cx, 0.2, cz), 0.2, REFRACTIVE, SOLID, (1.0, 1.0, 1.0), zero, 1.5))
    return _pack(rows)


def sphere_field(count: int, seed: int, extent: float = 50.0, t: float = 0.0) -> Scene:
    """The ground and heroes of ``book_scene(t)`` and ``count`` spheres of
    radius 0.2 at y = 0.2, uniform over [-extent, extent]^2 in x and z,
    70% diffuse, 15% metal, 15% glass, drawn from ``default_rng(seed)`` in
    this order: x, z, the material draw, the colours, the metal colours."""
    rng = np.random.default_rng(seed)
    head = _pack(_heroes(t))
    k = count
    centers = np.zeros((k, 3), _F)
    centers[:, 0] = rng.uniform(-extent, extent, k)
    centers[:, 1] = 0.2
    centers[:, 2] = rng.uniform(-extent, extent, k)
    p = rng.uniform(0, 1, k)
    mat = np.where(p < 0.7, DIFFUSE, np.where(p < 0.85, METAL, REFRACTIVE)).astype(np.int32)
    cols = rng.uniform(0.1, 0.9, (k, 3)).astype(_F)
    cols[mat == METAL] = rng.uniform(0.5, 1.0, (int((mat == METAL).sum()), 3))
    cols[mat == REFRACTIVE] = 1.0
    return Scene(
        centers=np.concatenate([head.centers, centers]),
        radii=np.concatenate([head.radii, np.full(k, 0.2, _F)]),
        material=np.concatenate([head.material, mat]),
        texture=np.concatenate([head.texture, np.zeros(k, np.int32)]),
        color0=np.concatenate([head.color0, cols]),
        color1=np.concatenate([head.color1, np.zeros((k, 3), _F)]),
        attr=np.concatenate([head.attr, np.where(mat == REFRACTIVE, 1.5, 0.0).astype(_F)]),
    )


def make_scene(spec: dict, t: float) -> Scene:
    """The scene a configuration's ``scene`` block names: ``book`` at time
    ``t``, or ``sphere_field`` of ``count`` spheres laid out from its
    ``seed``."""
    kind = spec["kind"]
    if kind == "book":
        return book_scene(t)
    if kind == "sphere_field":
        return sphere_field(int(spec["count"]), int(spec.get("seed", 0)),
                            float(spec.get("extent", 50.0)), t)
    raise ValueError(f"unknown scene kind {kind!r}")
