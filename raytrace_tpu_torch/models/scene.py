"""Procedural *Ray Tracing in One Weekend* scene, SoA layout for TPU.

Reproduces the reference's ``generateRandomScene`` (reference src/scene.h:79-157)
exactly: the ground sphere, three animated hero spheres, and a 22x22 grid of 484
small spheres laid out by a default-seeded ``std::mt19937`` (70% diffuse / 15%
metal / 15% glass, scene.h:129-149), with the HSV random color formula of
``getRandomColor`` (scene.h:47-77).

Design difference from the reference (TPU-first): the reference stores an
array-of-structs ``Sphere[512]`` uniform (scene.h:16-29) consumed per-primitive
by the intersection/hit shaders.  Here the scene is a struct-of-arrays pytree —
``centers[512,3]``, ``radii[512]``, ... — so ray-vs-all-spheres math vectorizes
over the sphere axis on the VPU/MXU.  MAX_SPHERE_AMOUNT=512 padding is kept so
shapes are static; padded entries have radius 0 and can never be hit.

The reference animates the hero spheres by wall-clock time (scene.h:82-83,
quirk Q8 in SURVEY.md); here the time ``t`` is an explicit parameter so scenes
are reproducible (pass ``time.time()``-derived values for reference behavior).

Port copy of ``raytrace_tpu/models/scene.py``, byte-for-byte in behaviour
(numpy only): the port never imports the JAX package, whose ``__init__``
imports jax.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

from ..ops import launches
from .mt19937 import MT19937, uniform_float

# Material codes — matches MaterialType, reference src/scene.h:5-9
DIFFUSE = 0
METAL = 1
REFRACTIVE = 2

# Texture codes — matches TextureType, reference src/scene.h:11-14
SOLID = 0
CHECKERED = 1

MAX_SPHERE_AMOUNT = 512  # scene.h:24


class SceneArrays(NamedTuple):
    """SoA scene pytree (numpy or jax arrays; all padded to MAX_SPHERE_AMOUNT).

    Fields mirror ``struct Sphere`` (reference src/scene.h:16-22):
    geometry.xyz -> centers, geometry.w -> radii, materialType -> material,
    textureType -> texture, colors[2] -> color0/color1,
    materialSpecificAttribute -> attr (metal fuzz or refractive index).
    """

    centers: np.ndarray  # [S, 3] f32
    radii: np.ndarray  # [S] f32
    material: np.ndarray  # [S] i32
    texture: np.ndarray  # [S] i32
    color0: np.ndarray  # [S, 3] f32
    color1: np.ndarray  # [S, 3] f32
    attr: np.ndarray  # [S] f32
    n_spheres: np.ndarray  # [] i32 — sphereAmount, scene.h:28


def get_random_color(engine: MT19937) -> np.ndarray:
    """HSV(random h, s=0.75, v=0.45) -> RGB, scene.h:47-77. One engine draw."""
    h = np.float32(math.floor(uniform_float(engine, 0.0, 360.0)))
    s = np.float32(0.75)
    v = np.float32(0.45)
    c = s * v
    # whole chain in f32 like the reference (scene.h:52) — a float64
    # intermediate could double-round 1 ulp off
    x = c * (
        np.float32(1.0)
        - np.abs(np.fmod(h / np.float32(60.0), np.float32(2.0)) - np.float32(1.0))
    )
    m = v - c
    if 0 <= h < 60:
        r, g, b = c, x, np.float32(0)
    elif h < 120:
        r, g, b = x, c, np.float32(0)
    elif h < 180:
        r, g, b = np.float32(0), c, x
    elif h < 240:
        r, g, b = np.float32(0), x, c
    elif h < 300:
        r, g, b = x, np.float32(0), c
    else:
        r, g, b = c, np.float32(0), x
    return np.array([r + m, g + m, b + m], dtype=np.float32)


def generate_random_scene(t: float = 0.0) -> SceneArrays:
    """Reference-exact final book scene; 488 spheres (scene.h:79-157).

    ``t`` is the animation time in seconds (reference: wall clock, scene.h:82-83).
    """
    with launches.span("scene.generate") as rec:
        scene = _book_scene(t)
        rec.set(n_spheres=int(scene.n_spheres))
    return scene


def _book_scene(t: float) -> SceneArrays:
    S = MAX_SPHERE_AMOUNT
    centers = np.zeros((S, 3), np.float32)
    radii = np.zeros((S,), np.float32)
    material = np.zeros((S,), np.int32)
    texture = np.zeros((S,), np.int32)
    color0 = np.zeros((S, 3), np.float32)
    color1 = np.zeros((S, 3), np.float32)
    attr = np.zeros((S,), np.float32)

    t32 = np.float32(t)

    # Ground sphere — scene.h:85-91
    centers[0] = (0.0, -1000.0, 1.0)
    radii[0] = 1000.0
    material[0] = DIFFUSE
    texture[0] = CHECKERED
    color0[0] = (0.05, 0.05, 0.05)
    color1[0] = (0.95, 0.95, 0.95)

    # Hero spheres — scene.h:93-116 (z animated by cos of wall-clock time)
    centers[1] = (-4.0, 1.0, np.cos(np.float32(2.0) * t32))
    radii[1] = 1.0
    material[1] = DIFFUSE
    color0[1] = (0.6, 0.3, 0.1)

    centers[2] = (4.0, 1.0, np.cos(np.float32(3.0) * t32))
    radii[2] = 1.0
    material[2] = METAL
    color0[2] = (0.8, 0.8, 0.8)

    centers[3] = (0.0, 1.0, np.cos(t32))
    radii[3] = 1.0
    material[3] = REFRACTIVE
    color0[3] = (1.0, 1.0, 1.0)
    attr[3] = 1.5

    # 22x22 grid of small spheres — scene.h:118-153
    engine = MT19937()  # std::mt19937 engine{} — default seed, scene.h:120
    idx = 4
    for a in range(-11, 11):
        for b in range(-11, 11):
            # The center draws sit inside glm::vec4's ARGUMENT LIST
            # (scene.h:124-125) and C++ argument evaluation order is
            # unspecified; g++ (which builds the reference on Linux)
            # evaluates right-to-left at every -O level, so the FIRST engine
            # draw lands in the z component and the second in x.  Pinned
            # byte-for-byte against a compiled probe in
            # tests/test_scene_layout_probe.py.
            cz = np.float32(b) + np.float32(0.9) * uniform_float(engine)
            cx = np.float32(a) + np.float32(0.9) * uniform_float(engine)
            centers[idx] = (cx, 0.2, cz)
            radii[idx] = 0.2
            p = uniform_float(engine)
            if p < 0.7:
                material[idx] = DIFFUSE
                color0[idx] = get_random_color(engine)
            elif p < 0.85:
                material[idx] = METAL
                # same right-to-left argument order (scene.h:135-136):
                # draws land in b, g, r
                cb_ = uniform_float(engine, 0.5, 1.0)
                cg_ = uniform_float(engine, 0.5, 1.0)
                cr_ = uniform_float(engine, 0.5, 1.0)
                color0[idx] = (cr_, cg_, cb_)
            else:
                material[idx] = REFRACTIVE
                color0[idx] = (1.0, 1.0, 1.0)
                attr[idx] = 1.5
            idx += 1

    return SceneArrays(
        centers=centers,
        radii=radii,
        material=material,
        texture=texture,
        color0=color0,
        color1=color1,
        attr=attr,
        n_spheres=np.int32(idx),
    )


def random_sphere_field(count: int, seed: int = 0, extent: float = 50.0,
                        t: float = 0.0, y_range=None) -> SceneArrays:
    """Procedural N-sphere stretch scene (BASELINE.json config 5).

    Ground + 3 hero spheres as in the book scene, plus ``count`` small
    spheres scattered uniformly over [-extent, extent]^2 with the book's
    70/15/15 material mix.  The sphere table is padded to a multiple of 128
    (Pallas lane-tiling requirement for the transposed attribute table).
    Unlike ``generate_random_scene`` this uses numpy RNG (no reference
    layout to match at these sizes).

    ``y_range=(lo, hi)`` scatters the small spheres' heights uniformly over
    the interval instead of the book's fixed y=0.2 — such scenes exercise
    the grid backend's general 5-value layout (models/grid.py has_cy).
    """
    with launches.span("scene.generate", n_spheres=count + 4):
        return _sphere_field(count, seed, extent, t, y_range)


def _sphere_field(count, seed, extent, t, y_range) -> SceneArrays:
    n = count + 4
    s = max(128, -(-n // 128) * 128)
    rng = np.random.default_rng(seed)
    base = _book_scene(t)
    sc = SceneArrays(
        centers=np.zeros((s, 3), np.float32),
        radii=np.zeros((s,), np.float32),
        material=np.zeros((s,), np.int32),
        texture=np.zeros((s,), np.int32),
        color0=np.zeros((s, 3), np.float32),
        color1=np.zeros((s, 3), np.float32),
        attr=np.zeros((s,), np.float32),
        n_spheres=np.int32(n),
    )
    for arr_dst, arr_src in zip(sc[:7], base[:7]):
        arr_dst[:4] = arr_src[:4]  # ground + heroes
    k = count
    sc.centers[4 : 4 + k, 0] = rng.uniform(-extent, extent, k)
    if y_range is None:
        sc.centers[4 : 4 + k, 1] = 0.2
    else:
        sc.centers[4 : 4 + k, 1] = rng.uniform(y_range[0], y_range[1], k)
    sc.centers[4 : 4 + k, 2] = rng.uniform(-extent, extent, k)
    sc.radii[4 : 4 + k] = 0.2
    p = rng.uniform(0, 1, k)
    mat = np.where(p < 0.7, DIFFUSE, np.where(p < 0.85, METAL, REFRACTIVE))
    sc.material[4 : 4 + k] = mat
    cols = rng.uniform(0.1, 0.9, (k, 3)).astype(np.float32)
    cols[mat == METAL] = rng.uniform(0.5, 1.0, (int((mat == METAL).sum()), 3))
    cols[mat == REFRACTIVE] = 1.0
    sc.color0[4 : 4 + k] = cols
    sc.attr[4 : 4 + k] = np.where(mat == REFRACTIVE, 1.5, 0.0)
    return sc


def three_sphere_scene() -> SceneArrays:
    """Tiny diffuse/metal/glass + ground test scene (BASELINE.json config 1).

    Same hero materials as the book scene, no small-sphere grid — used for fast
    CPU golden tests.
    """
    S = MAX_SPHERE_AMOUNT
    sc = SceneArrays(
        centers=np.zeros((S, 3), np.float32),
        radii=np.zeros((S,), np.float32),
        material=np.zeros((S,), np.int32),
        texture=np.zeros((S,), np.int32),
        color0=np.zeros((S, 3), np.float32),
        color1=np.zeros((S, 3), np.float32),
        attr=np.zeros((S,), np.float32),
        n_spheres=np.int32(4),
    )
    sc.centers[0] = (0.0, -1000.0, 1.0)
    sc.radii[0] = 1000.0
    sc.texture[0] = CHECKERED
    sc.color0[0] = (0.05, 0.05, 0.05)
    sc.color1[0] = (0.95, 0.95, 0.95)
    sc.centers[1] = (-4.0, 1.0, 1.0)
    sc.radii[1] = 1.0
    sc.color0[1] = (0.6, 0.3, 0.1)
    sc.centers[2] = (4.0, 1.0, 1.0)
    sc.radii[2] = 1.0
    sc.material[2] = METAL
    sc.color0[2] = (0.8, 0.8, 0.8)
    sc.centers[3] = (0.0, 1.0, 1.0)
    sc.radii[3] = 1.0
    sc.material[3] = REFRACTIVE
    sc.color0[3] = (1.0, 1.0, 1.0)
    sc.attr[3] = 1.5
    return sc
