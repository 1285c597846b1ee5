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

from typing import NamedTuple

import numpy as np

from ..ops import launches
from .mt19937 import MT19937, canonical_float, uniform_float

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


# getRandomColor's HSV (scene.h:47-77): s = 0.75, v = 0.45, in float32
_HSV_C = np.float32(0.75) * np.float32(0.45)
_HSV_M = np.float32(0.45) - _HSV_C

# the material draw's thresholds (scene.h:129-149) rounded to float32: numpy
# compares a float32 draw with the literal 0.7 in float32, as the JAX
# package's scene does
_P_DIFFUSE = float(np.float32(0.7))
_P_METAL = float(np.float32(0.85))

# engine words a small sphere draws, by material: z, x and the material
# draw, then a diffuse sphere's hue or a metal sphere's b, g, r
_WORDS = {DIFFUSE: 4, METAL: 6, REFRACTIVE: 3}

_GRID_SPHERES = 22 * 22

# getRandomColor's six hue sectors of 60 degrees: each picks r, g, b from
# (c, x, 0) (scene.h:56-73)
_SECTOR_RGB = np.array([[0, 1, 2], [1, 0, 2], [2, 0, 1], [2, 1, 0], [1, 2, 0], [0, 2, 1]])


def _random_colors(hue: np.ndarray) -> np.ndarray:
    """getRandomColor (scene.h:47-77) of each hue draw (``uniform_float`` of
    [0, 360)): h = floor(hue), HSV(h, 0.75, 0.45) -> RGB rows, float32."""
    h = np.floor(hue)
    c = _HSV_C
    # whole chain in f32 like the reference (scene.h:52) — a float64
    # intermediate could double-round 1 ulp off
    x = c * (np.float32(1.0) - np.abs(np.fmod(h / np.float32(60.0), np.float32(2.0))
                                      - np.float32(1.0)))
    cx0 = np.stack([np.full_like(h, c), x, np.zeros_like(h)], axis=1)
    sector = _SECTOR_RGB[(h // np.float32(60.0)).astype(np.intp)]
    return np.take_along_axis(cx0, sector, axis=1) + _HSV_M


def generate_random_scene(t: float = 0.0) -> SceneArrays:
    """Reference-exact final book scene; 488 spheres (scene.h:79-157).

    ``t`` is the animation time in seconds (reference: wall clock, scene.h:82-83).
    """
    with launches.span("scene.generate") as rec:
        scene, draws = _book_scene(t)
        rec.set(n_spheres=int(scene.n_spheres), draws=draws)
    return scene


def _book_scene(t: float) -> tuple[SceneArrays, int]:
    """The book scene at time ``t``, and the engine words its layout drew."""
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

    # 22x22 grid of small spheres — scene.h:118-153.  One block of engine
    # words covers the most a layout can draw (six a sphere); the words past
    # the layout's end are never read.
    engine = MT19937()  # std::mt19937 engine{} — default seed, scene.h:120
    u = canonical_float(engine.draw(6 * _GRID_SPHERES))
    u01 = uniform_float(u)
    # A sphere's material draw decides how many words it takes, so its
    # first word is found by walking the spheres in order.
    p = u01.tolist()
    first, mats, k = [], [], 0
    for _ in range(_GRID_SPHERES):
        pk = p[k + 2]
        m = DIFFUSE if pk < _P_DIFFUSE else METAL if pk < _P_METAL else REFRACTIVE
        first.append(k)
        mats.append(m)
        k += _WORDS[m]
    draws = k
    k = np.array(first)
    mat = np.array(mats, np.int32)
    i = np.arange(_GRID_SPHERES)
    a = (i // 22 - 11).astype(np.float32)
    b = (i % 22 - 11).astype(np.float32)
    grid = slice(4, 4 + _GRID_SPHERES)
    # The center draws sit inside glm::vec4's ARGUMENT LIST (scene.h:124-125)
    # and C++ argument evaluation order is unspecified; g++ (which builds the
    # reference on Linux) evaluates right-to-left at every -O level, so the
    # FIRST engine draw lands in the z component and the second in x.  Pinned
    # byte-for-byte against a compiled probe in
    # tests/test_scene_layout_probe.py.
    centers[grid, 0] = a + np.float32(0.9) * u01[k + 1]
    centers[grid, 1] = 0.2
    centers[grid, 2] = b + np.float32(0.9) * u01[k]
    radii[grid] = 0.2
    material[grid] = mat
    col = np.ones((_GRID_SPHERES, 3), np.float32)  # glass: (1, 1, 1)
    diffuse, metal = mat == DIFFUSE, mat == METAL
    col[diffuse] = _random_colors(uniform_float(u[k[diffuse] + 3], 0.0, 360.0))
    # same right-to-left argument order (scene.h:135-136): draws land in
    # b, g, r
    col[metal] = uniform_float(u[k[metal][:, None] + [5, 4, 3]], 0.5, 1.0)
    color0[grid] = col
    attr[grid][mat == REFRACTIVE] = 1.5

    return SceneArrays(
        centers=centers,
        radii=radii,
        material=material,
        texture=texture,
        color0=color0,
        color1=color1,
        attr=attr,
        n_spheres=np.int32(4 + _GRID_SPHERES),
    ), draws


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
    with launches.span("scene.generate", n_spheres=count + 4) as rec:
        scene, draws = _sphere_field(count, seed, extent, t, y_range)
        rec.set(draws=draws)
    return scene


def _sphere_field(count, seed, extent, t, y_range) -> tuple[SceneArrays, int]:
    n = count + 4
    s = max(128, -(-n // 128) * 128)
    rng = np.random.default_rng(seed)
    base, draws = _book_scene(t)
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
    return sc, draws


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
