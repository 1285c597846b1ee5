"""Straight-line CPU oracle: reference math for golden tests.

Port copy of ``raytrace_tpu/oracle/cpu_reference.py`` (numpy only, the same
float32 op order line for line; the port never imports the JAX package).  A
deliberately un-vectorized (per pixel, per sample, per bounce) numpy
implementation of the reference GPU kernels, mirroring the GLSL control flow
in float32 with the exact TEA+LCG RNG stream (``rng_np.py``):

- ray generation + bounce loop: reference shaders/shader.rgen:39-115
- ray-sphere intersection:      reference shaders/shader.rint:22-60
- closest-hit shading:          reference shaders/shader.rchit:38-133
- miss (constant sky):          reference shaders/shader.rmiss:13-18
- RNG:                          reference shaders/random.glsl

The port's spec path (``bruteforce``) is held near-bitwise against it, and
it writes goldens at any size (``tests/data`` holds the stored ones).  Only
the per-sphere loop is vectorized (numpy over the sphere axis), matching
"test all candidates, keep closest t".
"""

from __future__ import annotations

import numpy as np

from ..config import MAX_DEPTH, MAX_RAY_COLLISION_DISTANCE, T_MIN, RenderCallInfo
from ..models.camera import calculate_viewport
from ..models.scene import SceneArrays, CHECKERED, DIFFUSE, METAL, REFRACTIVE
from . import rng_np as rngops

F = np.float32
SKY_COLOR = np.array([0.7, 0.8, 1.0], np.float32)  # shader.rmiss:15


def _normalize(v):
    # explicit x+y+z order to match the vectorized kernels bit-for-bit
    return v / np.float32(np.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]))


def _closest_hit(scene: SceneArrays, o, d, tmin, tmax):
    """Closest intersection over all spheres (shader.rint:44-60 + HW closest).

    Returns (sphere_index, t) or (-1, inf).
    """
    n = int(scene.n_spheres)
    centers = scene.centers[:n]
    radii = scene.radii[:n]
    oc = o[None, :] - centers  # [n,3]
    a = F(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    b = oc[:, 0] * d[0] + oc[:, 1] * d[1] + oc[:, 2] * d[2]  # [n]
    c = oc[:, 0] * oc[:, 0] + oc[:, 1] * oc[:, 1] + oc[:, 2] * oc[:, 2] - radii * radii
    disc = b * b - a * c
    ok = disc >= 0
    sq = np.sqrt(np.where(ok, disc, F(0)))
    t1 = (-b - sq) / a
    t2 = (-b + sq) / a
    t1_ok = ok & (t1 >= tmin) & (t1 <= tmax)
    t2_ok = ok & (t2 >= tmin) & (t2 <= tmax)
    t = np.where(t1_ok, t1, np.where(t2_ok, t2, F(np.inf)))
    i = int(np.argmin(t))
    if not np.isfinite(t[i]):
        return -1, F(np.inf)
    return i, t[i]


def _texture_color(scene: SceneArrays, i, point):
    """getTextureColor, shader.rchit:53-64."""
    if scene.texture[i] == CHECKERED:
        size = F(6.0)
        sines = np.sin(size * point[0]) * np.sin(size * point[1]) * np.sin(size * point[2])
        return scene.color0[i] if sines > 0 else scene.color1[i]
    return scene.color0[i]


def _scatter(scene: SceneArrays, i, d, normal, front_face, seed):
    """getScatterDirection, shader.rchit:102-116. Returns (seed, dir|None)."""
    mat = scene.material[i]
    if mat == DIFFUSE:
        # shader.rchit:68-76
        seed, ux, uy, uz = rngops.random_unit_vector(seed)
        sd = normal + np.array([ux, uy, uz], np.float32)
        if abs(sd[0]) < 1e-8 and abs(sd[1]) < 1e-8 and abs(sd[2]) < 1e-8:
            sd = normal
        return seed, sd
    if mat == METAL:
        # shader.rchit:78-89; GLSL reflect(I, N) = I - 2 dot(N, I) N
        refl = d - F(2.0) * np.dot(normal, d) * normal
        seed, ux, uy, uz = rngops.random_unit_vector(seed)
        fuzz = scene.attr[i] * np.array([ux, uy, uz], np.float32)
        sd = _normalize(refl + fuzz)
        if np.dot(sd, normal) > 0:
            return seed, sd
        return seed, None  # absorbed -> vec3(0) -> doesScatter false
    if mat == REFRACTIVE:
        # shader.rchit:91-100; && short-circuits, so the reflectance draw
        # only happens when canRefract is true.
        eta = F(1.0) / scene.attr[i] if front_face else scene.attr[i]
        cos_theta = np.dot(-d, normal)
        can_refract = eta * np.sqrt(F(1.0) - cos_theta * cos_theta) <= F(1.0)
        does_refract = False
        if can_refract:
            r0 = ((F(1.0) - eta) / (F(1.0) + eta)) ** 2
            reflectance = r0 + (F(1.0) - r0) * (F(1.0) - np.dot(-d, normal)) ** 5
            seed, rand = rngops.random_float(seed)
            does_refract = reflectance < rand
        if does_refract:
            # GLSL refract(I, N, eta)
            ndi = np.dot(normal, d)
            k = F(1.0) - eta * eta * (F(1.0) - ndi * ndi)
            return seed, eta * d - (eta * ndi + np.sqrt(max(k, F(0.0)))) * normal
        return seed, d - F(2.0) * np.dot(normal, d) * normal
    return seed, None


def _ray_color(scene: SceneArrays, o, d, seed, max_depth, rr=None):
    """calculateRayColor, shader.rgen:70-89. Returns (seed, rgb).

    ``rr=(d0, d1, pmin)`` enables the fast mode's Russian-roulette path
    termination with the exact f32 op order of the kernels
    (gridkernel._iterate) so fast-mode backends validate near-bitwise
    against this oracle just like exact mode does; ``rr=None`` is the
    reference GLSL stream."""
    reflected = np.ones(3, np.float32)
    light = np.zeros(3, np.float32)
    for _depth in range(max_depth):
        i, t = _closest_hit(scene, o, d, F(T_MIN), F(MAX_RAY_COLLISION_DISTANCE))
        if i < 0:
            light = SKY_COLOR
            break
        point = o + t * d  # shader.rint:33
        # shader.rchit:41-43
        outward = _normalize(point - scene.centers[i])
        front_face = np.dot(d, outward) < 0
        normal = outward if front_face else -outward
        attenuation = _texture_color(scene, i, point)
        seed, sd = _scatter(scene, i, d, normal, front_face, seed)
        if sd is None:  # doesScatter == false on a hit: light = attenuation
            light = attenuation
            break
        reflected = reflected * attenuation
        o = point
        d = _normalize(sd).astype(np.float32)
        # RR applies only to paths that would CONTINUE (depth+1 < max_depth)
        # — the kernels' `considered = cont_b & ...` gate; a depth-capped
        # path consumes no RR draw there, so none here either.
        if rr is not None and _depth + 1 >= rr[0] and _depth + 1 < max_depth:
            d0, d1, pmin = rr
            p = np.minimum(F(1.0), np.maximum(
                F(pmin), np.maximum(reflected[0],
                                    np.maximum(reflected[1], reflected[2]))))
            if d1 and _depth + 1 >= d1:
                p = p * F(0.5)
            seed, u = rngops.random_float(seed)
            if u >= p:
                return seed, reflected * light  # killed: light stays 0
            reflected = (reflected / p).astype(np.float32)
    return seed, reflected * light


def render_oracle(scene: SceneArrays, info: RenderCallInfo, max_depth: int = MAX_DEPTH,
                  band_height: int | None = None, accum_dtype=np.float64,
                  rr=None):
    """Render a band with the straight-line oracle (shader.rgen:39-67).

    Returns the *accumulated* color sum [h, w, 3] (pre-gamma); divide by spp
    and sqrt for the display image.  ``accum_dtype=float64`` mirrors the
    reference's dvec3 accumulator (quirk Q5).
    """
    width, height = info.image_size
    off_x, off_y = info.offset
    h = band_height if band_height is not None else height
    spp = info.samples_per_render_call
    viewport = calculate_viewport(info.camera, F(width) / F(height))
    size = np.array([width, height], np.float32)

    accum = np.zeros((h, width, 3), accum_dtype)
    with np.errstate(over="ignore"):
        for py in range(h):
            for px in range(width):
                seed = rngops.tea_hash(
                    rngops.tea_hash(np.uint32(px), np.uint32(py)), np.uint32(info.number)
                )
                total = np.zeros(3, accum_dtype)
                for _s in range(spp):
                    # shader.rgen:57 — uv from band-global offset + jitter
                    seed, jx = rngops.random_float(seed)
                    seed, jy = rngops.random_float(seed)
                    u = (F(off_x + px) + jx) / size[0]
                    v = (F(off_y + py) + jy) / size[1]
                    # getCameraRay, shader.rgen:107-115 (2 draws even at aperture 0)
                    seed, r1 = rngops.random_in_interval(seed, -1.0, 1.0)
                    seed, r2 = rngops.random_in_interval(seed, -1.0, 1.0)
                    ap = viewport.aperture / F(2.0)
                    l = np.sqrt(r1 * r1 + r2 * r2)
                    ox = ap * (r1 / l)
                    oy = ap * (r2 / l)
                    offset3 = viewport.camera_right * ox + viewport.camera_up * oy
                    frm = viewport.look_from + offset3
                    to = (viewport.upper_left_corner + viewport.horizontal * u
                          - viewport.vertical * v)
                    d = _normalize((to - frm).astype(np.float32))
                    seed, color = _ray_color(scene, frm.astype(np.float32), d, seed, max_depth,
                                             rr=rr)
                    total += color.astype(accum_dtype)
                accum[py, px] = total
    return accum
