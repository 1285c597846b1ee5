"""Ray-sphere intersection: the spec forms and the packed sphere table.

Port of ``raytrace_tpu/ops/intersect.py`` (``BIG``, ``sphere_constants``,
``intersect_bruteforce``, ``intersect_matmul``, ``_select_roots``) plus
``sphere_table`` and its column constants from
``raytrace_tpu/ops/pallas_intersect.py``: ``models/grid.build_grid`` reads
the table's f64-precomputed ``kc`` column, the megakernel brute-forces the
table, and the ``pallas`` backend's kernel (ops/pallas_intersect.py) fetches
the winner's attribute columns from it.

Math matches calculateIntersections (shader.rint:44-60): half-b quadratic,
report t1 if in [tMin, tMax] else t2; closest hit is an argmin over spheres
(lowest index wins ties).  Two algebraic forms:

- ``intersect_bruteforce``: the direct ``oc = o - c`` form in the oracle's
  op order (materializes [N, S, 3]);
- ``intersect_matmul``: the expanded form, ``c . d`` and ``c . o`` as two
  [N,3] @ [3,S] ``torch.matmul`` products and ``|c|^2 - r^2`` precomputed in
  f64.  The products must run in full fp32 (the JAX code asks for
  ``Precision.HIGHEST``): on a CUDA device it raises if TF32 is allowed.
"""

from __future__ import annotations

import numpy as np
import torch

from . import fp

BIG = np.float32(3.0e38)  # sentinel "no hit" t (finite to keep argmin sane)

# sphere-table columns ([S, 24])
_C_CX, _C_CY, _C_CZ, _C_KC, _C_VALID = 0, 1, 2, 3, 4
_C_ATTR0 = 8  # cols 8..23: center, mat, tex, c0.rgb, c1.rgb, fuzz (16 cols)

# attribute columns (offsets into cols 8..23 / rows of the transposed atab)
A_CX, A_CY, A_CZ = 0, 1, 2
A_MAT, A_TEX = 3, 4
A_C0, A_C1 = 5, 8  # rgb triples
A_ATTR = 11

S_BLOCK = 512  # large tables are padded to a multiple of this many rows


def sphere_constants(centers, radii) -> np.ndarray:
    """|c|^2 - r^2 per sphere, computed in float64 then cast to f32.

    For the ground sphere |c|^2 and r^2 are ~1e6 and their difference is 1.0 —
    the f64 precompute removes the cancellation the reference pays in f32."""
    c64 = np.asarray(centers, np.float64)
    r64 = np.asarray(radii, np.float64)
    return (np.sum(c64 * c64, axis=1) - r64 * r64).astype(np.float32)


def intersect_bruteforce(o, d, centers, radii, valid, tmin, tmax):
    """Direct GLSL-order form. o,d: [N,3]; centers: [S,3]; radii,valid: [S].

    Returns (t [N], idx [N] int64, hit [N] bool)."""
    oc = o[:, None, :] - centers[None, :, :]  # [N,S,3]
    # explicit x+y+z sum order: bit-parity with the CPU oracle's math
    a = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])[:, None]
    b = (oc[:, :, 0] * d[:, None, 0] + oc[:, :, 1] * d[:, None, 1]
         + oc[:, :, 2] * d[:, None, 2])
    c = (oc[:, :, 0] * oc[:, :, 0] + oc[:, :, 1] * oc[:, :, 1]
         + oc[:, :, 2] * oc[:, :, 2] - (radii * radii)[None, :])
    return _select_roots(a, b, c, valid, tmin, tmax, exact_div=True)


def _dot3(u, v):
    return (u[:, 0] * v[:, 0] + u[:, 1] * v[:, 1] + u[:, 2] * v[:, 2])[:, None]


def intersect_matmul(o, d, centers_t, radii_sq_c, valid, tmin, tmax):
    """Expanded form. centers_t: [3,S] (transposed); radii_sq_c: [S] =
    |c|^2 - r^2 (f64 precompute).  b = o.d - c.d; c_term = |o|^2 - 2 o.c +
    (|c|^2 - r^2); a = d.d.  Returns (t [N], idx [N] int64, hit [N] bool)."""
    if o.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "intersect_matmul needs full fp32 products: set "
            "torch.backends.cuda.matmul.allow_tf32 = False (TF32 keeps ~10 "
            "mantissa bits, which puts bounce origins inside the ground sphere)")
    od = _dot3(o, d)  # [N,1]
    oo = _dot3(o, o)
    a = _dot3(d, d)
    cd = torch.matmul(d, centers_t)  # [N,S]
    co = torch.matmul(o, centers_t)
    b = od - cd
    c = oo - 2.0 * co + radii_sq_c[None, :]
    return _select_roots(a, b, c, valid, tmin, tmax)


def _select_roots(a, b, c, valid, tmin, tmax, exact_div=False):
    """Root selection per shader.rint:32-39 + closest-hit argmin.

    ``exact_div=True`` divides by ``a`` like the GLSL; otherwise one
    reciprocal per ray is multiplied in."""
    disc = b * b - a * c
    ok = disc >= 0.0
    sq = fp.sqrt(torch.where(ok, disc, 0.0))
    if exact_div:
        t1 = (-b - sq) / a
        t2 = (-b + sq) / a
    else:
        inv_a = 1.0 / a
        t1 = (-b - sq) * inv_a
        t2 = (-b + sq) * inv_a
    t1_ok = ok & (t1 >= tmin) & (t1 <= tmax)
    t2_ok = ok & (t2 >= tmin) & (t2 <= tmax)
    big = torch.tensor(BIG, dtype=torch.float32, device=a.device)
    t = torch.where(t1_ok, t1, torch.where(t2_ok, t2, big))
    t = torch.where(valid[None, :], t, big)
    t_min = torch.amin(t, dim=1)
    idx = torch.argmin(t, dim=1)  # first minimal index on ties
    return t_min, idx, t_min < big


def sphere_table(scene_arrays) -> np.ndarray:
    """Host-side [S, 24] packed table from a SceneArrays-like object with
    centers/radii/material/texture/color0/color1/attr fields."""
    centers = np.asarray(scene_arrays.centers, np.float32)
    radii = np.asarray(scene_arrays.radii, np.float32)
    s = centers.shape[0]
    if hasattr(scene_arrays, "n_spheres"):
        n = int(scene_arrays.n_spheres)
        valid = (np.arange(s) < n).astype(np.float32)
    else:
        valid = np.asarray(scene_arrays.valid, np.float32)
    c64 = centers.astype(np.float64)
    kc = (np.sum(c64 * c64, axis=1) - radii.astype(np.float64) ** 2).astype(np.float32)
    # padding rows get kc = +3e30: c becomes huge, disc goes hugely negative,
    # sqrt(disc) is NaN and every root comparison fails -> automatic miss
    kc = np.where(valid > 0, kc, np.float32(3e30))
    if s > S_BLOCK and s % S_BLOCK:
        pad = S_BLOCK - s % S_BLOCK
        centers = np.concatenate([centers, np.zeros((pad, 3), np.float32)])
        kc = np.concatenate([kc, np.full((pad,), 3e30, np.float32)])
        valid = np.concatenate([valid, np.zeros((pad,), np.float32)])
        s += pad

        def _padded(a, fill=0.0):
            out = np.full((s,) + np.asarray(a).shape[1:], fill, np.float32)
            out[: s - pad] = np.asarray(a, np.float32)
            return out
    else:
        def _padded(a, fill=0.0):
            return np.asarray(a, np.float32)
    tab = np.zeros((s, 24), np.float32)
    tab[:, _C_CX:_C_CZ + 1] = centers
    tab[:, _C_KC] = kc
    tab[:, _C_VALID] = valid
    tab[:, _C_ATTR0 + A_CX : _C_ATTR0 + A_CZ + 1] = centers
    tab[:, _C_ATTR0 + A_MAT] = _padded(scene_arrays.material)
    tab[:, _C_ATTR0 + A_TEX] = _padded(scene_arrays.texture)
    tab[:, _C_ATTR0 + A_C0 : _C_ATTR0 + A_C0 + 3] = _padded(scene_arrays.color0)
    tab[:, _C_ATTR0 + A_C1 : _C_ATTR0 + A_C1 + 3] = _padded(scene_arrays.color1)
    tab[:, _C_ATTR0 + A_ATTR] = _padded(scene_arrays.attr)
    return tab


def sphere_table_device(scene_arrays):
    """``sphere_table`` with torch ops on the device of a SceneArrays of
    tensors (``n_spheres`` a host int): (the same [S', 24] table, the
    scene's unpadded, unmasked ``sphere_constants`` [S]), bit for bit.  kc is
    summed in float64 as numpy sums three terms, ((x*x + y*y) + z*z) - r*r,
    and then rounded to float32."""
    centers, radii = scene_arrays.centers, scene_arrays.radii
    s, dev = centers.shape[0], centers.device
    valid = (torch.arange(s, device=dev) < int(scene_arrays.n_spheres)).to(torch.float32)
    c64, r64 = centers.to(torch.float64), radii.to(torch.float64)
    kc_all = ((c64[:, 0] * c64[:, 0] + c64[:, 1] * c64[:, 1]) + c64[:, 2] * c64[:, 2]
              - r64 * r64).to(torch.float32)
    pad = S_BLOCK - s % S_BLOCK if s > S_BLOCK and s % S_BLOCK else 0
    tab = torch.zeros((s + pad, 24), dtype=torch.float32, device=dev)
    tab[s:, _C_KC] = 3e30
    tab[:s, _C_CX:_C_CZ + 1] = centers
    tab[:s, _C_KC] = torch.where(valid > 0, kc_all, torch.full_like(kc_all, 3e30))
    tab[:s, _C_VALID] = valid
    tab[:s, _C_ATTR0 + A_CX : _C_ATTR0 + A_CZ + 1] = centers
    tab[:s, _C_ATTR0 + A_MAT] = scene_arrays.material.to(torch.float32)
    tab[:s, _C_ATTR0 + A_TEX] = scene_arrays.texture.to(torch.float32)
    tab[:s, _C_ATTR0 + A_C0 : _C_ATTR0 + A_C0 + 3] = scene_arrays.color0
    tab[:s, _C_ATTR0 + A_C1 : _C_ATTR0 + A_C1 + 3] = scene_arrays.color1
    tab[:s, _C_ATTR0 + A_ATTR] = scene_arrays.attr
    return tab, kc_all
