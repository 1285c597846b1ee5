"""Branchless material scatter — vectorized closest-hit shading (spec path).

Port of ``raytrace_tpu/ops/materials.py`` (the reference's shader.rchit):
all three material models are evaluated elementwise and the per-slot result
is chosen by material code.

RNG parity: the reference consumes a data-dependent number of LCG draws per
hit (diffuse 3, metal 3, refractive 1-if-canRefract, miss 0).  We draw
speculatively from the carried seed and commit the seed advance that matches
the material actually hit, preserving the exact reference stream.
"""

from __future__ import annotations

import torch

from ..models.scene import CHECKERED, DIFFUSE, METAL, REFRACTIVE
from . import fp
from . import rng as rngops


def _dot(a, b):
    # explicit x+y+z order (bit-parity with the oracle/GLSL evaluation)
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2])[..., None]


def _normalize(v):
    return v / fp.sqrt(_dot(v, v))


def texture_color(point, tex, c0, c1):
    """getTextureColor, shader.rchit:53-64 (3D sine checker, size 6)."""
    sines = (torch.sin(6.0 * point[:, 0]) * torch.sin(6.0 * point[:, 1])
             * torch.sin(6.0 * point[:, 2]))[:, None]
    checker = torch.where(sines > 0.0, c0, c1)
    return torch.where((tex == CHECKERED)[:, None], checker, c0)


def scatter(seed, d, normal, front_face, mat, attr):
    """Vectorized getScatterDirection (shader.rchit:102-116).

    seed [N] u32 (int64), d/normal [N,3] f32 (d normalized), front_face [N]
    bool, mat [N] int, attr [N] f32.  Returns (new_seed, scatter_dir [N,3],
    does_scatter [N]); slots that missed must mask the result externally."""
    seed3, ux, uy, uz = rngops.random_unit_vector(seed)  # diffuse & metal: 3
    seed1, refr_rand = rngops.random_float(seed)  # refractive: 0 or 1
    unit = torch.stack([ux, uy, uz], dim=-1)

    # DIFFUSE — shader.rchit:68-76
    sd_diffuse = normal + unit
    near_zero = torch.all(torch.abs(sd_diffuse) < 1e-8, dim=-1, keepdim=True)
    sd_diffuse = torch.where(near_zero, normal, sd_diffuse)

    # METAL — shader.rchit:78-89; reflect(I,N) = I - 2 dot(N,I) N
    refl = d - 2.0 * _dot(normal, d) * normal
    sd_metal = _normalize(refl + attr[:, None] * unit)
    metal_scatters = (_dot(sd_metal, normal) > 0.0)[:, 0]

    # REFRACTIVE — shader.rchit:91-100.  canRefract computes sqrt(1 - cos^2)
    # WITHOUT clamping: a NaN sqrt makes the <= false, exactly like GLSL/IEEE
    # — clamping would change the draw-count stream.
    eta = torch.where(front_face, 1.0 / attr, attr)[:, None]
    cos_theta = _dot(-d, normal)
    can_refract = (eta * fp.sqrt(1.0 - cos_theta * cos_theta)) <= 1.0
    q = (1.0 - eta) / (1.0 + eta)
    r0 = q * q
    one_minus = 1.0 - cos_theta
    pow5 = one_minus * one_minus
    pow5 = pow5 * pow5 * one_minus
    reflectance = r0 + (1.0 - r0) * pow5
    does_refract = can_refract & (reflectance < refr_rand[:, None])
    ndi = _dot(normal, d)
    k = 1.0 - eta * eta * (1.0 - ndi * ndi)
    refracted = eta * d - (eta * ndi + fp.sqrt(torch.clamp(k, min=0.0))) * normal
    sd_refr = torch.where(does_refract, refracted, refl)

    is_diffuse = mat == DIFFUSE
    is_metal = mat == METAL
    is_refr = mat == REFRACTIVE

    sd = torch.where(is_diffuse[:, None], sd_diffuse,
                     torch.where(is_metal[:, None], sd_metal, sd_refr))
    does_scatter = torch.where(is_metal, metal_scatters, True)
    new_seed = torch.where(is_refr, torch.where(can_refract[:, 0], seed1, seed), seed3)
    return new_seed, sd, does_scatter
