"""Row-layout shading: shader.rchit semantics on per-lane state rows.

Port of ``raytrace_tpu/ops/shading_rows.py`` in plain torch, used by the plain
versions of both wavefront steps (ops/megakernel.py, ops/gridkernel.py).  The
CUDA kernels run the same op sequence as ``rt::shade`` in
``csrc/wavefront.cuh``: hit point, checker albedo, the branchless
3-material scatter with exact RNG draw-count parity, and the post-scatter
seed.  Every expression keeps the JAX operand order (bit-parity contract).
"""

from __future__ import annotations

import torch

from . import fp
from . import rng as rngops


def norm3(x, y, z):
    """Normalize with one reciprocal (megakernel._norm3): x * (1/sqrt(n2))."""
    inv = 1.0 / fp.sqrt(x * x + y * y + z * z)
    return x * inv, y * inv, z * inv


def shade_rows(ox, oy, oz, dx, dy, dz, t, seed,
               cenx, ceny, cenz, mat, tex, c0x, c0y, c0z, c1x, c1y, c1z, fuzz,
               cut_sin=False):
    """Returns (px_, py_, pz_, ax, ay, az, sdx, sdy, sdz, does_scatter,
    seed_h): hit point, albedo, un-normalized scatter direction, scatter
    flag, and the seed after the material's RNG draws (shader.rchit).
    ``cut_sin``: the grid kernel's cost probe -- the checker's three sines
    replaced by the product of their arguments (the image is invalid)."""
    px_ = ox + t * dx
    py_ = oy + t * dy
    pz_ = oz + t * dz
    nx, ny, nz = norm3(px_ - cenx, py_ - ceny, pz_ - cenz)
    ddn = nx * dx + ny * dy + nz * dz
    front = ddn < 0.0
    nx = torch.where(front, nx, -nx)
    ny = torch.where(front, ny, -ny)
    nz = torch.where(front, nz, -nz)

    # texture (shader.rchit:53-64): 3-D sine checker, size 6
    if cut_sin:
        sines = (6.0 * px_) * (6.0 * py_) * (6.0 * pz_)
    else:
        sines = torch.sin(6.0 * px_) * torch.sin(6.0 * py_) * torch.sin(6.0 * pz_)
    use_c1 = (tex > 0.5) & ~(sines > 0.0)
    ax = torch.where(use_c1, c1x, c0x)
    ay = torch.where(use_c1, c1y, c0y)
    az = torch.where(use_c1, c1z, c0z)

    # scatter (shader.rchit:66-116): speculative draws keep LCG parity
    seed3, ux, uy, uz = rngops.random_unit_vector(seed)
    seed1, refr_rand = rngops.random_float(seed)

    sdx_d = nx + ux
    sdy_d = ny + uy
    sdz_d = nz + uz
    near0 = ((torch.abs(sdx_d) < 1e-8) & (torch.abs(sdy_d) < 1e-8)
             & (torch.abs(sdz_d) < 1e-8))
    # the re-dot of the flipped normal equals sgn*ddn bitwise (negation
    # distributes exactly over fp mul/add)
    ndd = torch.where(front, ddn, -ddn)
    sdx_d = torch.where(near0, nx, sdx_d)
    sdy_d = torch.where(near0, ny, sdy_d)
    sdz_d = torch.where(near0, nz, sdz_d)

    rx_ = dx - 2.0 * ndd * nx
    ry_ = dy - 2.0 * ndd * ny
    rz_ = dz - 2.0 * ndd * nz
    mx = rx_ + fuzz * ux
    my = ry_ + fuzz * uy
    mz = rz_ + fuzz * uz
    mx, my, mz = norm3(mx, my, mz)
    metal_scatters = (mx * nx + my * ny + mz * nz) > 0.0

    # refractive — NaN-faithful canRefract (shader.rchit:126-129): the sqrt
    # is NOT clamped; a NaN makes the comparison false
    eta = torch.where(front, 1.0 / fuzz, fuzz)
    cos_t = -ndd
    omc2 = 1.0 - ndd * ndd  # == 1 - cos_t^2 bitwise
    can_refract = (eta * fp.sqrt(omc2)) <= 1.0
    q = (1.0 - eta) / (1.0 + eta)
    r0 = q * q
    om = 1.0 - cos_t
    om2 = om * om
    reflectance = r0 + (1.0 - r0) * om2 * om2 * om
    does_refract = can_refract & (reflectance < refr_rand)
    k = 1.0 - eta * eta * omc2
    sqk = fp.sqrt(torch.clamp(k, min=0.0))
    fx_r = eta * dx - (eta * ndd + sqk) * nx
    fy_r = eta * dy - (eta * ndd + sqk) * ny
    fz_r = eta * dz - (eta * ndd + sqk) * nz
    gx = torch.where(does_refract, fx_r, rx_)
    gy = torch.where(does_refract, fy_r, ry_)
    gz = torch.where(does_refract, fz_r, rz_)

    is_metal = (mat > 0.5) & (mat < 1.5)
    is_refr = mat > 1.5
    sdx = torch.where(is_metal, mx, torch.where(is_refr, gx, sdx_d))
    sdy = torch.where(is_metal, my, torch.where(is_refr, gy, sdy_d))
    sdz = torch.where(is_metal, mz, torch.where(is_refr, gz, sdz_d))
    does_scatter = metal_scatters | ~is_metal
    seed_h = torch.where(is_refr, torch.where(can_refract, seed1, seed), seed3)
    return (px_, py_, pz_, ax, ay, az, sdx, sdy, sdz, does_scatter, seed_h)
