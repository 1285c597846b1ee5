"""Fused closest-hit intersection + attribute fetch: the ``pallas`` backend.

Port of ``raytrace_tpu/ops/pallas_intersect.py``.  For each ray, the closest
hit over every row of the packed sphere table (ops/intersect.sphere_table)
in the expanded form (``|c|^2 - r^2`` precomputed in f64, one reciprocal of
``a`` per ray), the lowest index among the minima, and the winner's 16
attribute columns (center, material, texture, c0, c1, fuzz).  The TPU kernel
fetches those with a one-hot matrix product at HIGHEST precision, which is
exact, so an indexed load gives the same bits.  A ray that hits nothing
returns ``t = BIG`` and row 0's attributes, as the one-hot contraction does.

``intersect_shade_pallas`` launches the hand-written CUDA kernel
(``csrc/intersect.cu``) for CUDA tensors and the plain torch version
``intersect_shade_pallas_plain`` for CPU tensors; each counts its launches in
its ``launches`` attribute.  Both take the table's valid prefix
(``n_valid``) when the caller knows that the valid rows come first, as in
``prepare_scene``'s table; the rows after it are padding that cannot win,
so scanning only the prefix changes no bit.
"""

from __future__ import annotations

import torch

from . import fp
from . import launches
from .intersect import (_C_ATTR0, _C_CX, _C_CY, _C_CZ, _C_KC, _C_VALID, A_ATTR,
                        A_C0, A_C1, A_CX, A_CY, A_CZ, A_MAT, A_TEX, BIG,
                        sphere_table)
from .megakernel import TMAX, TMIN

__all__ = ["intersect_shade_pallas", "intersect_shade_pallas_plain",
           "intersect_pallas", "sphere_table", "A_CX", "A_CY", "A_CZ",
           "A_MAT", "A_TEX", "A_C0", "A_C1", "A_ATTR"]


def _check(o, d, table):
    if o.dtype != torch.float32 or d.dtype != torch.float32 or table.dtype != torch.float32:
        raise TypeError("o, d and table must be float32")
    n = o.shape[0]
    if o.shape != (n, 3) or d.shape != (n, 3) or table.dim() != 2 or table.shape[1] != 24:
        raise ValueError(f"o {tuple(o.shape)}, d {tuple(d.shape)}, "
                         f"table {tuple(table.shape)}: want [N,3], [N,3], [S,24]")
    if o.device != d.device or o.device != table.device:
        raise ValueError("o, d and table must be on one device")


def _rows(table, n_valid):
    s = table.shape[0]
    n_valid = s if n_valid is None else int(n_valid)
    if not 0 <= n_valid <= s:
        raise ValueError(f"n_valid {n_valid} outside the table's {s} rows")
    return n_valid


def intersect_shade_pallas(o, d, table, n_valid=None):
    """Fused intersect + attribute fetch.

    o, d: [N, 3] f32; table: [S, 24] f32 (see sphere_table).  ``n_valid``:
    the count of the table's leading rows that hold every valid row (None:
    all S rows; a table whose valid rows are not a prefix is scanned whole
    and its valid column read per row).  Returns (t [N], hit [N] bool,
    attrs [N, 16]), attrs columns per A_*.  CUDA tensors launch the kernel;
    CPU tensors run the plain version."""
    _check(o, d, table)
    rows = _rows(table, n_valid)
    if o.device.type == "cpu":
        return intersect_shade_pallas_plain(o, d, table, n_valid=n_valid)
    if o.device.type != "cuda":
        raise ValueError(f"unsupported device {o.device}")
    from .. import _build

    o, d, table = o.contiguous(), d.contiguous(), table.contiguous()
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned (rows are read as float4)")
    n = o.shape[0]
    t = torch.empty((n,), dtype=torch.float32, device=o.device)
    attrs = torch.empty((n, 16), dtype=torch.float32, device=o.device)
    if n:
        err = _build.library().rt_intersect_shade(
            o.data_ptr(), d.data_ptr(), table.data_ptr(), t.data_ptr(),
            attrs.data_ptr(), n, rows, o.device.index,
            torch.cuda.current_stream(o.device).cuda_stream)
        if err:
            raise RuntimeError(
                f"intersect kernel launch failed: {_build.error_string(err)}")
        launches.count(intersect_shade_pallas)
    return t, t < float(BIG), attrs


intersect_shade_pallas.launches = 0


def intersect_shade_pallas_plain(o, d, table, n_valid=None):
    """The plain torch version of ``intersect_shade_pallas``: the TPU
    kernel's [S, N] expression order, the rows past the first ``n_valid``
    (None: none) taken as invalid, ``argmin`` (lowest index among the
    minima) and an indexed load of the winner's attribute columns."""
    launches.count(intersect_shade_pallas_plain)
    scanned = torch.arange(table.shape[0], device=table.device)[:, None] < _rows(table, n_valid)
    ox, oy, oz = (o[:, i][None, :] for i in range(3))  # [1, N]
    dx, dy, dz = (d[:, i][None, :] for i in range(3))
    a = dx * dx + dy * dy + dz * dz
    od = ox * dx + oy * dy + oz * dz
    oo = ox * ox + oy * oy + oz * oz
    inv_a = 1.0 / a
    cx, cy, cz = (table[:, c : c + 1] for c in (_C_CX, _C_CY, _C_CZ))  # [S, 1]
    kc = table[:, _C_KC : _C_KC + 1]
    vld = table[:, _C_VALID : _C_VALID + 1]
    cd = cx * dx + cy * dy + cz * dz  # [S, N]
    co = cx * ox + cy * oy + cz * oz
    b = od - cd
    c = oo - 2.0 * co + kc
    disc = b * b - a * c
    ok = disc >= 0.0
    sq = fp.sqrt(torch.where(ok, disc, 0.0))
    t1 = (-b - sq) * inv_a
    t2 = (-b + sq) * inv_a
    t1_ok = ok & (t1 >= TMIN) & (t1 <= TMAX)
    t2_ok = ok & (t2 >= TMIN) & (t2 <= TMAX)
    big = torch.tensor(BIG, dtype=torch.float32, device=o.device)
    t = torch.where(t1_ok, t1, torch.where(t2_ok, t2, big))
    t = torch.where((vld > 0.0) & scanned, t, big)
    t_min = torch.amin(t, dim=0)
    idx = torch.argmin(t, dim=0)  # lowest index among the minima
    return t_min, t_min < big, table[idx, _C_ATTR0:]


intersect_shade_pallas_plain.launches = 0


def intersect_pallas(o, d, centers_t, kc, valid, tmin, tmax):
    """The (t, idx, hit) contract of ``intersect_matmul`` through the fused
    kernel: the sphere index rides in attribute column 0.  ``tmin``/``tmax``
    are the kernel's constants (T_MIN, MAX_RAY_COLLISION_DISTANCE)."""
    del tmin, tmax
    s = centers_t.shape[1]
    tab = torch.zeros((s, 24), dtype=torch.float32, device=o.device)
    tab[:, _C_CX : _C_CZ + 1] = centers_t.T
    tab[:, _C_KC] = kc
    tab[:, _C_VALID] = valid.to(torch.float32)
    tab[:, _C_ATTR0] = torch.arange(s, dtype=torch.float32, device=o.device)
    t, hit, attrs = intersect_shade_pallas(o, d, tab)
    return t, attrs[:, 0].to(torch.int64), hit
