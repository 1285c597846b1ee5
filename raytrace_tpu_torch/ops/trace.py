"""Persistent-wavefront path-tracing core (the port's ``traceRaysKHR``).

Port of ``raytrace_tpu/ops/trace.py``.  Each lane owns M strided pixels and
renders their samples back-to-back; each wavefront iteration traces one ray
segment per lane (intersect -> shade -> scatter or terminate), and a
terminated lane immediately regenerates its pixel's next sample or moves to
its next pixel, so lane occupancy stays high.  The per-pixel TEA seed and the
carried LCG stream reproduce the reference GLSL's draws exactly.

Backends:

- ``bruteforce`` / ``matmul`` / ``pallas``: the eager spec path
  (``render_band_core``'s generic loop), differing only in the closest-hit
  step (``_shade_inputs``): the oracle-order brute force, the expanded form
  with two fp32 ``torch.matmul`` products, or the fused intersect +
  attribute-fetch kernel (``ops/pallas_intersect.py``).  ``bruteforce`` runs
  in the oracle's fp op order and is the parity anchor.
- ``mega`` / ``grid``: the kernel loop ``_render_band_mega`` — state packed
  into row-major ``[rows, lanes]`` f32/int32 tensors, a host loop over the
  wavefront step (``ops/megakernel.py`` brute force, ``ops/gridkernel.py``
  grid DDA) until no lane is alive.  The brute-force state carries the pixel
  sums in accumulator rows, unpacked at the end; the grid step adds them
  into a separate home-order accumulator, and the loop launches over the
  live lanes only.  The grid backend alone takes the in-kernel call merge
  (``n_calls``, ``spp_last``), the balanced pixel->lane table (``passign``)
  and the iterstats probe (``ablate=("iterstats",)``).
- ``paged``: the same loop over the paged-grid step (``ops/pagedkernel.py``)
  with the live lanes sorted by page and compacted before every launch, and
  the pixel sums in a home-order accumulator (``_render_band_paged``).

Each kernel wrapper decides between its CUDA kernel and its plain torch
version by the state tensor's device, and so does a band's set-up
(``pack_state``: one launch of ``csrc/packstate.cu``, or
``pack_state_plain``'s torch ops).  While torch's profiler runs, the grid
and paged loops log each band's set-up (with the route it took) and each
launch (its live lanes, iterations and host timestamps) as spans
(``ops/launches.py``).

Seed/uv conventions: ``y0`` is the band's global row (uv) and ``seed_y0`` the
row origin for seeding; internal chunking passes ``seed_y0 = y0`` so chunked
renders equal the unchunked render bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import MAX_DEPTH, MAX_RAY_COLLISION_DISTANCE, T_MIN
from ..models.camera import Camera, calculate_viewport
from ..models.grid import MAX_SPHERES, build_grid, cell_major
from ..models.paged_grid import (P_FMAXX, P_FMAXZ, P_FMINX, P_FMINZ, P_INVS,
                                 P_XHI, P_XLO, P_YHI, P_YLO, P_ZHI, P_ZLO,
                                 PagedGridTables, build_paged_grid)
from ..models.scene import SceneArrays
from . import fp
from . import launches
from . import materials
from . import rng as rngops
from .intersect import (intersect_bruteforce, intersect_matmul,
                        sphere_constants, sphere_table, sphere_table_device)

_SKY = (0.7, 0.8, 1.0)  # shader.rmiss:15
LANE_PAD = 128  # kernel lanes are padded to a multiple of one CUDA block

SPEC_BACKENDS = ("bruteforce", "matmul", "pallas")
KERNEL_BACKENDS = ("mega", "grid", "paged")


class DeviceScene(NamedTuple):
    """Scene tables: numpy on the host (``prepare_scene``) or torch tensors
    on a device (``device_scene_from_numpy``, or built there by
    ``prepare_scene_device``); same fields as the JAX package's
    DeviceScene."""

    centers: object  # [S,3] f32
    centers_t: object  # [3,S] f32
    radii: object  # [S] f32
    kc: object  # [S] f32 = |c|^2 - r^2 (f64 precompute)
    valid: object  # [S] bool
    material: object  # [S] i32
    texture: object  # [S] i32
    color0: object  # [S,3] f32
    color1: object  # [S,3] f32
    attr: object  # [S] f32
    table: object  # [S,24] packed sphere table (ops/intersect.sphere_table)
    grid: object = None  # when the scene fits the grid: models.grid.GridTables
    #                      on the host (prepare_scene), models.grid.CellTables
    #                      on a device (device_scene_from_numpy)
    paged: object = None  # models.paged_grid.PagedGridTables when the grid
    #                       cannot hold the scene but the paged grid can


class ViewportArrays(NamedTuple):
    """Viewport constants (numpy f32), precomputed once on the host."""

    horizontal: np.ndarray  # [3]
    vertical: np.ndarray  # [3]
    upper_left: np.ndarray  # [3]
    cam_up: np.ndarray  # [3]
    cam_right: np.ndarray  # [3]
    look_from: np.ndarray  # [3]
    aperture: np.ndarray  # [] f32
    size: np.ndarray  # [2] f32 (width, height) — shader.rgen:42


def prepare_scene(scene: SceneArrays, grid_pitch=1.0) -> DeviceScene:
    """Host-side scene prep (numpy): SoA tables, the packed sphere table, the
    grid tables and, for a scene the grid cannot hold, the paged-grid tables.
    ``grid_pitch``: cell size in world units, or "auto" (pitch 2 when it
    keeps the 4-value layout, else pitch 1)."""
    with launches.span("scene.prepare", route="host") as rec:
        centers = np.asarray(scene.centers, np.float32)
        radii = np.asarray(scene.radii, np.float32)
        n = int(scene.n_spheres)
        valid = np.arange(centers.shape[0]) < n
        table = sphere_table(scene)
        if grid_pitch == "auto":
            grid = build_grid(scene, table, pitch=2.0)
            if grid is None or grid.has_cy is not None:
                grid = build_grid(scene, table, pitch=1.0)
        else:
            grid = build_grid(scene, table, pitch=float(grid_pitch))
        paged = None
        if grid is None:
            # built with torch ops on the CPU, kept as numpy
            paged = _build_paged(scene, table, "host")
            if paged is not None:
                paged = PagedGridTables(*(None if t is None else t.numpy() for t in paged))
        rec.set(tables="grid" if grid is not None else "paged" if paged is not None else None)
    return DeviceScene(
        centers=centers,
        centers_t=np.ascontiguousarray(centers.T),
        radii=radii,
        kc=sphere_constants(centers, radii),
        valid=valid,
        material=np.asarray(scene.material, np.int32),
        texture=np.asarray(scene.texture, np.int32),
        color0=np.asarray(scene.color0, np.float32),
        color1=np.asarray(scene.color1, np.float32),
        attr=np.asarray(scene.attr, np.float32),
        table=table,
        grid=grid,
        paged=paged,
    )


def _tensor(a, device) -> Optional[torch.Tensor]:
    if a is None:
        return None
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a))).to(device)


def _tables(tables, cls, device):
    if tables is None:
        return None
    return cls(**{f: _tensor(getattr(tables, f), device) for f in cls._fields})


def _cell_tables(grid, device):
    """GridTables (numpy) -> CellTables of tensors on ``device``."""
    if grid is None:
        return None
    ct = cell_major(grid)
    return ct._replace(**{f: _tensor(getattr(ct, f), device)
                          for f in ("cells", "attrs", "gtab", "gttab", "gscal", "tattrs")})


def device_scene_from_numpy(ds, device) -> DeviceScene:
    """Scene tables onto ``device`` as torch tensors — the port's weight
    import.  ``ds`` is any DeviceScene with numpy-convertible fields: the
    port's ``prepare_scene`` or the JAX package's, including its GridTables
    (re-laid once here into the grid kernel's ``CellTables``) and
    PagedGridTables, field by field."""
    fields = {f: _tensor(getattr(ds, f), device)
              for f in DeviceScene._fields if f not in ("grid", "paged")}
    return DeviceScene(**fields, grid=_cell_tables(ds.grid, device),
                       paged=_tables(ds.paged, PagedGridTables, device))


def _build_paged(scene: SceneArrays, table, route: str):
    """``build_paged_grid`` on ``table``'s device, in the span
    ``paged.build``."""
    with launches.span("paged.build", route=route, n_spheres=int(scene.n_spheres)) as rec:
        stats = {}
        paged = build_paged_grid(scene, table, stats=stats)
        rec.set(**stats)
    return paged


def builds_on_device(scene: SceneArrays) -> bool:
    """True for a scene the grid refuses by its size, so it takes the paged
    tables (or none): only its own arrays go to a device
    (``scene_to_device``), and the device builds its tables
    (``prepare_scene_device``).  Smaller scenes' tables are built on the host
    (``prepare_scene``)."""
    return int(scene.n_spheres) >= MAX_SPHERES


_SCENE_FIELDS = {"centers": np.float32, "radii": np.float32, "material": np.int32,
                 "texture": np.int32, "color0": np.float32, "color1": np.float32,
                 "attr": np.float32}


def scene_to_device(scene: SceneArrays, device):
    """The scene's own arrays on ``device``: (a SceneArrays of tensors there,
    ``n_spheres`` a host int; the bytes sent).  They are packed into one
    buffer of pinned host memory and sent in one copy that the host does not
    wait for; each field is a view of the device's copy."""
    device = torch.device(device)
    parts = [np.asarray(getattr(scene, f), dt) for f, dt in _SCENE_FIELDS.items()]
    starts = np.cumsum([0] + [-(-p.size // 64) * 64 for p in parts])  # 256-B aligned
    host = torch.empty(int(starts[-1]), dtype=torch.int32, pin_memory=device.type == "cuda")
    words = host.numpy()
    for p, o in zip(parts, starts):
        words[o : o + p.size] = p.reshape(-1).view(np.int32)
    sent = host.to(device, non_blocking=True)
    fields = {}
    for (f, dt), p, o in zip(_SCENE_FIELDS.items(), parts, starts):
        t = sent[o : o + p.size]
        fields[f] = (t if dt == np.int32 else t.view(torch.float32)).view(p.shape)
    return SceneArrays(**fields, n_spheres=int(scene.n_spheres)), host.numel() * 4


def prepare_scene_device(scene: SceneArrays) -> DeviceScene:
    """``prepare_scene`` on the device of a SceneArrays of tensors
    (``scene_to_device``) of a scene the grid refuses by its size: the
    sphere table and the paged tables built there, equal field by field and
    byte for byte to ``device_scene_from_numpy(prepare_scene(scene), device)``."""
    n = int(scene.n_spheres)
    if n < MAX_SPHERES:
        raise ValueError(f"the grid may take a scene of {n} spheres: prepare it on the host")
    with launches.span("scene.prepare", route="device") as rec:
        table, kc = sphere_table_device(scene)
        paged = _build_paged(scene, table, "device")
        rec.set(tables="paged" if paged is not None else None)
    centers = scene.centers
    return DeviceScene(
        centers=centers,
        centers_t=centers.T.contiguous(),
        radii=scene.radii,
        kc=kc,
        valid=torch.arange(centers.shape[0], device=centers.device) < n,
        material=scene.material,
        texture=scene.texture,
        color0=scene.color0,
        color1=scene.color1,
        attr=scene.attr,
        table=table,
        paged=paged,
    )


def tmax_never_binds(scene: SceneArrays, camera: Camera) -> bool:
    """True when no intersection in this scene can reach the ray tMax
    (shader.rgen:26): every hit point and ray origin lie inside the ball of
    radius R = max(|center|+r, |camera|), so t <= 2R.  Lets the kernels drop
    their upper range checks (skip_tmax) with zero semantic change."""
    centers = np.asarray(scene.centers, np.float64)
    radii = np.asarray(scene.radii, np.float64)
    n = int(scene.n_spheres)
    reach = float((np.linalg.norm(centers[:n], axis=1) + radii[:n]).max()) if n else 0.0
    cam = float(np.linalg.norm(np.asarray(camera.look_from, np.float64)))
    return 2.0 * max(reach, cam) < 0.99 * MAX_RAY_COLLISION_DISTANCE


def viewport_arrays(camera: Camera, width: int, height: int) -> ViewportArrays:
    """Precompute calculateViewport (shader.rgen:92-105) once on the host."""
    vp = calculate_viewport(camera, np.float32(width) / np.float32(height))
    return ViewportArrays(
        horizontal=vp.horizontal,
        vertical=vp.vertical,
        upper_left=vp.upper_left_corner,
        cam_up=vp.camera_up,
        cam_right=vp.camera_right,
        look_from=vp.look_from,
        aperture=np.float32(vp.aperture),
        size=np.array([width, height], np.float32),
    )


def viewport_scalars(vp: ViewportArrays) -> np.ndarray:
    """Pack ViewportArrays into the kernels' (1, 24) f32 layout
    (megakernel.V_*)."""
    out = np.zeros((1, 24), np.float32)
    out[0, 0:3] = vp.horizontal
    out[0, 3:6] = vp.vertical
    out[0, 6:9] = vp.upper_left
    out[0, 9:12] = vp.cam_up
    out[0, 12:15] = vp.cam_right
    out[0, 15:18] = vp.look_from
    out[0, 18] = vp.aperture
    out[0, 19:21] = vp.size
    return out


def _normalize3(v):
    """GLSL normalize with explicit x,y,z sum order (bit-parity with oracle)."""
    n2 = v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]
    return v / fp.sqrt(n2)[..., None]


def _camera_rays(seed, fx, fy, vpt):
    """Vectorized getCameraRay (shader.rgen:107-115) incl. the uv jitter
    draws of shader.rgen:57: exactly 4 LCG draws per sample (jitter-x,
    jitter-y, aperture-r1, aperture-r2).  ``vpt``: dict of viewport tensors."""
    seed, jx = rngops.random_float(seed)
    seed, jy = rngops.random_float(seed)
    u = (fx + jx) / vpt["size"][0]
    v = (fy + jy) / vpt["size"][1]
    seed, r1 = rngops.random_in_interval(seed, -1.0, 1.0)
    seed, r2 = rngops.random_in_interval(seed, -1.0, 1.0)
    inv_l = 1.0 / fp.sqrt(r1 * r1 + r2 * r2)
    ap = vpt["aperture"] * 0.5
    rx = ap * (r1 * inv_l)
    ry = ap * (r2 * inv_l)
    offset3 = vpt["cam_right"][None, :] * rx[:, None] + vpt["cam_up"][None, :] * ry[:, None]
    frm = vpt["look_from"][None, :] + offset3
    to = (vpt["upper_left"][None, :] + vpt["horizontal"][None, :] * u[:, None]
          - vpt["vertical"][None, :] * v[:, None])
    d = _normalize3(to - frm)
    return seed, frm, d


def _viewport_tensors(vp: ViewportArrays, device) -> dict:
    return {k: torch.from_numpy(np.array(getattr(vp, k), np.float32)).to(device)
            for k in ViewportArrays._fields}


def _pixel_init(pix, number, *, width, y0, seed_y0, offset_x):
    """Per-pixel uv coords + fresh TEA seed (shader.rgen:40,45)."""
    px = pix % width
    py_local = pix // width
    fx = (offset_x + px).to(torch.float32)
    fy = (y0 + py_local).to(torch.float32)
    seed0 = rngops.tea_hash(rngops.tea_hash(px, seed_y0 + py_local),
                            torch.full_like(px, number & rngops.MASK))
    return fx, fy, seed0


def _check_options(backend, ablate, grid_steps, n_calls, spp_last, passign):
    if (n_calls is not None or spp_last is not None) and backend != "grid":
        raise ValueError("in-kernel call merging is a grid-backend feature")
    if passign is not None and backend != "grid":
        raise ValueError("balanced pixel assignment is a grid-backend feature")
    from . import gridkernel, pagedkernel

    ported = {"grid": gridkernel.SWITCHES + ("iterstats",),
              "paged": pagedkernel.SWITCHES}.get(backend, ())
    every = set(gridkernel.SWITCHES + pagedkernel.SWITCHES + ("iterstats",))
    mosaic = tuple(a for a in ablate if a not in every)
    if mosaic:
        raise NotImplementedError(
            f"ablate={mosaic}: the Mosaic switches are not carried over to the "
            "port (ROADMAP, 'Not ported, by design')")
    if "iterstats" in ablate and backend != "grid":
        raise ValueError("the iterstats probe is a grid-backend feature")
    if any(a not in ported for a in ablate):
        raise ValueError(f"ablate={tuple(ablate)}: the {backend} backend's switches are "
                         f"{ported}")
    if "freeze" in ablate:
        raise ValueError("freeze pins the march, so a render under it never ends: it is "
                         "a probe of one step (scripts/grid_iterbench.py)")
    if grid_steps is not None:
        raise NotImplementedError(
            f"grid_steps={tuple(grid_steps)}: the grid-step probes are not "
            "carried over to the port (ROADMAP, 'Not ported, by design')")
    if backend not in SPEC_BACKENDS + KERNEL_BACKENDS:
        raise ValueError(f"unknown backend: {backend!r}")


def render_band(scene: DeviceScene, vp: ViewportArrays, **kw):
    """Render one row band; returns the accumulated color sum [band_h, W, 3]
    (f32, on the scene's device).  The keywords are ``render_band_steps``'s;
    this runs its steps to the end."""
    return run_steps(render_band_steps(scene, vp, **kw))


def run_steps(steps):
    """Run a generator of steps (``render_band_steps``) to its end; returns
    its return value."""
    try:
        while True:
            next(steps)
    except StopIteration as stop:
        return stop.value


def issued(device: torch.device):
    """What a step of ``render_band_steps`` yields once its launch is issued:
    on a CUDA device an event recorded after it on the current stream, which
    a caller polls before it steps the band again; None on the CPU, where
    the step's work is done when it returns."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def render_band_steps(
    scene: DeviceScene,
    vp: ViewportArrays,
    *,
    band_h: int,
    width: int,
    y0: int,
    seed_y0: int,
    offset_x: int,
    spp: int,
    number: int,
    accum_init: Optional[torch.Tensor] = None,
    max_depth: int = MAX_DEPTH,
    backend: str = "bruteforce",
    pixels_per_lane: int = 1,
    skip_tmax: bool = False,
    ablate: tuple = (),
    grid_steps=None,
    n_calls=None,
    spp_last=None,
    rr=None,
    passign=None,
    return_iters: bool = False,
):
    """Render one row band, as a generator of steps: it yields ``issued``'s
    event once each launch (or spec-loop iteration) is issued, before the
    host waits for its result, and returns the accumulated color sum
    [band_h, W, 3] (f32, on the scene's device).  A caller that polls those
    events steps each of several bands as soon as its last launch is done,
    all from one host thread (``parallel/devices.py``); ``render_band``
    runs one to its end.

    shader.rgen main() semantics: per-pixel seed ``tea(tea(x, y), number)``,
    ``spp`` sequential jittered samples, the iterative <= ``max_depth``
    bounce loop.  ``pixels_per_lane`` (M): each lane renders M strided pixels
    (pixel of lane k, slot m = m*n_lanes + k); the image is identical for
    any M.  ``rr=(d0, d1, pmin)`` is fast mode's Russian roulette; None is
    the exact reference stream.

    Grid backend only: ``n_calls`` merges that many progressive calls into
    the launches (numbers number..number+n_calls-1, ``spp`` samples each,
    ``spp_last`` in the last), bit-identical to the same calls issued one by
    one with the accumulator carried; ``passign`` (int32 [m_slots, n_pad],
    numpy or tensor, runtime/balance.py) deals the band's pixels to lanes,
    the image unchanged for any table; ``ablate=("iterstats",)`` renders
    the cost probe (red = issued iterations per pixel).  ``ablate`` also
    takes the grid kernel's section-cost switches (``gridkernel.SWITCHES``,
    grid backend) or the paged kernel's (``pagedkernel.SWITCHES``, paged
    backend), ``freeze`` excepted (its march never ends); the Mosaic
    switches raise ``NotImplementedError``.  ``return_iters``:
    return (acc, (tile_iters, lane_slots)), the launches' iterations summed
    over their blocks of ``LANE_PAD`` lanes and over their lane slots."""
    _check_options(backend, ablate, grid_steps, n_calls, spp_last, passign)
    kw = dict(band_h=band_h, width=width, y0=y0, seed_y0=seed_y0,
              offset_x=offset_x, spp=spp, number=number, accum_init=accum_init,
              max_depth=max_depth, pixels_per_lane=pixels_per_lane, rr=rr)
    iters = [0, 0]
    probes = tuple(a for a in ablate if a != "iterstats")
    if backend == "paged":
        acc = yield from _render_band_paged(scene, vp, skip_tmax=skip_tmax, iters=iters,
                                            ablate=probes, **kw)
    elif backend in KERNEL_BACKENDS:
        acc = yield from _render_band_mega(
            scene, vp, skip_tmax=skip_tmax, backend=backend, n_calls=n_calls,
            spp_last=spp_last, passign=passign, iterstats="iterstats" in ablate,
            ablate=probes, iters=iters, **kw)
    else:
        acc = yield from _render_band_spec(scene, vp, backend=backend, iters=iters, **kw)
    return (acc, tuple(iters)) if return_iters else acc


def _count_iters(iters, k_steps, n_lanes):
    """Add a launch of ``k_steps`` iterations over ``n_lanes`` lanes to
    ``iters`` = [tile_iters, lane_slots], in blocks of ``LANE_PAD`` lanes."""
    blocks = -(-n_lanes // LANE_PAD)
    iters[0] += k_steps * blocks
    iters[1] += k_steps * blocks * LANE_PAD


def _shade_inputs(backend, scene: DeviceScene, o, d, n_valid=None):
    """Closest hit + the hit sphere's attributes (JAX ``_shade_inputs``).

    Returns (t [N], hit [N] bool, center [N,3], mat [N] i32, tex [N] i32,
    c0 [N,3], c1 [N,3], attr [N]).  ``pallas`` gets everything from one
    fused kernel, which scans the table's first ``n_valid`` rows (None:
    all); ``bruteforce`` and ``matmul`` gather from the SoA tables by the
    winning index."""
    if backend == "pallas":
        from . import pallas_intersect as pk

        t, hit, a = pk.intersect_shade_pallas(o, d, scene.table, n_valid=n_valid)
        return (t, hit, a[:, pk.A_CX : pk.A_CZ + 1],
                a[:, pk.A_MAT].to(torch.int32), a[:, pk.A_TEX].to(torch.int32),
                a[:, pk.A_C0 : pk.A_C0 + 3], a[:, pk.A_C1 : pk.A_C1 + 3],
                a[:, pk.A_ATTR])
    tmin = float(np.float32(T_MIN))
    tmax = float(np.float32(MAX_RAY_COLLISION_DISTANCE))
    if backend == "matmul":
        t, idx, hit = intersect_matmul(o, d, scene.centers_t, scene.kc,
                                       scene.valid, tmin, tmax)
    else:
        t, idx, hit = intersect_bruteforce(o, d, scene.centers, scene.radii,
                                           scene.valid, tmin, tmax)
    return (t, hit, scene.centers[idx], scene.material[idx], scene.texture[idx],
            scene.color0[idx], scene.color1[idx], scene.attr[idx])


def _render_band_spec(scene, vp, *, band_h, width, y0, seed_y0, offset_x, spp,
                      number, accum_init, max_depth, pixels_per_lane, rr,
                      backend="bruteforce", iters=None):
    """The generic wavefront loop (JAX ``render_band_core``) in eager torch:
    the spec path the kernels are held against (``bruteforce``), and the
    ``matmul`` / ``pallas`` closest-hit variants."""
    dev = scene.centers.device
    p_total = band_h * width
    m_slots = max(1, min(pixels_per_lane, p_total))
    n = -(-p_total // m_slots)  # lanes
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    vpt = _viewport_tensors(vp, dev)
    sky = torch.tensor(_SKY, dtype=torch.float32, device=dev)
    init = dict(width=width, y0=y0, seed_y0=seed_y0, offset_x=offset_x)

    fx, fy, seed0 = _pixel_init(lane, number, **init)  # slot 0: pixel = lane
    seed, o, d = _camera_rays(seed0, fx, fy, vpt)

    if accum_init is None:
        acc = torch.zeros((n, m_slots, 3), dtype=torch.float32, device=dev)
    else:
        flat = accum_init.reshape(p_total, 3).to(torch.float32)
        pad = n * m_slots - p_total
        if pad:
            flat = torch.cat([flat, flat.new_zeros((pad, 3))], dim=0)
        acc = flat.reshape(m_slots, n, 3).permute(1, 0, 2).contiguous()

    m = torch.zeros(n, dtype=torch.int64, device=dev)
    sidx = torch.ones(n, dtype=torch.int64, device=dev)
    depth = torch.zeros(n, dtype=torch.int64, device=dev)
    thr = torch.ones((n, 3), dtype=torch.float32, device=dev)
    alive = torch.full((n,), spp > 0, dtype=torch.bool, device=dev)
    slot_ids = torch.arange(m_slots, device=dev)[None, :]
    # the valid rows are the table's prefix (prepare_scene)
    n_valid = int(scene.valid.sum()) if backend == "pallas" else None

    while bool(alive.any()):
        if iters is not None:
            _count_iters(iters, 1, n)
        t, hit, center, mat, tex, c0, c1, attr = _shade_inputs(backend, scene, o, d,
                                                               n_valid)

        point = o + t[:, None] * d  # shader.rint:33
        outward = _normalize3(point - center)  # shader.rchit:41-43
        ddn = outward[:, 0] * d[:, 0] + outward[:, 1] * d[:, 1] + outward[:, 2] * d[:, 2]
        front = ddn < 0.0
        normal = torch.where(front[:, None], outward, -outward)

        att = materials.texture_color(point, tex, c0, c1)
        seed_h, sd, does_scatter = materials.scatter(seed, d, normal, front, mat, attr)

        scatters = hit & does_scatter
        deep = (depth + 1) >= max_depth
        cont = alive & scatters & ~deep
        nthr = thr * att
        if rr is not None:
            # Russian-roulette fast mode (same structure and f32 op order as
            # the kernels); rr=None keeps the bit-parity chain
            d0, d1, pmin = rr
            dnext = depth + 1
            p = torch.clamp(torch.clamp(torch.amax(nthr, dim=1),
                                        min=float(np.float32(pmin))), max=1.0)
            if d1:
                p = torch.where(dnext >= d1, p * 0.5, p)
            considered = cont & (dnext >= d0)
            seed_pre = torch.where(hit, seed_h, seed)
            seed_rr, u_rr = rngops.random_float(seed_pre)
            killed = considered & (u_rr >= p)
            cont = cont & ~killed
            nthr = torch.where(considered[:, None], nthr / p[:, None], nthr)
        term = alive & ~cont

        # lightSourceColor: sky on miss; attenuation on absorb (rgen:82-86);
        # 0 when the depth cap kills a still-scattering path (rgen:74,89)
        light = torch.where(hit[:, None],
                            torch.where(does_scatter[:, None], 0.0, att),
                            sky[None, :])
        contrib = torch.where(term[:, None], thr * light, 0.0)
        oh = (slot_ids == m[:, None]).to(torch.float32)
        acc = acc + oh[:, :, None] * contrib[:, None, :]

        # seed: hits consumed material draws; misses consumed none
        seed_a = torch.where(hit, seed_h, seed)
        if rr is not None:
            seed_a = torch.where(considered, seed_rr, seed_a)

        # termination bookkeeping: next sample of same pixel, or next pixel
        more = term & (sidx < spp)
        pix_done = term & ~more
        m2 = m + pix_done.to(torch.int64)
        pix2 = m2 * n + lane
        adv = pix_done & (m2 < m_slots) & (pix2 < p_total)
        fx2, fy2, fresh = _pixel_init(pix2, number, **init)

        regen = more | adv
        seed_c = torch.where(adv, fresh, seed_a)
        fx = torch.where(adv, fx2, fx)
        fy = torch.where(adv, fy2, fy)
        seed_r, o_r, d_r = _camera_rays(seed_c, fx, fy, vpt)

        seed = torch.where(alive, torch.where(regen, seed_r, seed_a), seed)
        m = m2
        sidx = torch.where(adv, 1, sidx + more.to(torch.int64))
        depth = torch.where(cont, depth + 1, torch.where(regen, 0, depth))
        o = torch.where(cont[:, None], point, torch.where(regen[:, None], o_r, o))
        d = torch.where(cont[:, None], _normalize3(sd),
                        torch.where(regen[:, None], d_r, d))
        thr = torch.where(cont[:, None], nthr, torch.where(regen[:, None], 1.0, thr))
        alive = alive & (cont | regen)
        yield issued(dev)

    acc = acc.permute(1, 0, 2).reshape(n * m_slots, 3)[:p_total]
    return acc.reshape(band_h, width, 3)


def _state_module(scene, backend, m_slots):
    """(module holding the state-row constants, f32 state rows) of a band."""
    from . import gridkernel, megakernel, pagedkernel

    if backend == "paged":
        na = pagedkernel.layout(scene.paged)[4]  # carried attr rows
        return pagedkernel, pagedkernel.pf_rows(na)
    if backend == "grid":
        return gridkernel, gridkernel.F_ROWS
    return megakernel, megakernel.f_rows(m_slots)


def state_route(device) -> str:
    """The route a band's set-up takes on ``device``: ``kernel``, one launch
    of ``csrc/packstate.cu`` on a CUDA device, else ``plain``,
    ``pack_state_plain``'s torch ops."""
    return "kernel" if torch.device(device).type == "cuda" else "plain"


def _band_lanes(band_h, width, pixels_per_lane, lane_pad):
    """(p_total, m_slots, logical lanes, padded lanes) of a band."""
    p_total = band_h * width
    m_slots = max(1, min(pixels_per_lane, p_total))
    n = -(-p_total // m_slots)
    return p_total, m_slots, n, -(-n // lane_pad) * lane_pad


def _check_pack(backend, passign, accum_init, first_key, m_slots, n_pad):
    if passign is not None and (tuple(passign.shape) != (m_slots, n_pad)
                                or passign.dtype != torch.int32):
        raise ValueError(f"passign {tuple(passign.shape)} {passign.dtype}, want "
                         f"({m_slots}, {n_pad}) int32")
    if accum_init is not None and backend in ("grid", "paged"):
        raise ValueError(f"{backend} state has no accumulator rows: pass "
                         "accum_init to home_accum")
    if first_key and backend != "paged":
        raise ValueError("the first sort key belongs to the paged backend")


def _scalars(*, spp, number, y0, seed_y0, offset_x, n_calls, spp_last):
    """The kernels' (1, 8) int32 scalar slots (megakernel.S_*), on the
    host."""
    from . import megakernel

    s = np.zeros((1, 8), np.int64)
    s[0, megakernel.S_SPP] = spp
    s[0, megakernel.S_NUMBER] = np.uint32(number).astype(np.int32)
    s[0, megakernel.S_Y0] = y0
    s[0, megakernel.S_SEEDY0] = seed_y0
    s[0, megakernel.S_OFFX] = offset_x
    s[0, megakernel.S_NCALLS] = 1 if n_calls is None else n_calls
    s[0, megakernel.S_SPPLAST] = spp if spp_last is None else spp_last
    return s.astype(np.int32)


def _fill_accum(fstate, accum_init, *, p_total, m_slots, n):
    """Copy ``accum_init`` into a brute-force (mega) state's accumulator
    rows, slot-major, over its ``n`` logical lanes."""
    from . import megakernel

    flat = accum_init.reshape(p_total, 3).to(device=fstate.device, dtype=torch.float32)
    pad = n * m_slots - p_total
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad, 3))], dim=0)
    acc_rows = flat.reshape(m_slots, n, 3).permute(0, 2, 1).reshape(3 * m_slots, n)
    fstate[megakernel.R_ACC : megakernel.R_ACC + 3 * m_slots, :n] = acc_rows


def pack_state(scene: DeviceScene, vp: ViewportArrays, *, backend, band_h,
               width, y0, seed_y0, offset_x, spp, number, accum_init=None,
               pixels_per_lane=1, lane_pad=LANE_PAD, n_calls=None,
               spp_last=None, passign=None, first_key=False):
    """Pack a band's initial wavefront state for the kernel steps.

    Returns (fstate [rows, n_pad] f32, ustate [U_ROWS, n_pad] int32
    holding u32 bits, scal [1, 8] int32, vpr [1, 24] f32, geometry dict),
    and with ``first_key`` (paged only) the first launch's sort key [n_pad]
    int32 (``_rebucket_key`` of the state) after them.
    Slot 0 of lane k is pixel k, or ``passign[0, k]`` when a balanced table
    int32 [m_slots, n_pad] is given (grid only; a lane whose entry is the
    ``p_total`` sentinel starts dead); ``grid`` and ``paged`` state also
    holds k in its ``U_LANE0`` row and has no accumulator rows
    (``home_accum`` makes its accumulator, and ``accum_init`` raises).
    ``n_calls`` / ``spp_last`` fill the scalar slots of the grid kernel's
    call merge (default: one call of ``spp``).  The first camera ray comes
    from the kernels' own camera formula, so every sample of the kernel
    path is generated by one formula and the image is bit-identical for any
    M.  (The JAX drivers use the spec ``_camera_rays`` here; XLA rewrites
    both normalizations to ``v * rsqrt(n2)`` so the difference never shows
    there, but in IEEE arithmetic ``v / sqrt(n2)`` and ``v * (1 / sqrt(n2))``
    differ in the last bit.)

    The route follows the scene's device (``state_route``): on a CUDA
    device one launch of ``csrc/packstate.cu`` writes every row, ``scal``,
    ``vpr`` and the key, copying nothing from the host (the brute-force
    state's accumulator rows are copied in after it), each counted in
    ``pack_state.launches``; elsewhere ``pack_state_plain`` packs the same
    state bit for bit with torch ops."""
    kw = dict(backend=backend, band_h=band_h, width=width, y0=y0, seed_y0=seed_y0,
              offset_x=offset_x, spp=spp, number=number, accum_init=accum_init,
              pixels_per_lane=pixels_per_lane, lane_pad=lane_pad, n_calls=n_calls,
              spp_last=spp_last, passign=passign, first_key=first_key)
    dev = scene.table.device
    if state_route(dev) == "plain":
        return pack_state_plain(scene, vp, **kw)
    p_total, m_slots, n, n_pad = _band_lanes(band_h, width, pixels_per_lane, lane_pad)
    _check_pack(backend, passign, accum_init, first_key, m_slots, n_pad)
    mk, rf = _state_module(scene, backend, m_slots)
    if passign is not None and (passign.device != dev or not passign.is_contiguous()):
        raise ValueError(f"passign must be contiguous on {dev}")
    gscal = scene.paged.gscal if first_key else None
    if gscal is not None and (gscal.dtype != torch.float32 or gscal.numel() < 16
                              or not gscal.is_contiguous()):
        raise ValueError("gscal must hold 16 contiguous float32 values")
    vpr = torch.empty((1, 24), dtype=torch.float32, device=dev)
    scal = torch.empty((1, 8), dtype=torch.int32, device=dev)
    fstate = torch.empty((rf, n_pad), dtype=torch.float32, device=dev)
    ustate = torch.empty((mk.U_ROWS, n_pad), dtype=torch.int32, device=dev)
    key = torch.empty(n_pad, dtype=torch.int32, device=dev) if first_key else None
    pack_kernel(fstate, ustate, key, vpr, scal, passign, gscal,
                vpr_host=viewport_scalars(vp),
                scal_host=_scalars(spp=spp, number=number, y0=y0, seed_y0=seed_y0,
                                   offset_x=offset_x, n_calls=n_calls, spp_last=spp_last),
                lane0_row=mk.U_LANE0 if backend in ("grid", "paged") else -1, n_lanes=n,
                p_total=p_total, width=width)
    launches.count(pack_state)
    if accum_init is not None:
        _fill_accum(fstate, accum_init, p_total=p_total, m_slots=m_slots, n=n)
    geom = dict(m_slots=m_slots, n_lanes=n, p_total=p_total, width=width)
    out = (fstate, ustate, scal, vpr, geom)
    return out + (key,) if first_key else out


pack_state.launches = 0


def pack_kernel(fstate, ustate, key, vpr, scal, passign, gscal, *, vpr_host, scal_host,
                lane0_row, n_lanes, p_total, width):
    """One launch of ``csrc/packstate.cu`` on the current stream, writing a
    band's initial state into ``fstate`` / ``ustate`` (every row of every
    lane), the host arrays ``vpr_host`` (f32 [1, 24], ``viewport_scalars``)
    and ``scal_host`` (int32 [1, 8]) into ``vpr`` and ``scal`` on the
    device, which the launch takes by value, and, given ``key`` (and the
    paged grid's ``gscal``), the first sort key; ``lane0_row``: the u32 row
    that holds the lane's index, -1 for none.  ``pack_state``'s kernel
    route, checked by it."""
    from .. import _build

    vpr_host = np.ascontiguousarray(vpr_host, np.float32)
    scal_host = np.ascontiguousarray(scal_host, np.int32)
    if vpr_host.size != 24 or scal_host.size != 8:
        raise ValueError("vpr_host must hold 24 float32 and scal_host 8 int32 values")
    dev = fstate.device
    err = _build.library().rt_pack_state(
        vpr_host.ctypes.data, scal_host.ctypes.data,
        None if passign is None else passign.data_ptr(),
        None if gscal is None else gscal.data_ptr(), vpr.data_ptr(), scal.data_ptr(),
        fstate.data_ptr(), ustate.data_ptr(), None if key is None else key.data_ptr(),
        fstate.shape[1], fstate.shape[0], ustate.shape[0], lane0_row, n_lanes, p_total,
        width, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"band set-up kernel launch failed: {_build.error_string(err)}")


def pack_state_plain(scene: DeviceScene, vp: ViewportArrays, *, backend, band_h,
                     width, y0, seed_y0, offset_x, spp, number, accum_init=None,
                     pixels_per_lane=1, lane_pad=LANE_PAD, n_calls=None,
                     spp_last=None, passign=None, first_key=False):
    """The plain torch version of ``pack_state``, on any device: the TEA
    seed hashes in masked int64 (``ops/rng.py``), the kernels' camera rays
    on lane rows (``megakernel.camera_rays_rows``), the rows filled one by
    one and the first key by ``_rebucket_key``; counted in its ``launches``
    attribute."""
    from . import megakernel

    dev = scene.table.device
    p_total, m_slots, n, n_pad = _band_lanes(band_h, width, pixels_per_lane, lane_pad)
    _check_pack(backend, passign, accum_init, first_key, m_slots, n_pad)
    mk, rf = _state_module(scene, backend, m_slots)

    lane = torch.arange(n_pad, dtype=torch.int64, device=dev)
    if passign is None:
        pix0 = lane
        alive0 = lane < n
    else:
        pix0 = passign[0].to(torch.int64)
        alive0 = pix0 < p_total
    fx0, fy0, seed0 = _pixel_init(pix0, number, width=width, y0=y0,
                                  seed_y0=seed_y0, offset_x=offset_x)
    vpr = torch.from_numpy(viewport_scalars(vp)).to(dev)
    seed, o, d = megakernel.camera_rays_rows(seed0, fx0, fy0, vpr)

    fstate = torch.zeros((rf, n_pad), dtype=torch.float32, device=dev)
    fstate[mk.R_O : mk.R_O + 3] = torch.stack(o)
    fstate[mk.R_D : mk.R_D + 3] = torch.stack(d)
    fstate[mk.R_FX] = fx0
    fstate[mk.R_FY] = fy0
    fstate[mk.R_THR : mk.R_THR + 3] = 1.0
    if accum_init is not None:
        _fill_accum(fstate, accum_init, p_total=p_total, m_slots=m_slots, n=n)

    ustate = torch.zeros((mk.U_ROWS, n_pad), dtype=torch.int32, device=dev)
    ustate[mk.U_SEED] = rngops.to_i32(seed)
    ustate[mk.U_SIDX] = 1
    ustate[mk.U_ALIVE] = (alive0 & (spp > 0)).to(torch.int32)
    if backend in ("grid", "paged"):
        ustate[mk.U_LANE0] = lane.to(torch.int32)
    launches.count(pack_state_plain)
    scal = torch.from_numpy(_scalars(spp=spp, number=number, y0=y0, seed_y0=seed_y0,
                                     offset_x=offset_x, n_calls=n_calls,
                                     spp_last=spp_last)).to(dev)
    geom = dict(m_slots=m_slots, n_lanes=n, p_total=p_total, width=width)
    out = (fstate, ustate, scal, vpr, geom)
    return out + (_rebucket_key(fstate, ustate, scene.paged.gscal),) if first_key else out


pack_state_plain.launches = 0


def home_accum(accum_init, p_total, device) -> torch.Tensor:
    """A grid or paged band's pixel sums [p_total, 3] f32 in home (pixel)
    order: ``accum_init`` copied, or zeros.  The step adds each finished
    pixel's sum into its row in place; the rows are never permuted."""
    if accum_init is None:
        return torch.zeros((p_total, 3), dtype=torch.float32, device=device)
    return accum_init.reshape(p_total, 3).to(device=device, dtype=torch.float32,
                                             copy=True)


def unpack_accum(fstate, *, band_h, width, m_slots, n_lanes, p_total):
    """The accumulator rows of a finished brute-force (mega) state ->
    [band_h, width, 3]."""
    from . import megakernel

    acc = fstate[megakernel.R_ACC : megakernel.R_ACC + 3 * m_slots]
    return (acc[:, :n_lanes]
            .reshape(m_slots, 3, n_lanes)
            .permute(0, 2, 1)
            .reshape(m_slots * n_lanes, 3)[:p_total]
            .reshape(band_h, width, 3))


def _render_band_mega(scene, vp, *, band_h, width, y0, seed_y0, offset_x, spp,
                      number, accum_init, max_depth, pixels_per_lane,
                      skip_tmax, backend, rr=None, n_calls=None, spp_last=None,
                      passign=None, iterstats=False, ablate=(), iters=None):
    """Kernel loop: pack the [rows, lanes] state, launch the wavefront step
    until no lane is alive (one host sync per launch).  backend="mega"
    brute-forces the sphere table (ops/megakernel.py) and its accumulator
    rows are unpacked at the end; backend="grid" runs the uniform-grid DDA
    (ops/gridkernel.py, requires grid tables) with identical results: its
    step adds the pixel sums into a home-order accumulator, and before every
    launch the live lanes are compacted (in lane order, their count read in
    the launch's one host sync), so no block runs for a dead lane.  The
    balanced table needs no gather of the carried accumulator and no
    scatter at the end (the JAX driver's slot layout): the step adds each
    chunk into ``acc`` at its pixel."""
    from . import gridkernel, megakernel

    if backend == "grid" and scene.grid is None:
        raise ValueError("grid backend requires a grid-able scene")
    dev = scene.table.device
    with launches.span("band.setup", backend=backend, y0=y0,
                       route=state_route(dev)) as setup:
        if passign is not None:
            passign = torch.as_tensor(passign, dtype=torch.int32, device=dev)
        fstate, ustate, scal, vpr, geom = pack_state(
            scene, vp, backend=backend, band_h=band_h, width=width, y0=y0,
            seed_y0=seed_y0, offset_x=offset_x, spp=spp, number=number,
            accum_init=None if backend == "grid" else accum_init,
            pixels_per_lane=pixels_per_lane, n_calls=n_calls, spp_last=spp_last,
            passign=passign)
        if backend == "grid":
            acc = home_accum(accum_init, geom["p_total"], dev)
        setup.set(n_lanes=geom["n_lanes"], m_slots=geom["m_slots"])
    if backend == "grid":
        k = gridkernel.K_STEPS
        common = dict(geom, max_depth=max_depth, skip_tmax=skip_tmax, rr=rr,
                      k_steps=k, j_steps=gridkernel.J_STEPS, passign=passign,
                      iterstats=iterstats, ablate=ablate)
        rec, index, n_first = launches.NO_RECORD, 0, 0
        while True:
            with launches.section("grid.count"):
                live = live_lanes(ustate[gridkernel.U_ALIVE])
            rec.stamp("t_done")  # the previous launch's
            n_live = live.numel()
            if n_live == 0:
                break
            n_first = n_first or n_live  # the band's first launch's
            with launches.span("grid.launch", index=index, n_live=n_live,
                               n_first=n_first, k=k, device=dev.index) as rec:
                rec.stamp("t_counted")
                if n_live < ustate.shape[1]:
                    with launches.section("grid.compact"):
                        fstate, ustate = gather_lanes(fstate, ustate, live)
                if iters is not None:
                    _count_iters(iters, k, n_live)
                with launches.section("grid.step"):
                    fstate, ustate = gridkernel.grid_megakernel_step(
                        scal, vpr, scene.grid, fstate, ustate, acc, **common)
                rec.stamp("t_issued")
            index += 1
            yield issued(dev)
        return acc.reshape(band_h, width, 3)

    atab = scene.table[:, 8:24].T.contiguous()
    # the valid rows are the table's prefix (prepare_scene)
    n_valid = int(scene.valid.sum())
    common = dict(geom, max_depth=max_depth, skip_tmax=skip_tmax, rr=rr,
                  k_steps=megakernel.K_STEPS)
    while bool((ustate[megakernel.U_ALIVE] != 0).any()):
        if iters is not None:
            _count_iters(iters, megakernel.K_STEPS, ustate.shape[1])
        fstate, ustate = megakernel.megakernel_step(
            scal, vpr, scene.table, atab, fstate, ustate, n_valid=n_valid, **common)
        yield issued(dev)
    return unpack_accum(fstate, band_h=band_h, **geom)


def live_lanes(alive_row):
    """The lanes whose alive row is set, in lane order: [n_live] int64
    indices.  Their count is the grid driver's one host sync per launch."""
    return torch.nonzero(alive_row).reshape(-1)


def _morton(sx, sz):
    """Interleave two 6-bit page coords, so a sorted run of lanes is a
    near-square cluster of pages."""
    def part(v):
        v = (v | (v << 8)) & 0x00F00F
        v = (v | (v << 4)) & 0x0C30C3
        v = (v | (v << 2)) & 0x249249
        return v

    return part(sx) | (part(sz) << 1)


# sort keys beyond every Morton page code (6-bit page coordinates interleave
# to codes up to ~2^17): a fresh ray that misses the grid box, a dead lane
KEY_MISS = 1 << 30
KEY_DEAD = 2**31 - 1


def _rebucket_key(fstate, ustate, gscal):
    """Sort key of each lane, int32 (JAX ``_pred_page``, Morton mode): a
    marching lane's current page, a fresh lane's page where its ray enters
    the grid box, ``KEY_MISS`` if it misses the box, ``KEY_DEAD`` for dead
    lanes, so they sort last.  Pages are keyed at 8x8 fine cells, finer than
    the kernel's 8x16 pages.  (The JAX key's 4096 / 4097 sentinels fall
    among the page codes of a large grid; there they only order lanes, here
    they decide which lanes are kept.)  The paged kernel computes the same
    key in its epilogue; this is its plain version and the first launch's
    key."""
    from . import pagedkernel as pk

    gs = gscal.reshape(-1)
    big = torch.tensor(3e30, dtype=torch.float32, device=fstate.device)
    ox, oy, oz, dx, dy, dz = (fstate[pk.R_O + i] for i in range(6))
    alive = ustate[pk.U_ALIVE] != 0
    marching = ustate[pk.U_MARCH] != 0
    cell = ustate[pk.U_CELL].to(torch.int64)
    page_m = _morton((cell >> 12) >> 3, (cell & 4095) >> 3)

    def axis_clip(o_c, d_c, lo, hi):
        inv = 1.0 / d_c
        ta = (lo - o_c) * inv
        tb = (hi - o_c) * inv
        t0 = torch.minimum(ta, tb)
        t1 = torch.maximum(ta, tb)
        deg = d_c == 0.0
        inside = (o_c >= lo) & (o_c <= hi)
        t0 = torch.where(deg, torch.where(inside, -big, big), t0)
        t1 = torch.where(deg, torch.where(inside, big, -big), t1)
        return t0, t1

    t0x, t1x = axis_clip(ox, dx, gs[P_XLO], gs[P_XHI])
    t0y, t1y = axis_clip(oy, dy, gs[P_YLO], gs[P_YHI])
    t0z, t1z = axis_clip(oz, dz, gs[P_ZLO], gs[P_ZHI])
    tmin = torch.tensor(1e-3, dtype=torch.float32, device=fstate.device)
    t_start = torch.maximum(torch.maximum(t0x, t0y), torch.maximum(t0z, tmin))
    t_end = torch.minimum(torch.minimum(t1x, t1y), t1z)
    pxw = ox + t_start * dx
    pzw = oz + t_start * dz
    zero = torch.zeros_like(tmin)
    icx = torch.minimum(torch.maximum(torch.floor((pxw - gs[P_FMINX]) * gs[P_INVS]),
                                      zero), gs[P_FMAXX])
    icz = torch.minimum(torch.maximum(torch.floor((pzw - gs[P_FMINZ]) * gs[P_INVS]),
                                      zero), gs[P_FMAXZ])
    hits_box = t_start <= t_end
    page_p = _morton(torch.where(hits_box, icx, 0.0).to(torch.int64) >> 3,
                     torch.where(hits_box, icz, 0.0).to(torch.int64) >> 3)
    page_p = torch.where(hits_box, page_p, KEY_MISS)
    key = torch.where(marching, page_m, page_p)
    return torch.where(alive, key, KEY_DEAD).to(torch.int32)


def live_order(key):
    """The live lanes (key != KEY_DEAD) sorted by key, stable: [n_live]
    int64 indices.  Reading n_live is the driver's one host sync per
    launch."""
    perm = torch.argsort(key, stable=True)
    return perm[: int((key != KEY_DEAD).sum())]


def gather_lanes(fstate, ustate, perm):
    """The state's lanes ``perm``, in that order, into new tensors."""
    return fstate.index_select(1, perm), ustate.index_select(1, perm)


def _render_band_paged(scene, vp, *, band_h, width, y0, seed_y0, offset_x,
                       spp, number, accum_init, max_depth, pixels_per_lane,
                       skip_tmax, rr=None, ablate=(), iters=None):
    """Paged-grid driver (JAX ``_render_band_paged``, Morton key, carried
    winner attributes).  Before every launch of ``scaled_k(n)`` iterations
    the live lanes are sorted by page and gathered into the next launch's
    state, which holds only them, so no block runs for dead lanes; the step
    emits the next key.  Pixel identity rides in ``U_LANE0``, and the pixel
    sums stay in home order in ``acc``, so nothing is put back at the end."""
    from . import pagedkernel

    if scene.paged is None:
        raise ValueError("paged backend requires a paged-grid-able scene")
    g = scene.paged
    with launches.span("band.setup", backend="paged", y0=y0,
                       route=state_route(scene.table.device)) as setup:
        fstate, ustate, scal, vpr, geom, key = pack_state(
            scene, vp, backend="paged", band_h=band_h, width=width, y0=y0,
            seed_y0=seed_y0, offset_x=offset_x, spp=spp, number=number,
            pixels_per_lane=pixels_per_lane, first_key=True)
        acc = home_accum(accum_init, geom["p_total"], fstate.device)
        setup.set(n_lanes=geom["n_lanes"], m_slots=geom["m_slots"])
    k = pagedkernel.scaled_k(geom["n_lanes"])
    common = dict(geom, max_depth=max_depth, skip_tmax=skip_tmax, rr=rr, k_steps=k,
                  ablate=ablate)
    rec, index, n_first = launches.NO_RECORD, 0, 0
    while True:
        with launches.section("paged.order"):
            perm = live_order(key)
        rec.stamp("t_done")  # the previous launch's
        n_live = perm.numel()
        if n_live == 0:
            break
        n_first = n_first or n_live  # the band's first launch's
        with launches.span("paged.launch", index=index, n_live=n_live, n_first=n_first,
                           k=k) as rec:
            rec.stamp("t_counted")
            with launches.section("paged.gather"):
                fstate, ustate = gather_lanes(fstate, ustate, perm)
            if iters is not None:
                _count_iters(iters, k, n_live)
            with launches.section("paged.step"):
                fstate, ustate, key = pagedkernel.paged_megakernel_step(
                    scal, vpr, g, fstate, ustate, acc, **common)
            rec.stamp("t_issued")
        index += 1
        yield issued(fstate.device)
    return acc.reshape(band_h, width, 3)
