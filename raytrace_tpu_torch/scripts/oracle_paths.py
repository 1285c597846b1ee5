"""What the oracle studies share: the book scene's grid march replayed per
path segment, and the reference camera's jittered sample rays.

The studies (``straggler_stats``, ``path_stats``, ``rr_study``,
``rr_efficiency``) run the port's CPU oracle (``oracle/cpu_reference.py``)
with its numpy RNG (``oracle/rng_np.py``) over sampled pixels of the book
scene at 1920x1080, and count per segment what the grid kernel would march:
the cells of the 2-D DDA from the ray's entry into the grid box up to the
nearest hit of a large ("global") sphere or the box's exit, at most 61.
The arithmetic is the JAX scripts' (float64 around the f32 tables, the same
op order), so each study prints the numbers its JAX counterpart prints.
Numpy on the host only: no kernel runs.
"""

from __future__ import annotations

import numpy as np

from ..models.grid import build_grid
from ..models.scene import generate_random_scene
from ..ops.intersect import sphere_table
from ..ops.trace import viewport_arrays
from ..oracle import rng_np as rngops
from ..runtime.renderer import reference_camera

W, H = 1920, 1080
BIG = 3e30


def _slab(oc, dc, lo, hi):
    if dc == 0.0:
        return (-BIG, BIG) if lo <= oc <= hi else (BIG, -BIG)
    ta, tb = (lo - oc) / dc, (hi - oc) / dc
    return min(ta, tb), max(ta, tb)


class BookMarch:
    """The book scene, its grid box and its global spheres."""

    def __init__(self):
        self.scene = sc = generate_random_scene(0.0)
        gs = np.asarray(build_grid(sc, sphere_table(sc)).gscal)[0]
        self.box = gs[0], gs[1], gs[2], gs[3], gs[4], gs[5]
        self.cmin = gs[6], gs[7]
        self.cmax = gs[10], gs[11]
        self.glob = [i for i in range(int(sc.n_spheres)) if sc.radii[i] > 0.49]

    def glob_t(self, o, d):
        """Nearest t >= 1e-3 over the global spheres (float64), else BIG:
        the march's pruning bound."""
        tg = BIG
        for i in self.glob:
            oc = np.asarray(o, np.float64) - self.scene.centers[i]
            dd = np.asarray(d, np.float64)
            a = float(dd @ dd)
            b = float(oc @ dd)
            c = float(oc @ oc) - float(self.scene.radii[i]) ** 2
            disc = b * b - a * c
            if disc >= 0:
                for t in ((-b - np.sqrt(disc)) / a, (-b + np.sqrt(disc)) / a):
                    if 1e-3 <= t < tg:
                        tg = t
                        break
        return tg

    def cells(self, o, d, t_glob):
        """Cells the DDA marches for one segment (float64 ``o``, ``d``): 0
        when the ray misses the box or a global is hit before it, else the
        cells entered up to ``t_glob`` or the box's exit, at most 61."""
        xlo, xhi, ylo, yhi, zlo, zhi = self.box
        t0x, t1x = _slab(o[0], d[0], xlo, xhi)
        t0y, t1y = _slab(o[1], d[1], ylo, yhi)
        t0z, t1z = _slab(o[2], d[2], zlo, zhi)
        ts = max(t0x, t0y, t0z, 1e-3)
        te = min(t1x, t1y, t1z)
        if ts > te or ts >= t_glob:
            return 0
        px, pz = o[0] + ts * d[0], o[2] + ts * d[2]
        icx = np.clip(np.floor(px + 0.5), self.cmin[0], self.cmax[0])
        icz = np.clip(np.floor(pz + 0.5), self.cmin[1], self.cmax[1])
        bx = icx + (0.5 if d[0] >= 0 else -0.5)
        bz = icz + (0.5 if d[2] >= 0 else -0.5)
        tnx = BIG if d[0] == 0 else (bx - o[0]) / d[0]
        tnz = BIG if d[2] == 0 else (bz - o[2]) / d[2]
        dtx = BIG if d[0] == 0 else abs(1.0 / d[0])
        dtz = BIG if d[2] == 0 else abs(1.0 / d[2])
        n = 1
        while True:
            t_exit = min(tnx, tnz)
            if t_exit >= t_glob or t_exit >= te or n > 60:
                return n
            if tnx <= tnz:
                icx += np.sign(d[0])
                tnx += dtx
            else:
                icz += np.sign(d[2])
                tnz += dtz
            n += 1

    def segment_cells(self, o, d):
        """``cells`` of the segment (o, d), its global bound included."""
        return self.cells(np.asarray(o, np.float64), np.asarray(d, np.float64),
                          self.glob_t(o, d))


def ray_color_rr(march: BookMarch, o, d, seed, max_depth, d0, d1, p_of):
    """The oracle's ``_ray_color`` with Russian roulette, counting the
    kernel's iterations per segment at J = 2: max(1, ceil(cells / 2)).
    After a scatter at depth + 1 >= ``d0`` the path survives with
    p = ``p_of(throughput)`` (halved from depth + 1 >= ``d1``) and its
    throughput is divided by p; ``d0`` None is the exact path.  Returns
    (seed, rgb, iterations)."""
    from ..config import MAX_RAY_COLLISION_DISTANCE, T_MIN
    from ..oracle import cpu_reference as orc

    F = np.float32
    sc = march.scene
    reflected = np.ones(3, np.float32)
    light = np.zeros(3, np.float32)
    iters = 0
    for depth in range(max_depth):
        iters += max(1, -(-march.segment_cells(o, d) // 2))
        i, t = orc._closest_hit(sc, o, d, F(T_MIN), F(MAX_RAY_COLLISION_DISTANCE))
        if i < 0:
            light = orc.SKY_COLOR
            break
        point = o + t * d
        outward = orc._normalize(point - sc.centers[i])
        front_face = np.dot(d, outward) < 0
        normal = outward if front_face else -outward
        attenuation = orc._texture_color(sc, i, point)
        seed, sd = orc._scatter(sc, i, d, normal, front_face, seed)
        if sd is None:
            light = attenuation
            break
        reflected = reflected * attenuation
        o = point
        d = orc._normalize(sd).astype(np.float32)
        if d0 is not None and depth + 1 >= d0:
            p = p_of(reflected)
            if d1 is not None and depth + 1 >= d1:
                p *= 0.5
            seed, u = rngops.random_float(seed)
            if u >= p:
                break  # killed: contributes reflected * 0
            reflected = reflected / F(p)
    return seed, reflected * light, iters


class Camera:
    """The reference camera's sample rays at W x H (shader.rgen)."""

    def __init__(self):
        vp = viewport_arrays(reference_camera(), W, H)
        self.up = np.asarray(vp.upper_left)
        self.hor = np.asarray(vp.horizontal)
        self.ver = np.asarray(vp.vertical)
        self.frm = np.asarray(vp.look_from)
        self.origin = self.frm.astype(np.float32)

    @staticmethod
    def seed(px, py):
        return rngops.tea_hash(rngops.tea_hash(np.uint32(px), np.uint32(py)), np.uint32(0))

    def sample(self, seed, px, py):
        """(seed, f32 direction) of the pixel's next sample: two jitter
        draws, the direction (vertical subtracted, as shader.rgen:58), and
        the two aperture draws (no-ops at this camera's aperture)."""
        seed, r1 = rngops.random_float(seed)
        seed, r2 = rngops.random_float(seed)
        u = (px + r1) / W
        v = (py + r2) / H
        d = self.up + u * self.hor - v * self.ver - self.frm
        seed, _ = rngops.random_float(seed)
        seed, _ = rngops.random_float(seed)
        return seed, d.astype(np.float32)


def host_label(device) -> str:
    """The line the studies end with: their numbers come from the host."""
    from .bench_gather import card_label

    return f"(numpy oracle on the host CPU; device {card_label(device)})"


def parse(prog, doc, argv, n_px, spp):
    """The studies' arguments: [n_pixels] [spp] and ``--device``."""
    import argparse

    from ..runtime.renderer import render_device

    ap = argparse.ArgumentParser(prog=f"python -m raytrace_tpu_torch.scripts.{prog}",
                                 description=doc.splitlines()[0])
    ap.add_argument("n_px", nargs="?", type=int, default=n_px, help=f"pixels ({n_px})")
    ap.add_argument("spp", nargs="?", type=int, default=spp, help=f"samples per pixel ({spp})")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return args.n_px, args.spp, render_device(args.device)
