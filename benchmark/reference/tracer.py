"""Plain path tracer: chosen pixels, every sphere tested, the GLSL sample stream.

Semantics of the reference renderer (shaders/shader.rgen, rint, rchit,
rmiss, random.glsl) in the float32 operation order the port states for
itself (no contraction, round-to-nearest square root and divide, sums left
to right):

- a pixel's call starts from ``tea(tea(x, y), number)`` and renders its
  ``spp`` samples one after another, the LCG stream carried from sample to
  sample; each sample draws the jitter and two lens values, then traces
  up to ``max_depth`` segments;
- a segment's closest hit is the least root over all spheres of the
  expanded quadratic ``b = o.d - c.d``, ``c = o.o - 2 c.o + (|c|^2 - r^2)``
  (the last term computed in float64), the lower index winning a tie;
- shading draws three values for a diffuse or metal hit and one for glass
  that can refract, as the GLSL does; fast mode's Russian roulette draws
  one value for every segment that would continue, survival
  ``p = min(1, max(pmin, max(throughput)))``, halved from depth ``d1``;
- a call's samples are summed in float32 from zero, and the calls of a
  pixel are added to its sum in call order.

Everything is plain torch on any device.  Lanes are (pixel, call) pairs;
each step traces one segment of every live lane, and a lane's vectors are
rows of [lanes, 3] tensors (elementwise, so each component's operations are
the scalar ones; dot products are summed x + y + z explicitly).  On a CUDA
device the step is recorded once as a CUDA graph of ``GRAPH_STEPS`` steps
and replayed until no lane is alive: the same operations, launched without
the host in the loop (a step of a dead lane changes nothing).  ``dtype``
sets the float type of the whole computation (the control computes in
bfloat16).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .scenes import CHECKERED, METAL, REFRACTIVE, Scene

MASK = 0xFFFFFFFF
BIG = 3.0e38
T_MIN = 0.001
T_MAX = 10000.0
SKY = (0.7, 0.8, 1.0)
SPHERE_CHUNK = 1 << 15  # spheres tested per pass (bounds the [lanes, spheres] temporaries)
GRAPH_STEPS = 16


def _tea(v0: torch.Tensor, v1: torch.Tensor) -> torch.Tensor:
    """getRandomSeed: TEA, 16 rounds, on u32 values held in int64."""
    v0, v1 = torch.broadcast_tensors(v0 & MASK, v1 & MASK)
    s = 0
    for _ in range(16):
        s = (s + 0x9E3779B9) & MASK
        v0 = (v0 + ((((v1 << 4) + 0xA341316C) ^ (v1 + s)) ^ ((v1 >> 5) + 0xC8013EA4))) & MASK
        v1 = (v1 + ((((v0 << 4) + 0xAD90777D) ^ (v0 + s)) ^ ((v0 >> 5) + 0x7E95761E))) & MASK
    return v0


def _dot(a, b):
    p = a * b
    return p[:, 0] + p[:, 1] + p[:, 2]


class _Stream:
    """The float helpers of one dtype and device."""

    def __init__(self, dtype, device):
        self.dtype, self.device = dtype, device
        self.one = torch.ones((), dtype=dtype, device=device)

    def rand(self, seed):
        """randomFloat: one LCG step, the low 24 bits over 2^24."""
        seed = (seed * 1664525 + 1013904223) & MASK
        return seed, (seed & 0xFFFFFF).to(self.dtype) / 16777216.0

    def rand_pm1(self, seed):
        seed, r = self.rand(seed)
        return seed, r * 2.0 + -1.0

    def sqrt(self, x):
        """Round-to-nearest square root (taken in float64, rounded once)."""
        return torch.sqrt(x.to(torch.float64)).to(self.dtype)

    def unit(self, v):
        """v / |v| as v * (1 / sqrt(v.v)), rows of [L, 3]."""
        return v * (self.one / self.sqrt(_dot(v, v)))[:, None]


def scene_tensors(scene: Scene, dtype, device) -> dict:
    """The scene on ``device``: centres, |c|^2 - r^2 (float64, rounded once),
    and the shading attributes."""
    c64 = scene.centers.astype(np.float64)
    kc = (np.sum(c64 * c64, axis=1) - scene.radii.astype(np.float64) ** 2).astype(np.float32)

    def t(a, dt=dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dt)

    return dict(cx=t(scene.centers[:, 0]), cy=t(scene.centers[:, 1]), cz=t(scene.centers[:, 2]),
                kc=t(kc), center=t(scene.centers), mat=t(scene.material, torch.int64),
                tex=t(scene.texture, torch.int64), c0=t(scene.color0), c1=t(scene.color1),
                attr=t(scene.attr))


def _closest(sc: dict, o, d, st: _Stream):
    """(t, index, hit) of the closest hit over all spheres; t = BIG on a
    miss."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    a = _dot(d, d)[:, None]
    od = _dot(o, d)[:, None]
    oo = _dot(o, o)[:, None]
    inv_a = st.one / a
    big = torch.full_like(a[:, 0], BIG)
    best_t, best_i = big, torch.zeros(big.shape, dtype=torch.int64, device=big.device)
    n = sc["cx"].shape[0]
    for s0 in range(0, n, SPHERE_CHUNK):
        cx, cy, cz, kc = (sc[k][None, s0:s0 + SPHERE_CHUNK] for k in ("cx", "cy", "cz", "kc"))
        cd = cx * dx + cy * dy + cz * dz
        co = cx * ox + cy * oy + cz * oz
        b = od - cd
        c = oo - 2.0 * co + kc
        disc = b * b - a * c
        sq = st.sqrt(disc)  # NaN where disc < 0: every test below fails
        t1 = (-b - sq) * inv_a
        t2 = (-b + sq) * inv_a
        ok1 = (t1 >= T_MIN) & (t1 <= T_MAX)
        ok2 = (t2 >= T_MIN) & (t2 <= T_MAX)
        tt = torch.where(ok1, t1, torch.where(ok2, t2, big[:, None]))
        t_min, i_min = torch.min(tt, dim=1)  # the first least index
        better = t_min < best_t
        best_t = torch.where(better, t_min, best_t)
        best_i = torch.where(better, i_min + s0, best_i)
    return best_t, best_i, best_t < big


def _camera(vp: dict, seed, fx, fy, st: _Stream):
    """getCameraRay with the pixel jitter: four draws."""
    seed, jx = st.rand(seed)
    seed, jy = st.rand(seed)
    u = ((fx + jx) / vp["width"])[:, None]
    w = ((fy + jy) / vp["height"])[:, None]
    seed, r1 = st.rand_pm1(seed)
    seed, r2 = st.rand_pm1(seed)
    inv_l = st.one / st.sqrt(r1 * r1 + r2 * r2)
    ap = vp["aperture"] * 0.5
    rx = (ap * (r1 * inv_l))[:, None]
    ry = (ap * (r2 * inv_l))[:, None]
    o = vp["look_from"] + vp["right"] * rx + vp["up"] * ry
    tgt = vp["upper_left"] + vp["horizontal"] * u - vp["vertical"] * w
    return seed, o, st.unit(tgt - o)


def _shade(sc: dict, idx, o, d, t, seed, st: _Stream):
    """shader.rchit: hit point, albedo, scatter direction (not normalised),
    whether it scatters, and the seed after the material's draws."""
    px = o + t[:, None] * d
    n = st.unit(px - sc["center"][idx])
    ddn = _dot(n, d)
    front = ddn < 0.0
    n = torch.where(front[:, None], n, -n)
    ndd = torch.where(front, ddn, -ddn)

    tex, mat, fuzz = sc["tex"][idx], sc["mat"][idx], sc["attr"][idx]
    s = torch.sin(6.0 * px)
    sines = s[:, 0] * s[:, 1] * s[:, 2]
    use_c1 = (tex == CHECKERED) & ~(sines > 0.0)
    att = torch.where(use_c1[:, None], sc["c1"][idx], sc["c0"][idx])

    seed3, ux = st.rand_pm1(seed)
    seed3, uy = st.rand_pm1(seed3)
    seed3, uz = st.rand_pm1(seed3)
    u = st.unit(torch.stack([ux, uy, uz], dim=1))
    seed1, refr_draw = st.rand(seed)

    diffuse = n + u
    near0 = (diffuse.abs() < 1e-8).all(dim=1, keepdim=True)
    diffuse = torch.where(near0, n, diffuse)

    refl = d - (2.0 * ndd)[:, None] * n
    metal = st.unit(refl + fuzz[:, None] * u)
    metal_scatters = _dot(metal, n) > 0.0

    eta = torch.where(front, st.one / fuzz, fuzz)
    cos_t = -ndd
    omc2 = 1.0 - ndd * ndd
    can_refract = (eta * st.sqrt(omc2)) <= 1.0  # NaN compares false, as in GLSL
    q = (1.0 - eta) / (1.0 + eta)
    r0 = q * q
    om = 1.0 - cos_t
    om2 = om * om
    reflectance = r0 + (1.0 - r0) * om2 * om2 * om
    refracts = can_refract & (reflectance < refr_draw)
    k = 1.0 - eta * eta * omc2
    sqk = st.sqrt(torch.clamp(k, min=0.0))
    glass = torch.where(refracts[:, None], eta[:, None] * d - (eta * ndd + sqk)[:, None] * n, refl)

    is_metal, is_glass = mat == METAL, mat == REFRACTIVE
    sd = torch.where(is_metal[:, None], metal, torch.where(is_glass[:, None], glass, diffuse))
    scatters = metal_scatters | ~is_metal
    seed_h = torch.where(is_glass, torch.where(can_refract, seed1, seed), seed3)
    return px, att, sd, scatters, seed_h


def render_pixels(scene: Scene, vp: dict, pixels: np.ndarray, numbers: np.ndarray,
                  spps: Sequence[int], max_depth: int, rr: Optional[Sequence] = None, *,
                  device="cpu", dtype=torch.float32, stats: Optional[dict] = None) -> torch.Tensor:
    """The summed colour [P, 3] (``dtype``) of each pixel of ``pixels``
    ([P, 2] int x, y: global image coordinates) over its calls: call c of
    pixel p has the number ``numbers[p, c]`` and ``spps[c]`` samples, and
    the calls are added in that order.  ``rr`` = (d0, d1, pmin) is fast
    mode; None the exact stream.  ``stats``: a dict that receives the
    events counted over all lanes (samples, segments, hits, bounces:
    segments that continue)."""
    dev = torch.device(device)
    st = _Stream(dtype, dev)
    sc = scene_tensors(scene, dtype, dev)
    vpt = {k: torch.as_tensor(np.asarray(v, np.float32), device=dev).to(dtype)
           for k, v in vp.items()}
    pix = torch.as_tensor(np.asarray(pixels, np.int64).reshape(-1, 2), device=dev)
    n_pix, n_calls = pix.shape[0], len(spps)
    nums = np.asarray(numbers, np.int64).reshape(n_pix, n_calls) & MASK
    lane_px = pix[:, 0].repeat(n_calls)
    lane_py = pix[:, 1].repeat(n_calls)
    lane_num = torch.as_tensor(np.ascontiguousarray(nums.T).ravel(), device=dev)
    spp = torch.tensor([int(c) for c in spps], device=dev).repeat_interleave(n_pix)
    fx, fy = lane_px.to(dtype), lane_py.to(dtype)
    sky = torch.tensor(SKY, dtype=dtype, device=dev).expand(len(fx), 3)
    one = torch.ones_like(fx)

    seed, o, d = _camera(vpt, _tea(_tea(lane_px, lane_py), lane_num), fx, fy, st)
    state = dict(o=o, d=d, thr=torch.ones_like(o), cur=torch.zeros_like(o), seed=seed,
                 depth=torch.zeros_like(spp), sidx=torch.ones_like(spp), alive=spp > 0)
    counts = {k: torch.zeros((), dtype=torch.int64, device=dev)
              for k in ("samples", "segments", "hits", "bounces")}
    counts["samples"] += state["alive"].sum()

    def step():
        s = state
        o, d, thr, seed, depth, alive = s["o"], s["d"], s["thr"], s["seed"], s["depth"], s["alive"]
        t, idx, hit = _closest(sc, o, d, st)
        px, att, sd, scatters, seed_h = _shade(sc, idx, o, d, t, seed, st)
        cont = alive & hit & scatters & ~((depth + 1) >= max_depth)
        nt = thr * att
        seed_a = torch.where(hit, seed_h, seed)
        if rr is not None:
            dnext = depth + 1
            p = torch.minimum(one, torch.maximum(torch.full_like(one, float(np.float32(rr[2]))),
                              torch.maximum(nt[:, 0], torch.maximum(nt[:, 1], nt[:, 2]))))
            if int(rr[1]):
                p = torch.where(dnext >= int(rr[1]), p * 0.5, p)
            considered = cont & (dnext >= int(rr[0]))
            seed_rr, u_rr = st.rand(seed_a)
            cont = cont & ~(considered & (u_rr >= p))
            nt = torch.where(considered[:, None], nt / p[:, None], nt)
            seed_a = torch.where(considered, seed_rr, seed_a)
        term = alive & ~cont
        light = torch.where(hit[:, None], torch.where(scatters[:, None], 0.0, att), sky)
        cur = torch.where(term[:, None], s["cur"] + thr * light, s["cur"])
        more = term & (s["sidx"] < spp)
        seed_r, co, cdir = _camera(vpt, seed_a, fx, fy, st)
        c3, m3 = cont[:, None], more[:, None]
        new = dict(
            o=torch.where(c3, px, torch.where(m3, co, o)),
            d=torch.where(c3, st.unit(sd), torch.where(m3, cdir, d)),
            thr=torch.where(c3, nt, torch.where(m3, 1.0, thr)),
            cur=cur,
            seed=torch.where(cont, seed_a, torch.where(more, seed_r, seed)),
            depth=torch.where(cont, depth + 1, torch.where(more, 0, depth)),
            sidx=s["sidx"] + more.to(spp.dtype),
            alive=cont | more)
        counts["segments"] += alive.sum()
        counts["hits"] += (alive & hit).sum()
        counts["bounces"] += cont.sum()
        counts["samples"] += more.sum()
        for k, v in new.items():  # last: the names above alias the state
            s[k].copy_(v)

    def steps():
        for _ in range(GRAPH_STEPS):
            step()

    if dev.type == "cuda":
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            steps()  # eager warm-up before the capture: real steps
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            steps()
        run = graph.replay
    else:
        run = steps
    while bool(state["alive"].any()):
        run()

    cur = state["cur"]
    out = torch.zeros((n_pix, 3), dtype=dtype, device=dev)
    for c in range(n_calls):
        out = out + cur[c * n_pix:(c + 1) * n_pix]
    if stats is not None:
        for k, v in counts.items():
            stats[k] = stats.get(k, 0) + int(v)
    return out


def tonemap_u8(total: torch.Tensor, spp: int) -> torch.Tensor:
    """The display value: sqrt(max(sum / spp, 0)) clamped to [0, 1], times
    255, rounded half to even, as u8."""
    x = total.to(torch.float32) / torch.full_like(total, float(spp), dtype=torch.float32)
    x = torch.sqrt(torch.clamp(x, min=0.0).to(torch.float64)).to(torch.float32)
    return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)
