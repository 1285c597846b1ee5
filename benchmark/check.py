"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, a sample of
the answers drawn from the seed (``check.answers`` of them, the last one
always among them) is rendered again by the plain reference at the pixels
the run sampled (``check.pixels``, drawn from the seed): from the same
inputs (scene, camera, call numbers, samples, depth, mode), regenerated by
the reference's own code.  The number compared is ``px_off``: the share of
those pixels whose program value differs from the reference's, in any
channel, by more than ``check.tolerance`` (relative to the reference's
value, floored at ``check.floor``; 0 for an exact comparison of u8 frames).
An image's channels are its three sums and its three u8 display values, so
a u8 value that differs at all counts (a floor of 1 or more keeps the
tolerance under one step of u8).
An answer whose own share exceeds the limit counts as failed.
"""

from __future__ import annotations

import numpy as np

from .reference import camera, scenes, tracer


def chosen(seed: int, n_answers: int, k: int) -> list:
    """``k`` answer indices drawn from the seed, the last answer among them."""
    from .loops import seed_draws

    rng = np.random.default_rng(int(seed_draws(seed)[4]))
    rest = rng.permutation(max(n_answers - 1, 0))[: max(k - 1, 0)]
    return sorted(set(int(i) for i in rest) | {n_answers - 1})


def reference_values(cfg: dict, answers: list, pixels: np.ndarray, device,
                     dtype=None) -> list:
    """The reference's value of each answer at ``pixels``: [P, 6] float
    sums and their u8 display values (offline) or [P, 3] u8 (frames)."""
    import torch

    dtype = dtype or torch.float32
    vp = camera.viewport(cfg["width"], cfg["height"])
    rr = tuple(cfg["rr"]) if cfg["mode"] == "fast" else None
    out = [None] * len(answers)
    by_time = {}
    for i, a in enumerate(answers):
        by_time.setdefault(a["time"], []).append(i)
    for t, idx in by_time.items():
        scene = scenes.make_scene(cfg["scene"], t)
        if "numbers" in answers[idx[0]]:
            # one pass over every answer of this scene: pixels x calls lanes
            pix = np.concatenate([pixels] * len(idx))
            nums = np.concatenate([np.tile(np.asarray(answers[i]["numbers"], np.int64),
                                           (len(pixels), 1)) for i in idx])
            got = tracer.render_pixels(scene, vp, pix, nums, answers[idx[0]]["spps"],
                                       cfg["max_depth"], rr, device=device, dtype=dtype)
            u8 = tracer.tonemap_u8(got, sum(answers[idx[0]]["spps"]))
            got = torch.cat([got.to(torch.float32), u8.to(torch.float32)], dim=1).cpu().numpy()
            for j, i in enumerate(idx):
                out[i] = got[j * len(pixels):(j + 1) * len(pixels)]
        else:
            for i in idx:
                spp = answers[i]["spp"]
                got = tracer.render_pixels(scene, vp, pixels, np.zeros((len(pixels), 1), np.int64),
                                           [spp], cfg["max_depth"], rr, device=device, dtype=dtype)
                out[i] = tracer.tonemap_u8(got, spp).cpu().numpy()
    return out


def off_share(program: np.ndarray, ref: np.ndarray, tolerance: float, floor: float) -> float:
    """Share of pixels whose value differs from the reference's by more than
    ``tolerance`` x max(|reference|, ``floor``) in some channel."""
    p = np.asarray(program, np.float64)
    r = np.asarray(ref, np.float64)
    bad = np.abs(p - r) > tolerance * np.maximum(np.abs(r), floor)
    bad |= np.isnan(p) != np.isnan(r)
    return float(np.any(bad, axis=1).mean())


def judge(cfg: dict, traffic: dict, seed: int, answers: list, pixels: np.ndarray, device,
          program_values=None) -> dict:
    """Compare a seeded sample of ``answers`` with the reference.  Returns
    ``correct``, ``failed`` (answers over the limit), and ``numbers``:
    {name: {"value", "limit"}}.  ``program_values``: values to judge in the
    program's place (the control), one per chosen answer."""
    chk = traffic["check"]
    idx = chosen(seed, len(answers), int(chk["answers"]))
    picked = [answers[i] for i in idx]
    refs = reference_values(cfg, picked, pixels, device)
    values = program_values if program_values is not None else [a["values"] for a in picked]
    tol, floor = float(chk["tolerance"]), float(chk.get("floor", 0.0))
    limit = float(chk["limit"])
    shares = [off_share(v, r, tol, floor) for v, r in zip(values, refs)]
    px_off = float(np.mean(shares))
    return dict(correct=px_off <= limit, failed=sum(s > limit for s in shares),
                numbers={"px_off": {"value": px_off, "limit": limit}})
