"""The traffic generator: one closed loop per traffic mix, driven by data.

A traffic file (``traffic/<name>.json``) picks a loop and its parameters:

- ``"loop": "offline"``: one user renders whole images of ``spp`` samples
  per pixel back to back, each tonemapped and read back to the host as
  ``render_u8`` hands it over.  ``"entry":
  "renderer"`` drives ``Renderer`` on one device with the dispatches that
  ``Renderer.render`` issues (its call merge and balanced tables when the
  configuration asks for them); ``"entry": "bands"`` drives
  ``MultiChipRenderer`` (the entry of ``api.render_image`` with
  ``chips > 1``) over the cell's devices, a call at a time as its
  ``render`` does.  Image k renders the progressive calls numbered from
  ``number0 + k * calls`` (``number0`` from the seed), so every image of a
  run, and every seed, has its own sample stream at the same cost.
- ``"loop": "frames"``: one viewer of the animated scene; frame i
  generates the scene at ``t0 + i * dt`` (``t0`` from the seed), hands it
  to ``Renderer.set_scene``, renders one call and reads the tonemapped u8
  image back.

An image or frame started before ``--seconds`` runs to its end.  Each
answer keeps its start and end on the host clock, its pixel-samples, what
it rendered (numbers, time) and its values at the pixels the check
samples: a frame's u8 values; an image's accumulated sums (gathered on the
device) beside its u8 values.
"""

from __future__ import annotations

import time

import numpy as np

from .tracing import DeviceTrace, Spans


def seed_draws(seed: int, n: int = 8) -> np.ndarray:
    """``n`` u32 values that a run derives from its seed (any whole number)."""
    return np.random.SeedSequence(int(seed)).generate_state(n, dtype=np.uint32)


def sample_pixels(seed: int, width: int, height: int, n: int) -> np.ndarray:
    """``n`` distinct pixels [n, 2] (x, y) drawn from the seed."""
    rng = np.random.default_rng(int(seed_draws(seed)[3]))
    flat = rng.choice(width * height, size=min(n, width * height), replace=False)
    return np.stack([flat % width, flat // width], axis=1).astype(np.int64)


def _sync(devices) -> None:
    import torch

    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


class Session:
    """One run of a cell: ``setup`` builds the program's objects and warms
    them up, ``window`` runs the loop, ``release`` frees the program's
    state."""

    def __init__(self, cell: dict, seed: int, devices, trace: bool = False):
        self.cfg = cell["config_data"]
        self.traffic = cell["traffic_data"]
        self.devices = list(devices)
        self.draws = seed_draws(seed)
        self.spans = Spans(profiled=trace)
        self.trace = trace
        self.trace_summary = None
        self.answers = []
        self.counters = {}
        self.window_start = self.window_end = None
        self.pixels = sample_pixels(seed, self.cfg["width"], self.cfg["height"],
                                    int(self.traffic["check"]["pixels"]))
        self.number0 = int(self.draws[0]) % (1 << 30)

    # ---- inputs from the seed -------------------------------------------
    def scene_time(self, i: int = 0) -> float:
        if self.traffic["loop"] == "frames":
            t0 = float(self.draws[2]) / 2.0**32 * float(self.traffic["t0_span"])
            return t0 + i * float(self.traffic["dt"])
        return float(self.cfg["scene"].get("time", 0.0))

    def program_scene(self, t: float):
        from raytrace_tpu_torch.models.scene import generate_random_scene, random_sphere_field

        sc = self.cfg["scene"]
        if sc["kind"] == "book":
            return generate_random_scene(t)
        if sc["kind"] == "sphere_field":
            # the configuration fixes the layout: every seed renders the
            # same deployment, and picks only the sample stream
            return random_sphere_field(int(sc["count"]), seed=int(sc.get("seed", 0)),
                                       extent=float(sc.get("extent", 50.0)), t=t)
        raise ValueError(f"unknown scene kind {sc['kind']!r}")

    def render_config(self, samples: int):
        from raytrace_tpu_torch.config import RenderConfig
        from raytrace_tpu_torch.runtime.chips import profile_for

        cfg = self.cfg
        prof = profile_for()
        return RenderConfig(
            samples=samples, width=cfg["width"], height=cfg["height"],
            max_depth=cfg["max_depth"], backend=cfg["backend"], mode=cfg["mode"],
            rr_params=tuple(cfg["rr"]) if cfg["mode"] == "fast" else None,
            samples_per_call=min(prof.samples_per_call, samples),
            calls_per_exec=prof.calls_per_exec if cfg.get("call_merge") else 1,
            balance_spp=int(cfg.get("balance_spp", 0)), chips=len(self.devices),
            scene_time=self.scene_time(0))

    # ---- set-up -----------------------------------------------------------
    def setup(self) -> None:
        spp = int(self.traffic["spp"])
        self.rc = self.render_config(spp)
        scene = self.program_scene(self.scene_time(0))
        entry = self.traffic.get("entry", "renderer")
        if entry == "bands":
            from raytrace_tpu_torch.parallel.sharding import MultiChipRenderer

            self.r = MultiChipRenderer(self.rc, scene=scene, devices=self.devices)
        else:
            from raytrace_tpu_torch.runtime.renderer import Renderer

            self.r = Renderer(self.rc, scene=scene, device=self.devices[0])
            if self.rc.balance_spp and self.r.backend == "grid":
                self.r.enable_balance()
        self.entry = entry
        # warm-up at the cell's shapes: the dispatch structure of an answer
        # at one sample per call (builds or loads the kernels)
        if self.traffic["loop"] == "frames":
            for i in range(int(self.traffic.get("warmup_frames", 3))):
                self._frame(self.scene_time(-1 - i), record=False)
        else:
            self._image(self.number0 + (1 << 30), warm=True)
        _sync(self.devices)

    # ---- one answer -------------------------------------------------------
    def calls(self) -> list:
        """The spp of each progressive call of an image: the card profile's
        samples per call, the last call the rest."""
        from raytrace_tpu_torch.runtime.chips import profile_for

        total = int(self.traffic["spp"])
        per = min(profile_for().samples_per_call, total)
        return [min(per, total - d) for d in range(0, total, per)]

    def image_answer(self, k: int) -> dict:
        """What image ``k`` of the window renders: its call numbers and spp."""
        spps = self.calls()
        return dict(numbers=[self.number0 + k * len(spps) + c for c in range(len(spps))],
                    spps=spps, time=self.scene_time(0))

    def _image(self, number: int, warm: bool = False):
        """One whole image from call ``number`` on, tonemapped and read back
        as ``Renderer.render_u8`` does; returns the u8 image [H, W, 3] and
        the sums and u8 values at the checked pixels [P, 6].  ``warm``: one
        sample per call."""
        import torch

        from raytrace_tpu_torch.ops.image import accum_to_u8

        spps = self.calls()
        if warm:
            spps = [1] * len(spps)
        r = self.r
        accum = None
        if self.entry == "bands":
            for c, spp in enumerate(spps):
                with self.spans.span("render_call"):
                    accum = r.render_call(spp, number=number + c, accum=accum)
        else:
            # Renderer.render's dispatches: up to calls_per_exec calls
            # merged on the grid backend, else one call at a time
            group = max(1, self.rc.calls_per_exec) if r.backend == "grid" else 1
            c = 0
            while c < len(spps):
                nc = min(group, len(spps) - c)
                with self.spans.span("render_call"):
                    if nc > 1:
                        accum = r.render_call(spps[c], number=number + c, accum=accum,
                                              n_calls=nc, spp_last=spps[c + nc - 1])
                    else:
                        accum = r.render_call(spps[c], number=number + c, accum=accum)
                c += nc
        with self.spans.span("readback"):
            img = accum_to_u8(accum, sum(spps)).cpu().numpy()
        pix = torch.as_tensor(self.pixels, device=accum.device)
        sums = accum[pix[:, 1], pix[:, 0]].cpu().numpy()
        return img, np.concatenate(
            [sums, img[self.pixels[:, 1], self.pixels[:, 0]].astype(sums.dtype)], axis=1)

    def _frame(self, t: float, record: bool = True):
        from raytrace_tpu_torch.ops.image import accum_to_u8

        spp = self.rc.samples
        t_start = time.perf_counter()
        with self.spans.span("scene_gen"):
            scene = self.program_scene(t)
        with self.spans.span("set_scene"):
            self.r.set_scene(scene)
        with self.spans.span("render_call"):
            acc = self.r.render_call(spp)
        with self.spans.span("readback"):
            img = accum_to_u8(acc, spp).cpu().numpy()
        t_end = time.perf_counter()
        if record:
            self.answers.append(dict(
                start=t_start, end=t_end, samples=img.shape[0] * img.shape[1] * spp,
                time=t, spp=spp, values=img[self.pixels[:, 1], self.pixels[:, 0]].copy()))

    # ---- the window -------------------------------------------------------
    def _launch_counts(self) -> dict:
        from raytrace_tpu_torch.ops import gridkernel, pagedkernel

        return {"grid": gridkernel.grid_megakernel_step.launches
                + gridkernel.grid_megakernel_step_plain.launches,
                "paged": pagedkernel.paged_megakernel_step.launches
                + pagedkernel.paged_megakernel_step_plain.launches}

    def window(self, seconds: float) -> None:
        tr = self.traffic
        tracer = DeviceTrace(self.devices) if self.trace else None
        before = self._launch_counts()
        self.spans.durations.clear()
        self.window_start = t0 = time.perf_counter()
        if tr["loop"] == "frames":
            i = 0
            trace_at, trace_for = float(tr["trace_start_s"]), float(tr["trace_seconds"])
            tracing = False
            while time.perf_counter() - t0 < seconds or (tracer and self.trace_summary is None):
                now = time.perf_counter() - t0
                if tracer and not tracing and self.trace_summary is None and now >= trace_at:
                    tracer.start()  # CUPTI's start takes seconds: count from its end
                    tracing, traced_from = True, time.perf_counter() - t0
                elif tracing and now - traced_from >= trace_for:
                    self.trace_summary = tracer.stop()
                    tracing = False
                self._frame(self.scene_time(i))
                i += 1
            if tracing:
                self.trace_summary = tracer.stop()
        else:
            k = 0
            traced = int(tr.get("trace_image", 1))
            while time.perf_counter() - t0 < seconds or (tracer and k <= traced):
                plan = self.image_answer(k)
                if tracer and k == traced:
                    tracer.start()
                t_start = time.perf_counter()
                with self.spans.span("image"):
                    img, values = self._image(plan["numbers"][0])
                t_end = time.perf_counter()
                if tracer and k == traced:
                    self.trace_summary = tracer.stop()
                self.answers.append(dict(
                    plan, start=t_start, end=t_end,
                    samples=img.shape[0] * img.shape[1] * sum(plan["spps"]), values=values))
                k += 1
        self.window_end = self.answers[-1]["end"]
        after = self._launch_counts()
        self.counters = {f"launches.{k}": after[k] - before[k] for k in after}
        stats = getattr(self.r, "balance_stats", None)
        if stats:
            self.counters["balance_max_over_mean"] = max(
                s["max_over_mean"] for s in stats.values())

    def release(self) -> None:
        """Free the program's objects (before the reference runs)."""
        import torch

        self.r = None
        if any(d.type == "cuda" for d in self.devices):
            _sync(self.devices)
            torch.cuda.empty_cache()
