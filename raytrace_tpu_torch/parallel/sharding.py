"""Row bands over several devices: the static equal split.

Port of ``raytrace_tpu/parallel/sharding.py`` (the reference's multi-GPU
spatial split, ray_trace.cpp:74-105): the image is split into horizontal
row bands, one per device, the scene replicated.  Where JAX runs one
``shard_map`` program over a device mesh, the port renders each band with
``ops/trace.render_band_steps``, every band stepped from the calling thread
as soon as its last launch has completed, each on a CUDA stream of its own
(``devices.run_in_turns``), and concatenates the bands; devices that are
the same device share one copy of the scene tables.  On the grid backend
each band runs ``Renderer``'s operating point: its own balanced lane
tables and merged calls.  Spans (``ops/launches.py``): ``bands.call``
around a call, a ``bands.band`` per band in it, ``bands.gather``, and
``bands.balance`` around the tables' probes.

Seed semantics (``reference_banding``):
- ``False`` (default): every band seeds from global pixel rows, so an
  N-band render is bit-identical to the single-device render.
- ``True``: bands seed from band-local rows like the reference's per-GPU
  launches (shader.rgen:40, per-device offset at :45): statistically the
  same image, another sample stream.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..config import RenderConfig
from ..models.scene import SceneArrays, generate_random_scene
from ..ops import image as imageops
from ..ops import launches
from ..ops.trace import (LANE_PAD, device_scene_from_numpy, prepare_scene,
                         render_band_steps, tmax_never_binds, viewport_arrays)
from ..runtime.renderer import (band_layout, config_camera, render_device,
                                resolve_backend)
from . import devices as pdev
from .devices import pick_devices, run_in_turns


def upload_per_device(scene: SceneArrays, devices: Sequence[torch.device]) -> dict:
    """{device: DeviceScene}: the scene's tables once on each distinct
    device (bands on one device share them)."""
    host = prepare_scene(scene)
    return {d: device_scene_from_numpy(host, d) for d in dict.fromkeys(devices)}


def rows_steps(scene, vp, config: RenderConfig, *, backend, skip_tmax, device,
               y0, rows, seed_y0, spp, number, accum=None, n_calls=None,
               spp_last=None, passign=None):
    """Image rows [y0, y0 + rows) on ``device``, seeded from row ``seed_y0``,
    as a generator of steps (``render_band_steps``) over ``chunks`` (seed
    transparent: each chunk seeds from its own first row).  ``accum``: the
    running sum of these rows.  ``n_calls``/``spp_last``: the grid
    backend's merged calls; ``passign``: {chunk's first image row: its
    balanced table}.  Returns [rows, W, 3] f32 on the device."""
    out = []
    for c0, ch, m in chunks(config, device, backend, rows):
        out.append((yield from render_band_steps(
            scene, vp, band_h=ch, width=config.width, y0=y0 + c0, seed_y0=seed_y0 + c0,
            offset_x=0, spp=spp, number=number,
            accum_init=None if accum is None else accum[c0 : c0 + ch],
            max_depth=config.max_depth, backend=backend, pixels_per_lane=m,
            skip_tmax=skip_tmax, rr=config.rr, n_calls=n_calls, spp_last=spp_last,
            passign=None if passign is None else passign[y0 + c0])))
    return out[0] if len(out) == 1 else torch.cat(out, dim=0)


def chunks(config: RenderConfig, device, backend, rows) -> list:
    """(first row within the band, rows, pixels per lane) of each
    ``render_band_steps`` call of a band of ``rows`` rows: at most
    ``band_layout``'s chunk rows each, at the band's M."""
    m, chunk = band_layout(config, device, backend, rows)
    return [(c0, min(chunk, rows - c0), m) for c0 in range(0, rows, chunk)]


class MultiChipRenderer:
    """Renders equal row bands, one per device.  ``devices``: a list of
    torch devices (the same device may repeat: its bands then run
    together on streams of their own); None picks ``config.chips`` devices
    of ``device``'s type, so one GPU gives one band, as JAX truncates its
    mesh to the devices there are.  On the grid backend it runs
    ``Renderer``'s operating point band by band: with ``config.balance_spp``
    a balanced pixel->lane table for every chunk of every band, built on
    the band's device (``enable_balance``), and ``calls_per_exec`` calls
    merged into one dispatch (``render``).  The image is bit-identical
    either way."""

    def __init__(self, config: RenderConfig, scene: Optional[SceneArrays] = None,
                 devices: Optional[Sequence] = None, reference_banding: bool = False,
                 device="cuda"):
        self.config = config
        self.scene = scene if scene is not None else generate_random_scene(config.scene_time)
        if devices is None:
            devices = pick_devices(config.chips, render_device(device).type)
        self.devices = [render_device(d) for d in devices]
        self.n = len(self.devices)
        if self.n == 0:
            raise ValueError("no devices to render on")
        self.device_scenes = upload_per_device(self.scene, self.devices)
        self.backend = resolve_backend(config.backend, self.device_scenes[self.devices[0]])
        self.reference_banding = reference_banding
        h = config.height
        # pad the height to a multiple of the band count; the extra rows are
        # rendered and cropped, so every band has the same height
        self.padded_h = -(-h // self.n) * self.n
        self.band_h = self.padded_h // self.n
        self.vp = viewport_arrays(config_camera(config), config.width, h)
        self.skip_tmax = tmax_never_binds(self.scene, config_camera(config))
        # per band {chunk's first row: balanced table on the band's device},
        # built on demand when config.balance_spp > 0, or by enable_balance
        self._passign = None
        self.balance_stats = None

    def _band(self, i):
        """Band ``i``'s device, first row and seed row."""
        y0 = i * self.band_h
        return self.devices[i], y0, 0 if self.reference_banding else y0

    def _band_attrs(self, i) -> dict:
        """What band ``i``'s ``bands.band`` span records (``run_in_turns``)."""
        return dict(y0=i * self.band_h, rows=self.band_h)

    def render_call(self, spp: int, number: int = 0, accum=None, n_calls=None,
                    spp_last=None) -> torch.Tensor:
        """One call of ``spp`` samples over every band; returns the
        accumulated sum [H, W, 3] (f32, on the first device; unpadded).
        ``accum`` carries the running sum.  ``n_calls``/``spp_last`` (grid
        backend): that many progressive calls merged into this dispatch in
        every band, as ``Renderer.render_call`` merges them."""
        cfg = self.config
        dev0 = self.devices[0]
        if cfg.balance_spp and self.backend == "grid" and self._passign is None:
            self.enable_balance()
        if accum is not None:
            accum = torch.as_tensor(accum, dtype=torch.float32)
            pad = self.padded_h - cfg.height
            if pad:
                accum = torch.cat([accum, accum.new_zeros((pad, cfg.width, 3))], dim=0)

        def band(i):
            dev, y0, seed_y0 = self._band(i)
            acc = None if accum is None else accum[y0 : y0 + self.band_h].to(dev)
            return rows_steps(
                self.device_scenes[dev], self.vp, cfg, backend=self.backend,
                skip_tmax=self.skip_tmax, device=dev, y0=y0, rows=self.band_h,
                seed_y0=seed_y0, spp=spp, number=number, accum=acc, n_calls=n_calls,
                spp_last=spp_last, passign=None if self._passign is None else self._passign[i])

        band.band_attrs = self._band_attrs
        with launches.span("bands.call", spp=spp, n_calls=n_calls or 1, n_bands=self.n,
                           devices=len(self.device_scenes)):
            bands, _ = run_in_turns(self.devices, band)
            with launches.span("bands.gather", bytes=sum(b.numel() * b.element_size()
                                                          for b in bands)):
                return torch.cat([b.to(dev0) for b in bands], dim=0)[: cfg.height]

    def enable_balance(self, probe_spp: Optional[int] = None) -> dict:
        """Measure per-pixel costs with the grid kernel's iterstats probe and
        build a balanced pixel->lane table for every chunk of every band
        (``runtime/balance.py``), as ``Renderer.enable_balance`` does for
        its bands: each on the band's device at the band's own M, the
        bands' probes stepped together.  Returns {(band, chunk's first
        row): {max_over_mean, lanes, issued_per_sample}}."""
        from ..runtime import balance as bal

        if self.backend != "grid":
            raise ValueError("balanced assignment is a grid-backend feature")
        spp = probe_spp or self.config.balance_spp or 32

        def probe(i):
            dev, y0, seed_y0 = self._band(i)
            tables, stats = {}, {}
            for c0, ch, m in chunks(self.config, dev, self.backend, self.band_h):
                cost = yield from bal.cost_map_steps(dict(
                    scene=self.device_scenes[dev], vp=self.vp, band_h=ch,
                    width=self.config.width, y0=y0 + c0, seed_y0=seed_y0 + c0, offset_x=0,
                    number=0, max_depth=self.config.max_depth, backend=self.backend,
                    pixels_per_lane=m, skip_tmax=self.skip_tmax, rr=self.config.rr), spp)
                tab = bal.build_passign(cost, m, LANE_PAD)
                tables[y0 + c0] = torch.from_numpy(tab).to(dev)
                stats[y0 + c0] = dict(
                    bal.balance_stats(cost, tab, m),
                    issued_per_sample=float(np.asarray(cost, np.float64).mean() / spp))
            return tables, stats

        probe.band_attrs = self._band_attrs
        with launches.span("bands.balance", probe_spp=spp) as rec:
            # by the devices module's name: this module's run_in_turns is the
            # image bands' exchange, which the benchmark's fault checks replace
            out, _ = pdev.run_in_turns(self.devices, probe)
            rec.set(tables=sum(len(t) for t, _ in out))
        self._passign = [t for t, _ in out]
        self.balance_stats = {(i, y0): st for i, (_, s) in enumerate(out)
                              for y0, st in s.items()}
        return self.balance_stats

    def render(self, samples: Optional[int] = None):
        """Progressive render in calls of ``config.samples_per_call``, on the
        grid backend up to ``calls_per_exec`` of them merged into one
        dispatch (bit-identical for any grouping); returns (accum [H, W, 3],
        total samples)."""
        cfg = self.config
        total = cfg.samples if samples is None else samples
        per_call = cfg.samples_per_call or total
        group_max = max(1, cfg.calls_per_exec) if self.backend == "grid" else 1
        accum, number, done = None, 0, 0
        while done < total:
            remaining = total - done
            nc = min(group_max, -(-remaining // per_call))
            if nc > 1:
                spp_last = min(per_call, remaining - (nc - 1) * per_call)
                accum = self.render_call(per_call, number=number, accum=accum,
                                         n_calls=nc, spp_last=spp_last)
                done += (nc - 1) * per_call + spp_last
            else:
                spp = min(per_call, remaining)
                accum = self.render_call(spp, number=number, accum=accum)
                done += spp
            number += nc
        return accum, total

    def render_u8(self, samples: Optional[int] = None) -> np.ndarray:
        accum, total = self.render(samples)
        return imageops.accum_to_u8(accum, total).cpu().numpy()
