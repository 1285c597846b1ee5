"""Row bands over several devices: the static equal split.

Port of ``raytrace_tpu/parallel/sharding.py`` (the reference's multi-GPU
spatial split, ray_trace.cpp:74-105): the image is split into horizontal
row bands, one per device, the scene replicated.  Where JAX runs one
``shard_map`` program over a device mesh, the port steps each band over its
chunks (``runtime/renderer.BandPlan.band_steps``), every band stepped from
the calling thread as soon as its last launch has completed, each on a CUDA
stream of its own (``devices.run_in_turns``), and concatenates the bands;
devices that are the same device share one copy of the scene tables.  The
bands run ``Renderer``'s operating point through the same plan: on the grid
backend balanced lane tables per chunk and merged calls, and the
float64 accumulation across calls.  Spans (``ops/launches.py``):
``bands.call`` around a call, a ``bands.band`` per band in it,
``bands.gather``, and ``bands.balance`` around the tables' probes.

Seed semantics (``reference_banding``):
- ``False`` (default): every band seeds from global pixel rows, so an
  N-band render is bit-identical to the single-device render.
- ``True``: bands seed from band-local rows like the reference's per-GPU
  launches (shader.rgen:40, per-device offset at :45): statistically the
  same image, another sample stream.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..config import RenderConfig
from ..models.scene import SceneArrays
from ..ops import launches
# the band step every chunk runs, named here too: the benchmark's fault
# checks replace it in this module as well as in ops/trace.py
from ..ops.trace import render_band_steps  # noqa: F401
from ..runtime.renderer import (Band, BandPlan, progressive_render, progressive_u8,
                                render_device)
from . import devices as pdev
from .devices import pick_devices, run_in_turns


class MultiChipRenderer(BandPlan):
    """Renders equal row bands, one per device.  ``devices``: a list of
    torch devices (the same device may repeat: its bands then run
    together on streams of their own); None picks ``config.chips`` devices
    of ``device``'s type, so one GPU gives one band, as JAX truncates its
    mesh to the devices there are.  With ``config.balance_spp`` on the grid
    backend every chunk of every band renders under its balanced table,
    built on the band's device (``enable_balance``); ``render`` merges
    ``calls_per_exec`` calls into one dispatch.  The image is bit-identical
    either way."""

    def __init__(self, config: RenderConfig, scene: Optional[SceneArrays] = None,
                 devices: Optional[Sequence] = None, reference_banding: bool = False,
                 device="cuda"):
        if devices is None:
            devices = pick_devices(config.chips, render_device(device).type)
        super().__init__(config, scene, devices)
        self.reference_banding = reference_banding
        # pad the height to a multiple of the band count; the extra rows are
        # rendered and cropped, so every band has the same height
        self.padded_h = -(-config.height // self.n) * self.n
        self.band_h = self.padded_h // self.n
        self.bands = [Band(d, i * self.band_h, self.band_h,
                           0 if reference_banding else i * self.band_h)
                      for i, d in enumerate(self.devices)]

    def _band_attrs(self, i) -> dict:
        """What band ``i``'s ``bands.band`` span records (``run_in_turns``)."""
        return dict(y0=self.bands[i].y0, rows=self.band_h)

    def render_call(self, spp: int, number: int = 0, accum=None, n_calls=None,
                    spp_last=None) -> torch.Tensor:
        """One call of ``spp`` samples over every band; returns the
        accumulated sum [H, W, 3] (f32, on the first device; unpadded).
        ``accum`` carries the running sum.  ``n_calls``/``spp_last`` (grid
        backend): that many progressive calls merged into this dispatch in
        every band, as ``Renderer.render_call`` merges them."""
        cfg = self.config
        self.tables_on_demand()
        if accum is not None:
            accum = torch.as_tensor(accum, dtype=torch.float32)
            pad = self.padded_h - cfg.height
            if pad:
                accum = torch.cat([accum, accum.new_zeros((pad, cfg.width, 3))], dim=0)

        def band(i):
            return self.band_steps(self.bands[i], spp, number, accum, n_calls, spp_last)

        band.band_attrs = self._band_attrs
        with launches.span("bands.call", spp=spp, n_calls=n_calls or 1, n_bands=self.n,
                           devices=len(self.device_scenes)):
            bands, _ = run_in_turns(self.devices, band)
            with launches.span("bands.gather", bytes=sum(b.numel() * b.element_size()
                                                          for b in bands)):
                return torch.cat([b.to(self.devices[0]) for b in bands], dim=0)[: cfg.height]

    def enable_balance(self, probe_spp: Optional[int] = None) -> dict:
        """Build the balanced table of every chunk of every band
        (``balance_steps``), each on the band's device at the band's own M,
        the bands' probes stepped together.  Returns the tables' stats."""
        spp = self.probe_spp(probe_spp)

        def probe(i):
            return self.balance_steps(self.bands[i], spp)

        probe.band_attrs = self._band_attrs
        with launches.span("bands.balance", probe_spp=spp) as rec:
            # by the devices module's name: this module's run_in_turns is the
            # image bands' exchange, which the benchmark's fault checks replace
            out, _ = pdev.run_in_turns(self.devices, probe)
            rec.set(tables=sum(len(t) for t, _ in out))
        return self.adopt_tables(out)

    render = progressive_render
    render_u8 = progressive_u8
