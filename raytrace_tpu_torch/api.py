"""Public embedding API — Python mirror of the reference C ABI.

Port of ``raytrace_tpu/api.py``: ``ray_trace`` takes the reference's five
arguments (samples, storeRenderResult, width, height, gpu_count) in the same
order with the same defaults, prints ``duration_per_frame`` like the
reference frame loop, and writes a PNG when asked.  ``render_image`` renders
any scene (``random_sphere_field(100_000)`` is the dense-scene path).  Both
render on the GPU (``device="cuda"``) and raise without one; ``device="cpu"``
runs the kernels' plain torch versions.  With ``chips`` / ``gpu_count`` above
1 they split row bands over the devices there are (``parallel/sharding.py``;
one H100 gives one band, as JAX truncates its mesh), or over an explicit
``devices`` list.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np

from .config import RenderConfig
from .models.scene import SceneArrays


def render_image(config: RenderConfig, scene: Optional[SceneArrays] = None,
                 device="cuda", devices: Optional[Sequence] = None) -> np.ndarray:
    """Render one frame of ``scene`` (default: the book scene) to a u8 RGB
    image using ``config``: in row bands over ``devices`` (default:
    ``config.chips`` devices of ``device``'s type) when ``config.chips > 1``
    or ``devices`` is given, else on ``device``."""
    if config.chips > 1 or devices is not None:
        from .parallel.sharding import MultiChipRenderer

        return MultiChipRenderer(config, scene=scene, devices=devices,
                                 device=device).render_u8()
    from .runtime.renderer import Renderer

    return Renderer(config, scene=scene, device=device).render_u8()


def ray_trace(
    samples: int = 10,
    store_render_result: bool = False,
    width: int = 1920,
    height: int = 1080,
    gpu_count: int = 1,
    *,
    out_path: str = "render.png",
    scene_time: float = 0.0,
    backend: str = "auto",
    max_depth: int = 50,
    samples_per_call: Optional[int] = None,
    accum_dtype: str = "float32",
    preview: bool = False,
    pixels_per_lane: Optional[int] = None,
    mode: str = "exact",
    balance_spp: int = 0,
    device="cuda",
) -> np.ndarray:
    """Drop-in analogue of the reference C ABI entry point.

    Renders the procedural final-book scene at (width, height) with
    ``samples`` spp across ``gpu_count`` devices (``render_image``), prints
    duration_per_frame, optionally stores a PNG, and returns the u8 image.
    ``preview`` (one device) writes the running image after every
    progressive call.  ``device``: "cuda" (default; raises without a GPU) or
    "cpu"."""
    config = RenderConfig(
        samples=samples,
        store=store_render_result,
        width=width,
        height=height,
        chips=gpu_count,
        max_depth=max_depth,
        samples_per_call=samples_per_call,
        backend=backend,
        scene_time=scene_time,
        out_path=out_path,
        accum_dtype=accum_dtype,
        pixels_per_lane=pixels_per_lane,
        mode=mode,
        balance_spp=balance_spp,
    )
    from .ops.image import accum_to_u8
    from .runtime.renderer import Renderer
    from .utils.png import write_png

    t0 = time.perf_counter()
    if preview and gpu_count == 1:
        if config.samples_per_call is None:
            config = dataclasses.replace(config, samples_per_call=max(1, samples // 10))

        def on_chunk(accum, done):
            write_png(out_path, accum_to_u8(accum, done).cpu().numpy())

        accum, total = Renderer(config, device=device).render(samples, on_chunk=on_chunk)
        img = accum_to_u8(accum, total).cpu().numpy()
    else:
        img = render_image(config, device=device)
    dpf = time.perf_counter() - t0
    print(f"duration_per_frame: {dpf}")
    if store_render_result:
        write_png(out_path, img)
    return img
