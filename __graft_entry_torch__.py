"""Entry points of the PyTorch/CUDA port: a single-device band render and a
multi-device dry run, the counterparts of ``__graft_entry__.py``.

``entry(device)`` returns the port's render step over the flagship scene
(one row band of the 488-sphere book scene on the grid-DDA kernel, at the
JAX entry's shapes: 64x32, depth 8, 2 spp) with example args.

``dryrun_multichip(n, device)`` runs the JAX entry's three parallel paths
over ``[device] * n`` (n bands of one device, each stepped on a stream of
its own): row bands on the grid backend (book scene), row bands on the
paged backend (a 2000-sphere field), and one workload-tuner round of
``HeteroRenderer``.  It asserts the JAX entry's shapes and sums and returns
the three accumulators.

Both run on the GPU unless given ``device="cpu"``.  Imports torch and the
port only.
"""

from __future__ import annotations

import numpy as np


def entry(device="cuda"):
    """Returns (fn, example_args): ``fn(*example_args)`` renders a 64x32
    band of the book scene at depth 8, 2 spp, on the grid backend and
    returns its color sum [32, 64, 3] (f32, on ``device``)."""
    from raytrace_tpu_torch.models.scene import generate_random_scene
    from raytrace_tpu_torch.ops.trace import (device_scene_from_numpy, prepare_scene,
                                              render_band, viewport_arrays)
    from raytrace_tpu_torch.runtime.renderer import reference_camera, render_device

    band_h, width = 32, 64
    dev = render_device(device)

    def fn(scene, vp, y0, seed_y0, offset_x, spp, number):
        return render_band(scene, vp, band_h=band_h, width=width, y0=y0,
                           seed_y0=seed_y0, offset_x=offset_x, spp=spp,
                           number=number, max_depth=8, backend="grid")

    scene = device_scene_from_numpy(prepare_scene(generate_random_scene(0.0)), dev)
    vp = viewport_arrays(reference_camera(), width, band_h)
    return fn, (scene, vp, 0, 0, 0, 2, 0)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One render through each of the three parallel paths over
    ``[device] * n_devices`` (``__graft_entry__.py:dryrun_multichip``'s
    configurations); returns {"grid", "paged", "hetero"} accumulators as
    numpy arrays."""
    from raytrace_tpu_torch.config import RenderConfig
    from raytrace_tpu_torch.models.scene import generate_random_scene, random_sphere_field
    from raytrace_tpu_torch.parallel.hetero import HeteroRenderer
    from raytrace_tpu_torch.parallel.sharding import MultiChipRenderer

    devices = [device] * n_devices

    # 1. grid backend, full book scene, row bands
    cfg = RenderConfig(samples=2, width=32, height=4 * n_devices, chips=n_devices,
                       max_depth=6, backend="grid", pixels_per_lane=2)
    accum, _ = MultiChipRenderer(cfg, scene=generate_random_scene(0.0),
                                 devices=devices).render(2)
    accum = accum.cpu().numpy()
    assert accum.shape == (cfg.height, cfg.width, 3)
    assert bool((accum >= 0).all())

    # 2. paged backend, dense sphere field, row bands
    paged_cfg = RenderConfig(samples=2, width=32, height=4 * n_devices, chips=n_devices,
                             max_depth=5, backend="paged", pixels_per_lane=2)
    field = random_sphere_field(2000, seed=1, extent=7.0)
    paccum, _ = MultiChipRenderer(paged_cfg, scene=field, devices=devices).render(2)
    paccum = paccum.cpu().numpy()
    assert paccum.shape == (paged_cfg.height, paged_cfg.width, 3)
    assert bool((paccum >= 0).all())

    # 3. per-device dispatch + one workload-tuner round
    het_cfg = RenderConfig(samples=2, width=32, height=6 * n_devices, chips=n_devices,
                           max_depth=5, backend="grid", pixels_per_lane=2)
    h = HeteroRenderer(het_cfg, scene=generate_random_scene(0.0), devices=devices)
    haccum, dpf, _rows = h.tune_round(2, frames=1)
    assert haccum.shape == (het_cfg.height, het_cfg.width, 3)
    assert dpf > 0
    assert sum(h.rows) == het_cfg.height
    return {"grid": accum, "paged": paccum, "hetero": np.asarray(haccum)}


if __name__ == "__main__":
    import torch

    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry ok", tuple(out.shape))
    dryrun_multichip(torch.cuda.device_count())
    print("dryrun ok")
