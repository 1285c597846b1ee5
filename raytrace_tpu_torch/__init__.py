"""raytrace_tpu_torch — the path tracer on PyTorch and CUDA (NVIDIA Hopper).

The port of ``raytrace_tpu`` (JAX/Pallas on a TPU), which stays in the
repository as the reference.  Same scene, camera, RNG streams and wavefront
state machine; the Pallas kernels on the render path become hand-written CUDA
kernels for ``sm_90a`` (``csrc/``, built with nvcc on first use by
``_build.py``), each with a plain torch version that the CPU runs:

- ``ops/gridkernel.py``: the grid-DDA wavefront step (the book scene);
- ``ops/megakernel.py``: the brute-force wavefront step (its anchor);
- ``ops/pagedkernel.py``: the paged-grid wavefront step (dense scenes);
- ``ops/pallas_intersect.py``: the fused closest hit + attribute fetch of
  the ``pallas`` spec backend.

Beside the render path, ``scripts/bench_gather.py`` ports the JAX package's
gather microbenchmark (``scripts/bench_gather.py``: a lane gather from
on-chip memory and its loop baseline) onto the CUDA kernels of
``csrc/bench_gather.cu``; ``bench.py`` (``python -m
raytrace_tpu_torch.bench``) ports the JAX bench's JSON line, ``scripts/``
the measurement scripts its operating point rests on, and ``oracle/`` the
straight-line numpy oracle the goldens come from.

The entry points render on the GPU and raise without one unless given
``device="cpu"``.

This package imports torch and numpy only, never jax or ``raytrace_tpu``.
Public API mirrors the reference C ABI (``ray_trace``).
"""

from .api import ray_trace, render_image
from .config import RenderCallInfo, RenderConfig
from .models.scene import SceneArrays, generate_random_scene, three_sphere_scene

__version__ = "0.1.0"

__all__ = [
    "RenderCallInfo",
    "RenderConfig",
    "SceneArrays",
    "generate_random_scene",
    "three_sphere_scene",
    "ray_trace",
    "render_image",
    "__version__",
]
