"""Per-card kernel and runtime constants.

Port of ``raytrace_tpu/runtime/chips.py``: one row per device kind of the
operating point the renderer and the autotuner start from.  Consumers:
``runtime/renderer.py`` reads ``lanes_per_thread`` (the grid backend's) for
the pixels-per-lane pick; ``runtime/autotune.py`` seeds its (M, J, K) sweep
with the renderer's M and the row's ``j_steps`` / ``k_steps``.  ``block`` is
the grid kernel's threads per block (a compile-time define, ``_build.py``);
``samples_per_call`` and ``calls_per_exec`` are the 10,000-spp headline's
progressive chunk and in-kernel call merge.

The one row is the point measured on an NVIDIA H100 80GB HBM3 at a 700 W
power limit (``PERF.md``): the grid kernel's K x J x M sweep
(``torch_breakdown.py --scene book``) and the 1920x1080 x 10,000 spp fast
headline (``chip_smoke.py``).  The JAX package's rows are a TPU's numbers
and stay out.  Any other card gets ``DEFAULT`` (the H100 row): run
``python -m raytrace_tpu_torch --autotune`` (``--full`` adds the block
size) there to measure its own point.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ChipProfile:
    kind_substr: str  # matched against torch.cuda.get_device_name(), lower case
    lanes_per_thread: int  # grid band lanes per thread slot of the card
    samples_per_call: int  # progressive chunk of a long render
    calls_per_exec: int  # in-kernel call-merge group (grid backend)
    block: int  # grid kernel threads per block
    k_steps: int  # grid kernel wavefront iterations per launch
    j_steps: int  # grid kernel DDA cells per iteration
    note: str = ""


PROFILES = (
    ChipProfile("h100", 4, 2500, 4, 128, 40, 2,
                "measured on NVIDIA H100 80GB HBM3, 700.00 W: M = 2 at 1080p "
                "(4 lanes per thread slot), K = 40, J = 2 from the K x J x M "
                "sweep; 2500 spp per call, 4 calls per dispatch from the "
                "10,000-spp headline (PERF.md)"),
)

DEFAULT = PROFILES[0]


def profile_for(device_kind: Optional[str] = None) -> ChipProfile:
    """Profile of the given device kind, or of CUDA device 0's; ``DEFAULT``
    for an unknown kind or when there is no CUDA device (a table lookup:
    nothing renders)."""
    if device_kind is None:
        import torch

        if not torch.cuda.is_available():
            return DEFAULT
        device_kind = torch.cuda.get_device_name(0)
    kind = (device_kind or "").lower()
    for p in PROFILES:
        if p.kind_substr in kind:
            return p
    return DEFAULT
