"""Correctly rounded float32 square root for the torch code paths.

torch's CPU kernel for float32 ``sqrt`` is not correctly rounded (measured
on torch 2.13 with AVX512: 0.65% of random inputs come out one ulp off
numpy's IEEE ``sqrt``), which would break bit parity with the CPU oracle,
the JAX package's RNG and the CUDA kernels (``sqrtf``, round-to-nearest).
The square root of a float32 value taken in float64 and rounded back to
float32 is the correctly rounded float32 result (53 >= 2 * 24 + 2 bits, so
the double rounding is exact), on any device.
"""

from __future__ import annotations

import torch


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """IEEE round-to-nearest float32 sqrt of a float32 tensor."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)
