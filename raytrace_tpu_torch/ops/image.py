"""Accumulator -> display image conversion (the rgba8 render target path).

Port of ``raytrace_tpu/ops/image.py``: ``pixelColor = sqrt(sum / samples)``
(gamma 2, shader.rgen:65-66) written as u8 with round-to-nearest (Vulkan
UNORM conversion).  Works on torch tensors and numpy arrays alike.
"""

from __future__ import annotations

import numpy as np
import torch


def tonemap(accum, samples):
    """sqrt(sum/samples), clamped to [0,1] — shader.rgen:65."""
    if isinstance(accum, np.ndarray):
        img = np.sqrt(np.clip(accum / np.asarray(samples, accum.dtype), 0.0, None))
        return np.clip(img, 0.0, 1.0)
    img = torch.sqrt(torch.clamp(accum / torch.tensor(samples, dtype=accum.dtype,
                                                      device=accum.device), min=0.0))
    return torch.clamp(img, 0.0, 1.0)


def to_u8(img01):
    """[0,1] float -> u8 with round-to-nearest (round half to even)."""
    if isinstance(img01, np.ndarray):
        return np.round(img01 * 255.0).astype(np.uint8)
    return torch.round(img01 * 255.0).to(torch.uint8)


def accum_to_u8(accum, samples):
    return to_u8(tonemap(accum, samples))
