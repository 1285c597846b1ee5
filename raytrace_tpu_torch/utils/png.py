"""Minimal dependency-free PNG writer (RGB8).

The reference parses ``--store`` but never writes an image — stb is wired into
its build yet unused (SURVEY.md quirk Q2, reference CMakeLists.txt:66-75).
This delivers the capability the flag promises.  Pure zlib + struct; no PIL
dependency in the framework itself (tests cross-check with PIL).

Port copy of ``raytrace_tpu/utils/png.py``, byte-for-byte in behaviour (numpy
only): the port never imports the JAX package, whose ``__init__`` imports jax.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def encode_png(image: np.ndarray) -> bytes:
    """Encode an [H, W, 3] uint8 array as RGB PNG bytes."""
    img = np.asarray(image)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected [H,W,3] uint8, got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    # filter byte 0 per scanline
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    return (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(raw, 6))
        + _chunk(b"IEND", b"")
    )


def write_png(path: str, image: np.ndarray) -> None:
    """Write an [H, W, 3] uint8 array as an RGB PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(image))
