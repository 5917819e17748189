"""PNG encoding with the standard library: how the port writes the PNGs that
the JAX package writes through PIL, on machines that have no PIL.

One 8-bit RGB image, filter 0 on every row, ``zlib`` at level 6 (PIL's
default). The bytes need not equal PIL's; the decoded pixels do.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def encode_png(rgb: np.ndarray) -> bytes:
    """uint8 (H, W, 3) RGB -> the bytes of a PNG file."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_png wants uint8 (H, W, 3), got "
                         f"{rgb.dtype} {rgb.shape}")
    h, w, _ = rgb.shape
    rows = np.zeros((h, 1 + 3 * w), np.uint8)     # filter byte 0 a row
    rows[:, 1:] = rgb.reshape(h, 3 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)   # 8-bit RGB
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))
