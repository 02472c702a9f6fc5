"""Host-side image grid rendering and PNG encoding.

Counterpart of ``tartangan_tpu/utils/imaging.py``: NHWC float arrays in
[-1, 1] in, PNG bytes out. The PNG writer uses only ``zlib`` and ``struct``
(8-bit grayscale or RGB, filter 0), so serving needs no imaging library.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def to_uint8(images, value_range=(-1.0, 1.0)):
    """Normalize NHWC float images from ``value_range`` to uint8 [0, 255]."""
    images = np.asarray(images, dtype=np.float32)
    lo, hi = value_range
    images = (images - lo) / max(hi - lo, 1e-12)
    images = np.clip(images, 0.0, 1.0)
    return (images * 255.0 + 0.5).astype(np.uint8)


def make_grid(images, nrow=8, padding=2, pad_value=0):
    """Tile a batch of NHWC uint8 images into one grid image (HWC uint8)."""
    images = np.asarray(images)
    n, h, w, c = images.shape
    ncols = min(nrow, n)
    nrows = (n + ncols - 1) // ncols
    grid = np.full(
        (nrows * h + (nrows + 1) * padding,
         ncols * w + (ncols + 1) * padding, c),
        pad_value, dtype=images.dtype,
    )
    for idx in range(n):
        r, col = divmod(idx, ncols)
        y = padding + r * (h + padding)
        x = padding + col * (w + padding)
        grid[y:y + h, x:x + w] = images[idx]
    return grid


def _chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def encode_png(arr) -> bytes:
    """PNG bytes of an (H, W) or (H, W, 1|3) uint8 array."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, got {arr.dtype}")
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    if arr.ndim == 2:
        color_type = 0
    elif arr.ndim == 3 and arr.shape[-1] == 3:
        color_type = 2
    else:
        raise ValueError(f"encode_png takes (H, W[, 1|3]), got {arr.shape}")
    h, w = arr.shape[:2]
    rows = np.ascontiguousarray(arr).reshape(h, -1)
    # filter type 0 (None) in front of every scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))
