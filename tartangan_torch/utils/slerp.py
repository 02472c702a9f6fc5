"""Spherical linear interpolation of latent vectors.

Parity: reference tartangan/utils/slerp.py:5-32 (same math, numpy-only —
these run host-side to build sample grids, never inside jit).
"""
from __future__ import annotations

import numpy as np


def slerp(val, low, high):
    low = np.asarray(low, dtype=np.float64)
    high = np.asarray(high, dtype=np.float64)
    omega = np.arccos(
        np.clip(
            np.dot(low / np.linalg.norm(low), high / np.linalg.norm(high)),
            -1, 1,
        )
    )
    so = np.sin(omega)
    if so == 0:
        return (1.0 - val) * low + val * high  # LERP fallback
    return np.sin((1.0 - val) * omega) / so * low + np.sin(val * omega) / so * high


def slerp_grid(top_left, top_right, bottom_left, bottom_right, nrows, ncols):
    """Bilinear-ish grid of slerps between four corner latents.

    Returns an array of shape (nrows * ncols, latent_dims).
    """
    left_col = [slerp(x, top_left, bottom_left) for x in np.linspace(0, 1, nrows)]
    right_col = [slerp(x, top_right, bottom_right) for x in np.linspace(0, 1, nrows)]
    rows = []
    for left, right in zip(left_col, right_col):
        rows.append(np.vstack([slerp(x, left, right) for x in np.linspace(0, 1, ncols)]))
    return np.concatenate(rows, axis=0).astype(np.float32)
