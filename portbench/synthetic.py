"""The benchmark's training data: seeded synthetic tartans.

The port's ``tartangan_torch/data/synthetic.py`` in bulk, kept here so
that the data a cell trains on cannot change with the program.
``make_tartans`` draws every sett from the same
``np.random.default_rng(seed)`` in the same order as that generator, and
weaves all images at once in integer arithmetic on ``device``. The
generator's float math is exact there (integer palettes, blend 1/4 and
halves: every value is a multiple of 1/8 below 256), so its result is
``(7 a + b) >> 3`` of the two thread colours, bit for bit
(``tests/test_portbench_reference.py`` holds it against a copy of the
generator).
"""
from __future__ import annotations

import numpy as np
import torch


def _random_sett(rng, max_colors=5):
    n_colors = rng.integers(2, max_colors + 1)
    palette = rng.integers(0, 256, size=(n_colors, 3)).astype(np.float32)
    n_stripes = rng.integers(3, 9)
    colors = rng.integers(0, n_colors, size=n_stripes)
    widths = rng.integers(2, 13, size=n_stripes)
    return palette[colors], widths


def _thread_colors(rng, size: int) -> np.ndarray:
    """The (size, 3) colour of each thread of one symmetric sett."""
    colors, widths = _random_sett(rng)
    colors = np.concatenate([colors, colors[::-1]], axis=0)
    widths = np.concatenate([widths, widths[::-1]], axis=0)
    stripe_of = np.repeat(np.arange(len(widths)), widths)
    return colors[stripe_of[np.arange(size) % len(stripe_of)]]


def make_tartans(num: int, size: int, seed: int,
                 device="cpu") -> np.ndarray:
    """``make_archive(num, size, seed)``, woven in bulk on ``device``:
    (num, size, size, 3) uint8 on the host."""
    rng = np.random.default_rng(seed)
    threads = np.stack([_thread_colors(rng, size) for _ in range(num)])
    w = torch.from_numpy(threads.astype(np.int16)).to(device)
    i = torch.arange(size, device=device)
    over = ((i[:, None] + i[None, :]) // 2 % 2 == 0)[None, :, :, None]
    wx, wy = w[:, None, :, :], w[:, :, None, :]
    woven = torch.where(over, 7 * wx + wy, 7 * wy + wx) >> 3
    return woven.to(torch.uint8).cpu().numpy()
