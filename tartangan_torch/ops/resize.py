"""Image resampling primitives, NCHW layout.

Counterparts of ``tartangan_tpu/ops/resize.py`` (NHWC there): the nearest
2x upsample of the G blocks and the 2x2 max pool of the self-attention K/V.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of NCHW (G block upsample path)."""
    b, c, h, w = x.shape
    x = x[:, :, :, None, :, None].expand(b, c, h, 2, w, 2)
    return x.reshape(b, c, h * 2, w * 2)


def max_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 max pool on NCHW (self-attention K/V downsample)."""
    return F.max_pool2d(x, 2)
