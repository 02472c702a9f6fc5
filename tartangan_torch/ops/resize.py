"""Image resampling primitives, NCHW layout.

Counterparts of ``tartangan_tpu/ops/resize.py`` (NHWC there): the nearest
2x upsample of the G blocks, the 2x2 max pool of the self-attention K/V,
and the D blocks' 2x2 average pool and bilinear half-size shortcut.
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


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 average pool on NCHW (D block main path)."""
    return F.avg_pool2d(x, 2)


def downsample_bilinear_half(x: torch.Tensor,
                             align_corners: bool = True) -> torch.Tensor:
    """Bilinear 0.5x of NCHW (D residual shortcut): ``F.interpolate`` to
    (H // 2, W // 2), which samples input coordinate i * (n_in - 1) /
    (n_out - 1) with align_corners, as the JAX package's
    ``_linear_interp_matrix`` does."""
    _, _, h, w = x.shape
    return F.interpolate(x, size=(h // 2, w // 2), mode="bilinear",
                         align_corners=align_corners)
