"""Image resampling primitives, NCHW layout.

Counterparts of ``tartangan_tpu/ops/resize.py`` (NHWC there): the nearest
2x upsample of the G blocks, the 2x2 max pool of the self-attention K/V,
the D blocks' 2x2 average pool and bilinear half-size shortcut, that
shortcut taken from a parity stack (``ops/parity.py`` layout), and the
Inception wrapper's bilinear resize to 299 and its stem's 3x3 max pool.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.precision import REDUCED
from . import consts


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of NCHW (G block upsample path)."""
    b, c, h, w = x.shape
    x = x[:, :, :, None, :, None].expand(b, c, h, 2, w, 2)
    return x.reshape(b, c, h * 2, w * 2)


def max_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 max pool on NCHW (self-attention K/V downsample)."""
    return F.max_pool2d(x, 2)


def max_pool(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """VALID ``window``x``window`` max pool with ``stride`` on NCHW (the
    Inception stem's 3x3/2; the JAX package's ``max_pool``)."""
    return F.max_pool2d(x, window, stride)


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 average pool on NCHW (D block main path)."""
    return F.avg_pool2d(x, 2)


def downsample_bilinear_half(x: torch.Tensor,
                             align_corners: bool = True) -> torch.Tensor:
    """Bilinear 0.5x of NCHW (D residual shortcut): ``F.interpolate`` to
    (H // 2, W // 2), which samples input coordinate i * (n_in - 1) /
    (n_out - 1) with align_corners, as the JAX package's
    ``_linear_interp_matrix`` does. In a reduced dtype it is the JAX
    package's two matmuls (``resize_bilinear``), whose interpolation
    weights and intermediate are rounded to that dtype."""
    _, _, h, w = x.shape
    if x.dtype not in REDUCED:
        return F.interpolate(x, size=(h // 2, w // 2), mode="bilinear",
                             align_corners=align_corners)
    return resize_bilinear(x, h // 2, w // 2, align_corners)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int,
                    align_corners: bool = True) -> torch.Tensor:
    """Bilinear resize of NCHW ``x`` to (out_h, out_w) as the JAX package's
    two interpolation-matrix products (``ops/resize.py:51-61``), the
    matrices in ``x``'s dtype made once on its device."""
    _, _, h, w = x.shape
    if h == out_h and w == out_w:
        return x
    ah = _interp(h, out_h, align_corners, x)
    aw = _interp(w, out_w, align_corners, x)
    y = torch.einsum("oh,bchw->bcow", ah, x)
    return torch.einsum("ow,bchw->bcho", aw, y)


@functools.lru_cache(maxsize=None)
def _linear_interp_matrix(n_in: int, n_out: int,
                          align_corners: bool) -> np.ndarray:
    """Dense (n_out, n_in) 1-D linear interpolation matrix, as the JAX
    package builds it (``ops/resize.py:26-48``): with align_corners output
    i samples input coordinate i * (n_in - 1) / (n_out - 1), without it
    half-pixel centres clamped to the edges."""
    a = np.zeros((n_out, n_in), dtype=np.float32)
    if n_in == 1:
        a[:, 0] = 1.0
        return a
    for i in range(n_out):
        if align_corners:
            src = i * (n_in - 1) / max(n_out - 1, 1)
        else:
            src = (i + 0.5) * n_in / n_out - 0.5
            src = min(max(src, 0.0), n_in - 1)
        lo = int(np.floor(src))
        hi = min(lo + 1, n_in - 1)
        frac = src - lo
        a[i, lo] += 1.0 - frac
        a[i, hi] += frac
    return a


def _interp(n_in, n_out, align_corners, like):
    """``_linear_interp_matrix`` in ``like``'s dtype on its device, made
    once (``ops/consts.py``): no host copy after the first call."""
    return consts.device_constant(
        ("interp", n_in, n_out, align_corners),
        lambda: _linear_interp_matrix(n_in, n_out, align_corners),
        like.dtype, like.device)


def downsample_bilinear_half_parity(xp: torch.Tensor, c: int,
                                    align_corners: bool = True) -> torch.Tensor:
    """Bilinear 0.5x of a full-resolution tensor given as its parity stack
    (B, 4C, H/2, W/2) -> (B, C, H/2, W/2), without building the
    full-resolution tensor: the interpolation matrix's column k = 2m + p
    splits into (coarse index m, parity p)."""
    b, _, h2, w2 = xp.shape
    x6 = xp.reshape(b, 2, 2, c, h2, w2)
    ah = _interp(2 * h2, h2, align_corners, xp).reshape(h2, h2, 2)
    aw = _interp(2 * w2, w2, align_corners, xp).reshape(w2, w2, 2)
    y = torch.einsum("imp,bpxcmw->bxciw", ah, x6)
    return torch.einsum("jwx,bxciw->bcij", aw, y)


def downsample_bilinear_half_parity_to_parity(
        xp: torch.Tensor, c: int, align_corners: bool = True) -> torch.Tensor:
    """Bilinear 0.5x from a parity stack to a parity stack: (B, 4C, H/2, W/2)
    of a full-resolution (H, W) tensor -> (B, 4C, H/4, W/4) of its half-size
    downsample; both the row index 2n + q and the column index 2m + p of the
    interpolation matrix split by parity."""
    b, _, h2, w2 = xp.shape
    x6 = xp.reshape(b, 2, 2, c, h2, w2)
    ah = _interp(2 * h2, h2, align_corners, xp).reshape(h2 // 2, 2, h2, 2)
    aw = _interp(2 * w2, w2, align_corners, xp).reshape(w2 // 2, 2, w2, 2)
    y = torch.einsum("nqmp,bpxcmw->bqxcnw", ah, x6)
    y = torch.einsum("jQwx,bqxcnw->bqQcnj", aw, y)
    return y.reshape(b, 4 * c, h2 // 2, w2 // 2)
