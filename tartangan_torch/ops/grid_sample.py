"""Affine sampling grids and bilinear grid sampling, NHWC in and out.

Counterpart of ``tartangan_tpu/ops/grid_sample.py``: ``affine_grid`` (:18)
and ``grid_sample`` (:42), used by the scene generator to place patches on
a canvas. The base grid is built as the JAX package builds it (:27-31), not
by ``F.affine_grid``: on an axis of length 1 the JAX package's
``linspace(-1, 1, 1)`` gives -1 where ATen's grid gives 0. The sampling
itself is ``F.grid_sample`` (bilinear, zero padding), the same math as the
JAX package's four gathers; it is not a Pallas kernel. Both compute in
float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _base_coords(steps: int, align_corners: bool, device) -> torch.Tensor:
    """Normalized centre coordinates of ``steps`` pixels: the ends -1 and 1
    with align_corners (and -1 for one pixel), else the half-pixel centres
    (2i + 1) / steps - 1."""
    if align_corners or steps == 1:
        return torch.linspace(-1.0, 1.0, steps, device=device)
    return (2.0 * torch.arange(steps, device=device) + 1.0) / steps - 1.0


def affine_grid(theta: torch.Tensor, size, align_corners: bool = False):
    """theta (N, 2, 3), size (N, H, W) -> the sampling grid (N, H, W, 2) of
    normalized (x, y) coordinates, ``base @ theta^T`` for each pixel's
    (x, y, 1)."""
    _, h, w = size
    theta = theta.float()
    xs = _base_coords(w, align_corners, theta.device)
    ys = _base_coords(h, align_corners, theta.device)
    grid_y, grid_x = torch.meshgrid(ys, xs, indexing="ij")  # (H, W)
    base = torch.stack([grid_x, grid_y, torch.ones_like(grid_x)], -1)
    return torch.einsum("hwk,nck->nhwc", base, theta)


def grid_sample(inputs: torch.Tensor, grid: torch.Tensor,
                align_corners: bool = False) -> torch.Tensor:
    """Bilinear samples of NHWC ``inputs`` at ``grid`` (N, Ho, Wo, 2), zero
    outside the input -> (N, Ho, Wo, C) in the inputs' dtype."""
    x = inputs.permute(0, 3, 1, 2).float()
    out = F.grid_sample(x, grid.float(), mode="bilinear",
                        padding_mode="zeros", align_corners=align_corners)
    return out.permute(0, 2, 3, 1).to(inputs.dtype)
