"""Generator and discriminator building blocks (NCHW).

Counterparts of ``tartangan_tpu/models/blocks.py``: ``GeneratorInputMLP``
(:537), ``TiledZGeneratorInput`` (:573), ``ResidualGeneratorBlock`` (:104),
``GeneratorOutput`` (:592), ``DiscriminatorInput`` (:649),
``ResidualDiscriminatorBlock`` (:717) and ``DiscriminatorOutput`` (:757). Attribute names follow the flax param tree
(``NormAct_0``, ``Conv_0``, ``project_input``, ...). Every block takes
``(x, train)``; ``train=True`` normalizes with batch statistics.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.resize import (
    avg_pool_2x,
    downsample_bilinear_half,
    upsample_nearest_2x,
)
from .layers import Conv, Dense, NormAct, activation_fn


class ResidualGeneratorBlock(nn.Module):
    """Pre-activation residual up block.

    main: [norm, act,] conv3(in->out), norm, act, conv3(out->out)
    shortcut: 1x1 projection iff in != out; nearest-2x upsample applied to
    the block input before both paths.
    """

    def __init__(self, in_dims: int, out_dims: int, upsample: bool = True,
                 first_block: bool = False, norm: str = "bn",
                 activation: str = "relu"):
        super().__init__()
        self.upsample = upsample
        self.first_block = first_block
        # flax numbers NormAct modules in creation order: the input norm,
        # when there is one, is NormAct_0 and the mid norm NormAct_1
        mid = "NormAct_0"
        if not first_block:
            self.NormAct_0 = NormAct(in_dims, norm, activation)
            mid = "NormAct_1"
        self.Conv_0 = Conv(in_dims, out_dims, 3)
        setattr(self, mid, NormAct(out_dims, norm, activation))
        self.mid_norm = mid
        self.Conv_1 = Conv(out_dims, out_dims, 3)
        if in_dims != out_dims:
            self.project_input = Conv(in_dims, out_dims, 1)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        # norm+act commute exactly with nearest upsampling (pointwise ops
        # on repeated values; the batch stats of the repeated tensor equal
        # those of the source), so they run at the small resolution, in
        # the same order as the reference (blocks.py:123-132)
        if self.upsample and not self.first_block:
            h = upsample_nearest_2x(self.NormAct_0(x, train))
            x = upsample_nearest_2x(x)
        else:
            if self.upsample:
                x = upsample_nearest_2x(x)
            h = x
            if not self.first_block:
                h = self.NormAct_0(h, train)
        h = self.Conv_0(h)
        h = getattr(self, self.mid_norm)(h, train)
        h = self.Conv_1(h)
        if hasattr(self, "project_input"):
            x = self.project_input(x)
        return x + h


class GeneratorInputMLP(nn.Module):
    """latent -> act(Linear) -> (B, out, size, size)."""

    def __init__(self, latent_dims: int, output_dims: int, size: int = 4,
                 activation: str = "relu"):
        super().__init__()
        self.output_dims = output_dims
        self.size = size
        self.act = activation_fn(activation)
        self.Dense_0 = Dense(latent_dims, size ** 2 * output_dims)

    def forward(self, z: torch.Tensor, train: bool = True) -> torch.Tensor:
        del train
        base = self.act(self.Dense_0(z))
        # flax reshapes the dense output as (B, H, W, C)
        base = base.reshape(-1, self.size, self.size, self.output_dims)
        return base.permute(0, 3, 1, 2).contiguous()


class TiledZGeneratorInput(nn.Module):
    """Tile z to a (B, latent, size, size) map."""

    def __init__(self, latent_dims: int, output_dims: int, size: int = 4,
                 activation: str = "relu"):
        super().__init__()
        if latent_dims != output_dims:
            raise ValueError("TiledZGeneratorInput needs latent_dims == "
                             f"output_dims, got {latent_dims}, {output_dims}")
        self.size = size

    def forward(self, z: torch.Tensor, train: bool = True) -> torch.Tensor:
        del train
        b, c = z.shape
        return z[:, :, None, None].expand(b, c, self.size, self.size)


class GeneratorOutput(nn.Module):
    """norm -> act -> 1x1 conv -> tanh."""

    def __init__(self, in_dims: int, out_dims: int, norm: str = "bn",
                 activation: str = "relu", output_activation: str = "tanh"):
        super().__init__()
        if output_activation not in ("tanh", "id"):
            raise ValueError(f"unknown output activation '{output_activation}'")
        self.output_activation = output_activation
        self.NormAct_0 = NormAct(in_dims, norm, activation)
        self.Conv_0 = Conv(in_dims, out_dims, 1)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = self.Conv_0(self.NormAct_0(x, train))
        if self.output_activation == "tanh":
            x = torch.tanh(x)
        return x


class DiscriminatorInput(nn.Module):
    """1x1 conv image -> features."""

    def __init__(self, in_dims: int, out_dims: int):
        super().__init__()
        self.Conv_0 = Conv(in_dims, out_dims, 1)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        del train
        return self.Conv_0(x)


class ResidualDiscriminatorBlock(nn.Module):
    """Pre-activation residual down block.

    main: [norm, act,] conv3(in->out), norm, act, conv3(out->out), avgpool2
    shortcut: bilinear 0.5x (align_corners=True), then a 1x1 projection iff
    in != out.
    """

    def __init__(self, in_dims: int, out_dims: int, first_block: bool = False,
                 norm: str = "bn", activation: str = "relu"):
        super().__init__()
        self.first_block = first_block
        # flax's creation order, as in ResidualGeneratorBlock
        mid = "NormAct_0"
        if not first_block:
            self.NormAct_0 = NormAct(in_dims, norm, activation)
            mid = "NormAct_1"
        self.Conv_0 = Conv(in_dims, out_dims, 3)
        setattr(self, mid, NormAct(out_dims, norm, activation))
        self.mid_norm = mid
        self.Conv_1 = Conv(out_dims, out_dims, 3)
        if in_dims != out_dims:
            self.project_input = Conv(in_dims, out_dims, 1)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        h = x if self.first_block else self.NormAct_0(x, train)
        h = self.Conv_0(h)
        h = getattr(self, self.mid_norm)(h, train)
        h = avg_pool_2x(self.Conv_1(h))
        x = downsample_bilinear_half(x, align_corners=True)
        if hasattr(self, "project_input"):
            x = self.project_input(x)
        return x + h


class DiscriminatorOutput(nn.Module):
    """norm -> act -> spatial sum-pool -> Linear."""

    def __init__(self, in_dims: int, out_dims: int, norm: str = "bn",
                 activation: str = "relu"):
        super().__init__()
        self.NormAct_0 = NormAct(in_dims, norm, activation)
        self.Dense_0 = Dense(in_dims, out_dims)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = self.NormAct_0(x, train)
        return self.Dense_0(x.sum(dim=(2, 3)))
