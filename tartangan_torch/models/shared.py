"""The shared-filter model family: one 3x3 filter bank a model, of which
every block's convolutions slice a corner.

Counterpart of ``tartangan_tpu/models/shared.py``: ``xavier_uniform_relu_
gain`` (:35), ``narrow_filters`` (:47), ``SharedConvBlock`` (:62),
``SharedResidualGeneratorBlock`` (:83), ``SharedResidualDiscriminatorBlock``
(:111), ``_SharedBase._bank`` (:156) and ``SharedGenerator``,
``SharedDiscriminator``, ``SharedIQNDiscriminator`` (:165-243).

The bank is one parameter of the model, ``shared_filters``, OIHW
(max_out, max_in, 3, 3) (HWIO in the flax tree, ``convert.py``). Each
block's conv takes the slice ``[:out, :in]`` at call time, cast to the
compute dtype, so every block's gradient accumulates into the one float32
tensor, to second order under R1. Both G and D resample with bilinear
``align_corners=True`` (``ops/resize.py::resize_bilinear``, the JAX
package's matrices), unlike the unshared family. Submodules keep flax's
auto-names (``SharedResidualGeneratorBlock_0``, ``SharedConvBlock_1``,
``SelfAttention2d_0``, ``GeneratorOutput_0``, ...) as attribute names.

As in the reference, ``g_base`` is taken and unused (G always starts with
``GeneratorInputMLP``), and the family has no parity or remat forms. The
attention runs K1/K2 (``models/attention.py``).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..configs import GANConfig
from ..ops import parity as P
from ..ops.resize import resize_bilinear
from .attention import SelfAttention2d
from .blocks import (
    DiscriminatorInput,
    DiscriminatorOutput,
    GeneratorInputMLP,
    GeneratorOutput,
    IQNDiscriminatorOutput,
)
from .layers import AutoNamed, NormAct


@torch.no_grad()
def xavier_uniform_relu_gain_(bank: torch.Tensor,
                              generator: torch.Generator | None) -> None:
    """torch's ``xavier_uniform_(w, gain=calculate_gain('relu'))`` on the
    OIHW bank: fans are counted over the whole bank (9 * in, 9 * out)."""
    cout, cin, kh, kw = bank.shape
    bound = math.sqrt(2.0) * math.sqrt(6.0 / (kh * kw * (cin + cout)))
    bank.uniform_(-bound, bound, generator=generator)


def narrow_filters(bank: torch.Tensor, in_dims: int,
                   out_dims: int) -> torch.Tensor:
    """The (out, in, 3, 3) corner of the OIHW bank."""
    return bank[:out_dims, :in_dims]


def _conv_with(bank_slice, x, bias=None):
    """SAME 3x3 conv of NCHW ``x`` with a bank slice, in x's dtype
    (``ops/parity.py::conv2d``: a contiguous copy on the CPU, the slice and
    bias cast at use)."""
    return P.conv2d(x, bank_slice, bias, padding=1)


class SharedConvBlock(nn.Module):
    """[norm, act,] shared 3x3 conv + its own bias (zeros at init)."""

    def __init__(self, in_dims: int, out_dims: int, apply_norm: bool = True,
                 use_bias: bool = True, norm: str = "bn",
                 activation: str = "relu"):
        super().__init__()
        self.in_dims, self.out_dims = in_dims, out_dims
        if apply_norm:
            self.NormAct_0 = NormAct(in_dims, norm, activation)
        self.bias = nn.Parameter(torch.zeros(out_dims)) if use_bias else None

    def forward(self, x: torch.Tensor, bank: torch.Tensor,
                train: bool = True) -> torch.Tensor:
        if hasattr(self, "NormAct_0"):
            x = self.NormAct_0(x, train)
        return _conv_with(narrow_filters(bank, self.in_dims, self.out_dims),
                          x, self.bias)


def _two_convs(in_dims, out_dims, apply_norm, norm, activation):
    return (SharedConvBlock(in_dims, out_dims, apply_norm=apply_norm,
                            norm=norm, activation=activation),
            SharedConvBlock(out_dims, out_dims, apply_norm=True, norm=norm,
                            activation=activation))


class SharedResidualGeneratorBlock(nn.Module):
    """bilinear 2x upsample -> two shared convs, + the upsampled input
    (through the bank's (out, in) corner, no bias, when the widths
    differ)."""

    def __init__(self, in_dims: int, out_dims: int, apply_norm: bool = True,
                 norm: str = "bn", activation: str = "relu"):
        super().__init__()
        self.in_dims, self.out_dims = in_dims, out_dims
        self.SharedConvBlock_0, self.SharedConvBlock_1 = _two_convs(
            in_dims, out_dims, apply_norm, norm, activation)

    def forward(self, x: torch.Tensor, bank: torch.Tensor,
                train: bool = True) -> torch.Tensor:
        h, w = x.shape[2:]
        x = resize_bilinear(x, h * 2, w * 2, align_corners=True)
        y = self.SharedConvBlock_1(self.SharedConvBlock_0(x, bank, train),
                                   bank, train)
        if self.in_dims != self.out_dims:
            x = _conv_with(narrow_filters(bank, self.in_dims, self.out_dims),
                           x)
        return x + y


class SharedResidualDiscriminatorBlock(nn.Module):
    """two shared convs -> bilinear 0.5x, + the input at 0.5x (through the
    bank's corner when the widths differ)."""

    def __init__(self, in_dims: int, out_dims: int, apply_norm: bool = True,
                 norm: str = "bn", activation: str = "relu"):
        super().__init__()
        self.in_dims, self.out_dims = in_dims, out_dims
        self.SharedConvBlock_0, self.SharedConvBlock_1 = _two_convs(
            in_dims, out_dims, apply_norm, norm, activation)

    def forward(self, x: torch.Tensor, bank: torch.Tensor,
                train: bool = True) -> torch.Tensor:
        h, w = x.shape[2:]
        y = self.SharedConvBlock_1(self.SharedConvBlock_0(x, bank, train),
                                   bank, train)
        y = resize_bilinear(y, h // 2, w // 2, align_corners=True)
        x = resize_bilinear(x, h // 2, w // 2, align_corners=True)
        if self.in_dims != self.out_dims:
            x = _conv_with(narrow_filters(bank, self.in_dims, self.out_dims),
                           x)
        return x + y


class _SharedBase(AutoNamed):
    """The bank and the tower. ``dtype`` is the compute dtype (None: the
    input's own), as ``models/pluggan.py``'s."""

    def __init__(self, config: GANConfig, norm: str = "bn",
                 activation: str = "relu", g_base: str = "mlp",
                 dtype: torch.dtype | None = None):
        super().__init__()
        del g_base  # the reference takes it and builds the MLP input
        self.config = config
        self.dtype = dtype
        self.norm, self.activation = norm, activation
        max_in = max([config.latent_dims, *config.blocks])
        max_out = max(config.blocks)
        self.shared_filters = nn.Parameter(torch.empty(max_out, max_in, 3, 3))
        self.init_parameters_(None)

    def init_parameters_(self, generator):
        """The bank's init; ``ops/init.py::init_module_`` calls it, and
        draws the blocks' convs and denses with torch's default."""
        xavier_uniform_relu_gain_(self.shared_filters, generator)

    @property
    def max_size(self) -> int:
        return self.config.max_size

    def _tower(self, in_dims, order, block_cls):
        """The blocks over ``order`` ((block_i, out_dims) pairs) from
        ``in_dims``, the first without its input norm, attention after
        each ``block_i in config.attention``; returns the last width."""
        cfg = self.config
        apply_norm = False
        for block_i, out_dims in order:
            self._add(block_cls(in_dims, out_dims, apply_norm=apply_norm,
                                norm=self.norm, activation=self.activation))
            apply_norm = True
            if cfg.attention and block_i in cfg.attention:
                self._add(SelfAttention2d(out_dims))
            in_dims = out_dims
        return in_dims

    def _run(self, x, train, *head_args, **head_kwargs):
        if self.dtype is not None:
            x = x.to(self.dtype)
        for name in self.layers[:-1]:
            layer = getattr(self, name)
            if isinstance(layer, (SharedResidualGeneratorBlock,
                                  SharedResidualDiscriminatorBlock)):
                x = layer(x, self.shared_filters, train)
            else:
                x = layer(x, train)
        return getattr(self, self.layers[-1])(x, train, *head_args,
                                              **head_kwargs)


class SharedGenerator(_SharedBase):
    """latent -> ``GeneratorInputMLP`` -> shared residual up blocks (+
    attention) -> ``GeneratorOutput``: images (B, data_dims, H, W)."""

    def __init__(self, config: GANConfig, **kwargs):
        super().__init__(config, **kwargs)
        cfg = config
        self._add(GeneratorInputMLP(cfg.latent_dims, cfg.blocks[0],
                                    cfg.base_size,
                                    activation=self.activation))
        in_dims = self._tower(cfg.blocks[0], enumerate(cfg.blocks),
                              SharedResidualGeneratorBlock)
        self._add(GeneratorOutput(in_dims, cfg.data_dims, norm=self.norm,
                                  activation=self.activation))

    def forward(self, z: torch.Tensor, train: bool = True) -> torch.Tensor:
        return self._run(z, train)


class _SharedD(_SharedBase):
    """``DiscriminatorInput`` -> shared residual down blocks over the
    reversed widths (+ attention) -> the head ``head_cls``."""

    head_cls = DiscriminatorOutput

    def __init__(self, config: GANConfig, **kwargs):
        super().__init__(config, **kwargs)
        cfg = config
        self._add(DiscriminatorInput(cfg.data_dims, cfg.blocks[-1]))
        in_dims = self._tower(cfg.blocks[-1],
                              reversed(list(enumerate(cfg.blocks))),
                              SharedResidualDiscriminatorBlock)
        self._add(self.head_cls(in_dims, 1, norm=self.norm,
                                activation=self.activation))

    @property
    def output_block(self) -> nn.Module:
        return getattr(self, self.layers[-1])


class SharedDiscriminator(_SharedD):
    """Images (B, data_dims, H, W) -> logits (B, 1)."""

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        return self._run(x, train)


class SharedIQNDiscriminator(_SharedD):
    """The shared D with the IQN head: (B, 1) predictions, and the
    quantile loss with ``targets``; ``taus`` (Q*B, 1) are the caller's."""

    head_cls = IQNDiscriminatorOutput

    def forward(self, x: torch.Tensor, train: bool = True, targets=None,
                taus: torch.Tensor | None = None):
        return self._run(x, train, targets=targets, taus=taus)
