""""Pluggan": factory-composed generator and discriminator.

Counterparts of ``tartangan_tpu/models/pluggan.py::Generator`` (:76-146),
``Discriminator`` (:149-214) and ``IQNDiscriminator`` (:217-261), with the
parity-domain fusions at the G
output, the D input and the seams between parity D blocks. The blocks
lists are built exactly as there, so ``blocks[i]`` is flax's ``blocks_i``:
with attention after block 3, the attention layer takes index 4 and every
later block shifts by one.

``dtype`` is the compute dtype (the reference's ``dtype`` attribute, with
float32 parameters): each model casts its input to it, and every layer
computes in its input's dtype. None computes in the input's own dtype (a
float64 model on float64 inputs, as ``chip_smoke.py``'s witness runs).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from ..configs import GANConfig
from .attention import SelfAttention2d
from .blocks import (
    DiscriminatorBlock,
    DiscriminatorInput,
    DiscriminatorOutput,
    GeneratorBlock,
    GeneratorOutput,
    ParityDiscriminatorInput,
    ParityGeneratorOutput,
    ParityResidualDiscriminatorBlock,
    ParityResidualGeneratorBlock,
    TiledZGeneratorInput,
)


# the factories a model takes when it is given none (``pluggan.py:33-57``)
def _default_g_input(latent_dims, output_dims, size):
    return TiledZGeneratorInput(latent_dims, output_dims, size)


def _default_g_block(in_dims, out_dims, *, first_block=False, upsample=True):
    return GeneratorBlock(in_dims, out_dims, upsample=upsample,
                          first_block=first_block)


def _default_g_output(in_dims, out_dims):
    return GeneratorOutput(in_dims, out_dims)


def _default_d_input(in_dims, out_dims):
    return DiscriminatorInput(in_dims, out_dims)


def _default_d_block(in_dims, out_dims, *, first_block=False):
    return DiscriminatorBlock(in_dims, out_dims, first_block=first_block)


def _default_d_output(in_dims, out_dims):
    return DiscriminatorOutput(in_dims, out_dims)


def _chain_parity_d_blocks(blocks):
    """Keep consecutive parity D blocks in the parity layout across their
    seam (``pluggan.py:60-73``): the earlier one emits the half-resolution
    parity stack and the later one takes it. Attention or a plain block
    between them breaks the chain."""
    for a, b in zip(blocks, blocks[1:]):
        if isinstance(a, ParityResidualDiscriminatorBlock) \
                and isinstance(b, ParityResidualDiscriminatorBlock):
            a.set_layout(emit_parity=True)
            b.set_layout(accept_parity=True)


class Generator(nn.Module):
    """Upsampling stack: input -> per-scale blocks (+SA) -> output.

    The factories come from ``models/factories.py``; a factory not given
    takes the JAX package's default (``TiledZGeneratorInput``, the
    non-residual ``GeneratorBlock``, ``GeneratorOutput``).
    """

    def __init__(self, config: GANConfig,
                 input_factory: Callable | None = None,
                 block_factory: Callable | None = None,
                 output_factory: Callable | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        input_factory = input_factory or _default_g_input
        block_factory = block_factory or _default_g_block
        output_factory = output_factory or _default_g_output

        self.input_block = input_factory(config.latent_dims, config.blocks[0],
                                         config.base_size)
        blocks = []
        in_dims = config.blocks[0]
        first_block = True
        for block_i, out_dims in enumerate(config.blocks):
            blocks.append(block_factory(in_dims, out_dims,
                                        first_block=first_block,
                                        upsample=True))
            first_block = False
            for _ in range(config.num_blocks_per_scale - 1):
                blocks.append(block_factory(out_dims, out_dims,
                                            first_block=False,
                                            upsample=False))
            if config.attention and block_i in config.attention:
                blocks.append(SelfAttention2d(out_dims))
            in_dims = out_dims
        output_block = output_factory(in_dims, config.data_dims)
        # the parity output fusion (pluggan.py:122-138): when the tower
        # ends in a parity block and the output stage is the standard one,
        # the hand-off stays in the parity layout
        if (blocks and isinstance(blocks[-1], ParityResidualGeneratorBlock)
                and type(output_block) is GeneratorOutput
                and output_block.norm in ("bn", "id")):
            blocks[-1].emit_parity = True
            output_block = ParityGeneratorOutput(
                in_dims, config.data_dims, norm=output_block.norm,
                activation=output_block.activation,
                output_activation=output_block.output_activation)
        self.blocks = nn.ModuleList(blocks)
        self.output_block = output_block

    @property
    def max_size(self) -> int:
        return self.config.max_size

    def forward(self, z: torch.Tensor, train: bool = True) -> torch.Tensor:
        """z (B, latent) -> images (B, data_dims, H, W), NCHW, in the
        compute dtype."""
        if self.dtype is not None:
            z = z.to(self.dtype)
        x = self.input_block(z, train)
        for block in self.blocks:
            x = block(x, train)
        return self.output_block(x, train)


class Discriminator(nn.Module):
    """Downsampling mirror of the generator: input 1x1 conv -> blocks over
    ``reversed(config.blocks)`` (+SA after ``block_i in config.attention``)
    -> output head with one logit.

    A factory not given takes the JAX package's default
    (``DiscriminatorInput``, the non-residual ``DiscriminatorBlock``,
    ``DiscriminatorOutput``); the trainers pass the residual factory, as
    the JAX trainers do.
    """

    def __init__(self, config: GANConfig,
                 input_factory: Callable | None = None,
                 block_factory: Callable | None = None,
                 output_factory: Callable | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        input_factory = input_factory or _default_d_input
        block_factory = block_factory or _default_d_block
        output_factory = output_factory or _default_d_output
        in_dims = config.blocks[-1]
        input_block = input_factory(config.data_dims, in_dims)
        blocks = []
        first_block = True
        for block_i, out_dims in reversed(list(enumerate(config.blocks))):
            blocks.append(block_factory(in_dims, out_dims,
                                        first_block=first_block))
            if config.attention and block_i in config.attention:
                blocks.append(SelfAttention2d(out_dims))
            in_dims = out_dims
            first_block = False
        # the parity input fusion (pluggan.py:189-205): the image is
        # parity-stacked first and the first tower block takes that layout
        if (blocks and isinstance(blocks[0], ParityResidualDiscriminatorBlock)
                and type(input_block) is DiscriminatorInput):
            input_block = ParityDiscriminatorInput(config.data_dims,
                                                   config.blocks[-1])
            blocks[0].set_layout(accept_parity=True)
        _chain_parity_d_blocks(blocks)
        self.input_block = input_block
        self.blocks = nn.ModuleList(blocks)
        self.output_block = output_factory(in_dims, 1)

    @property
    def max_size(self) -> int:
        return self.config.max_size

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        """images (B, data_dims, H, W), NCHW -> logits (B, 1), in the
        compute dtype (``pluggan.py:258`` casts D's input)."""
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = self.input_block(x, train)
        for block in self.blocks:
            x = block(x, train)
        return self.output_block(x, train)


class IQNDiscriminator(nn.Module):
    """Discriminator ending in the IQN quantile head, which computes the
    quantile-Huber loss when ``targets`` is given. Like the reference
    (``pluggan.py:217-261``) it has no input conv and never sets
    ``first_block``: the first block normalizes the image's channels.
    ``taus`` are the head's (Q*B, 1) quantiles, drawn by the caller."""

    def __init__(self, config: GANConfig, block_factory: Callable,
                 output_factory: Callable, dtype: torch.dtype | None = None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        blocks = []
        in_dims = config.data_dims
        for block_i, out_dims in reversed(list(enumerate(config.blocks))):
            blocks.append(block_factory(in_dims, out_dims, first_block=False))
            if config.attention and block_i in config.attention:
                blocks.append(SelfAttention2d(out_dims))
            in_dims = out_dims
        _chain_parity_d_blocks(blocks)
        self.blocks = nn.ModuleList(blocks)
        self.output_block = output_factory(in_dims, 1)

    @property
    def max_size(self) -> int:
        return self.config.max_size

    def forward(self, x: torch.Tensor, train: bool = True, targets=None,
                taus: torch.Tensor | None = None):
        """images (B, data_dims, H, W), NCHW -> (B, 1) predictions, and the
        loss with ``targets``."""
        if self.dtype is not None:
            x = x.to(self.dtype)
        for block in self.blocks:
            x = block(x, train)
        return self.output_block(x, train, targets=targets, taus=taus)
