""""Pluggan": factory-composed generator and discriminator.

Counterparts of ``tartangan_tpu/models/pluggan.py::Generator`` (:76-146)
and ``Discriminator`` (:149-214), with the parity-domain fusions at the G
output, the D input and the seams between parity D blocks. The blocks
lists are built exactly as there, so ``blocks[i]`` is flax's ``blocks_i``:
with attention after block 3, the attention layer takes index 4 and every
later block shifts by one.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from ..configs import GANConfig
from .attention import SelfAttention2d
from .blocks import (
    DiscriminatorInput,
    GeneratorOutput,
    ParityDiscriminatorInput,
    ParityGeneratorOutput,
    ParityResidualDiscriminatorBlock,
    ParityResidualGeneratorBlock,
)


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

    The factories come from ``models/factories.py``; the JAX package's
    defaults (``TiledZGeneratorInput`` with the non-residual
    ``GeneratorBlock``) are not ported.
    """

    def __init__(self, config: GANConfig, input_factory: Callable,
                 block_factory: Callable, output_factory: Callable):
        super().__init__()
        self.config = config

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
        """z (B, latent) -> images (B, data_dims, H, W), NCHW."""
        x = self.input_block(z, train)
        for block in self.blocks:
            x = block(x, train)
        return self.output_block(x, train)


class Discriminator(nn.Module):
    """Downsampling mirror of the generator: input 1x1 conv -> blocks over
    ``reversed(config.blocks)`` (+SA after ``block_i in config.attention``)
    -> output head with one logit.

    The JAX package's default block (the non-residual
    ``DiscriminatorBlock``) is not ported; the trainer always passes the
    residual factory, as the JAX trainer does.
    """

    def __init__(self, config: GANConfig, input_factory: Callable,
                 block_factory: Callable, output_factory: Callable):
        super().__init__()
        self.config = config
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
        """images (B, data_dims, H, W), NCHW -> logits (B, 1)."""
        x = self.input_block(x, train)
        for block in self.blocks:
            x = block(x, train)
        return self.output_block(x, train)
