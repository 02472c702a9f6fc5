"""CLI-name -> generator module-factory assembly.

Counterpart of the generator side of ``tartangan_tpu/models/factories.py``
(``g_input_factory``, ``g_block_factory``, ``g_output_factory``):
``--g-base {mlp,tiledz}``, ``--norm {bn,id}``, ``--activation
{relu,selu,elu}``. Remat and the parity / fused block forms are not ported
yet.
"""
from __future__ import annotations

from .blocks import (
    GeneratorInputMLP,
    GeneratorOutput,
    ResidualGeneratorBlock,
    TiledZGeneratorInput,
)

G_INPUTS = {
    "mlp": GeneratorInputMLP,
    "tiledz": TiledZGeneratorInput,
}


def g_input_factory(g_base: str, activation: str):
    cls = G_INPUTS[g_base]

    def factory(latent_dims, output_dims, size):
        return cls(latent_dims, output_dims, size, activation=activation)
    return factory


def g_block_factory(norm: str, activation: str):
    def factory(in_dims, out_dims, *, first_block=False, upsample=True):
        return ResidualGeneratorBlock(
            in_dims, out_dims, upsample=upsample, first_block=first_block,
            norm=norm, activation=activation,
        )
    return factory


def g_output_factory(norm: str, activation: str, output_activation="tanh"):
    def factory(in_dims, out_dims):
        return GeneratorOutput(in_dims, out_dims, norm=norm,
                               activation=activation,
                               output_activation=output_activation)
    return factory
