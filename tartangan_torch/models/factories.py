"""CLI-name -> module-factory assembly.

Counterpart of ``tartangan_tpu/models/factories.py`` for the generator
(``g_input_factory``, ``g_block_factory``, ``g_output_factory``) and the
discriminator (``d_input_factory``, ``d_block_factory``,
``d_output_factory``): ``--g-base {mlp,tiledz}``, ``--norm {bn,id}``,
``--activation {relu,selu,elu}``. Remat and the parity / fused block forms
are not ported yet: ``resolve_parity`` turns ``--parity-blocks auto`` off
(the JAX package turns it on only on a TPU) and raises for ``on``.
"""
from __future__ import annotations

from .blocks import (
    DiscriminatorInput,
    DiscriminatorOutput,
    GeneratorInputMLP,
    GeneratorOutput,
    ResidualDiscriminatorBlock,
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


def resolve_parity(choice: str) -> bool:
    """--parity-blocks {auto,on,off}: 'auto' and 'off' give the plain
    blocks; the parity forms are not ported yet."""
    if choice == "on":
        raise NotImplementedError(
            "--parity-blocks on: the parity block forms are not ported yet")
    if choice not in ("auto", "off"):
        raise ValueError(f"unknown --parity-blocks '{choice}'")
    return False


def d_input_factory():
    def factory(in_dims, out_dims):
        return DiscriminatorInput(in_dims, out_dims)
    return factory


def d_block_factory(norm: str, activation: str):
    def factory(in_dims, out_dims, *, first_block=False):
        return ResidualDiscriminatorBlock(
            in_dims, out_dims, first_block=first_block, norm=norm,
            activation=activation)
    return factory


def d_output_factory(norm: str, activation: str):
    def factory(in_dims, out_dims):
        return DiscriminatorOutput(in_dims, out_dims, norm=norm,
                                   activation=activation)
    return factory
