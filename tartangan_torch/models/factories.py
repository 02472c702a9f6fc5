"""CLI-name -> module-factory assembly.

Counterpart of ``tartangan_tpu/models/factories.py`` for the generator
(``g_input_factory``, ``g_block_factory``, ``g_output_factory``) and the
discriminator (``d_input_factory``, ``d_block_factory``,
``d_output_factory``): ``--g-base {mlp,tiledz}``, ``--norm {bn,id}``,
``--activation {relu,selu,elu}``, ``--parity-blocks {auto,on,off}``
(``resolve_parity``), and the fused G block (``g_block_factory(fused=True)``,
no CLI flag, as in the reference). Remat is not ported yet.
"""
from __future__ import annotations

from .blocks import (
    DiscriminatorInput,
    DiscriminatorOutput,
    FusedResidualGeneratorBlock,
    GeneratorInputMLP,
    GeneratorOutput,
    ParityResidualDiscriminatorBlock,
    ParityResidualGeneratorBlock,
    ResidualDiscriminatorBlock,
    ResidualGeneratorBlock,
    TiledZGeneratorInput,
)

# the widest tower block that takes the parity form (the reference's
# bound, ``factories.py:51``; whether it suits the H100 is a measurement)
PARITY_MAX_DIMS = 64

G_INPUTS = {
    "mlp": GeneratorInputMLP,
    "tiledz": TiledZGeneratorInput,
}


def g_input_factory(g_base: str, activation: str):
    cls = G_INPUTS[g_base]

    def factory(latent_dims, output_dims, size):
        return cls(latent_dims, output_dims, size, activation=activation)
    return factory


def g_block_factory(norm: str, activation: str, fused: bool = False,
                    parity: bool = False):
    """``parity=True`` (--parity-blocks) builds the thin tower blocks
    (upsample, not first, out_dims <= PARITY_MAX_DIMS) in the parity
    domain (``ParityResidualGeneratorBlock``); ``fused=True`` builds the
    other upsampling, not-first blocks as ``FusedResidualGeneratorBlock``
    (K4/K5) where norm is 'bn' and the activation 'relu'. Parity is
    checked first, as in the reference."""
    fused_ok = fused and norm == "bn" and activation == "relu"
    parity_ok = parity and norm in ("bn", "id")

    def factory(in_dims, out_dims, *, first_block=False, upsample=True):
        if (parity_ok and upsample and not first_block
                and out_dims <= PARITY_MAX_DIMS):
            return ParityResidualGeneratorBlock(
                in_dims, out_dims, norm=norm, activation=activation)
        if fused_ok and upsample and not first_block:
            return FusedResidualGeneratorBlock(
                in_dims, out_dims, norm=norm, activation=activation)
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
    """--parity-blocks {auto,on,off}: 'on' gives the parity block forms,
    'off' the plain ones, and 'auto' the plain ones too: the reference
    turns them on only on a TPU (``factories.py:76-85``), and the port
    never runs on one. What 'auto' should pick on the H100 is a question
    for the measurements in PERF.md."""
    if choice == "on":
        return True
    if choice not in ("auto", "off"):
        raise ValueError(f"unknown --parity-blocks '{choice}'")
    return False


def d_input_factory():
    def factory(in_dims, out_dims):
        return DiscriminatorInput(in_dims, out_dims)
    return factory


def d_block_factory(norm: str, activation: str, parity: bool = False):
    """``parity=True`` builds blocks with out_dims <= PARITY_MAX_DIMS as
    ``ParityResidualDiscriminatorBlock``."""
    parity_ok = parity and norm in ("bn", "id")

    def factory(in_dims, out_dims, *, first_block=False):
        cls = (ParityResidualDiscriminatorBlock
               if parity_ok and out_dims <= PARITY_MAX_DIMS
               else ResidualDiscriminatorBlock)
        return cls(in_dims, out_dims, first_block=first_block, norm=norm,
                   activation=activation)
    return factory


def d_output_factory(norm: str, activation: str):
    def factory(in_dims, out_dims):
        return DiscriminatorOutput(in_dims, out_dims, norm=norm,
                                   activation=activation)
    return factory
