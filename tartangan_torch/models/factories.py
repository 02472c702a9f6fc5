"""CLI-name -> module-factory assembly.

Counterpart of ``tartangan_tpu/models/factories.py`` for the generator
(``g_input_factory``, ``g_block_factory``, ``g_output_factory``) and the
discriminator (``d_input_factory``, ``d_block_factory``,
``d_output_factory``): ``--g-base {mlp,tiledz}``, ``--norm {bn,id}``,
``--activation {relu,selu,elu}``, ``--parity-blocks {auto,on,off}``
(``resolve_parity``), ``ndim=1`` for the text GAN's NCL blocks and its
``"mlp1d"`` input, the fused G block (``g_block_factory(fused=True)``,
no CLI flag, as in the reference), ``--remat``/``--remat-policy``
(``remat=``, ``remat_policy_name=``; ``ops/remat.py``), and the IQN and
InfoGAN discriminators' output heads (``iqn_d_output_factory``,
``info_d_output_factory``).
"""
from __future__ import annotations

from ..ops.remat import remat_policy
from .blocks import (
    DiscriminatorInput,
    DiscriminatorOutput,
    FusedResidualGeneratorBlock,
    GeneratorInputMLP,
    GeneratorInputMLP1d,
    GeneratorOutput,
    IQNDiscriminatorOutput,
    LinearOutput,
    MultiModelDiscriminatorOutput,
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
    "mlp1d": GeneratorInputMLP1d,
}


def g_input_factory(g_base: str, activation: str):
    cls = G_INPUTS[g_base]

    def factory(latent_dims, output_dims, size):
        return cls(latent_dims, output_dims, size, activation=activation)
    return factory


def _rematted(block, policy):
    block.remat_policy = policy
    return block


def g_block_factory(norm: str, activation: str, fused: bool = False,
                    parity: bool = False, remat: bool = False,
                    remat_policy_name: str = "full", ndim: int = 2):
    """``parity=True`` (--parity-blocks) builds the thin tower blocks
    (upsample, not first, out_dims <= PARITY_MAX_DIMS) in the parity
    domain (``ParityResidualGeneratorBlock``); ``fused=True`` builds the
    other upsampling, not-first blocks as ``FusedResidualGeneratorBlock``
    (K4/K5) where norm is 'bn' and the activation 'relu'. Parity is
    checked first, as in the reference. ``remat=True`` (--remat)
    rematerializes the residual and parity blocks under
    ``remat_policy_name``; the fused block is not rematerialized, as in the
    reference (``factories.py:125-131``). Parity and fused blocks are 2-D
    only; ``ndim=1`` builds the plain blocks over NCL."""
    fused_ok = fused and norm == "bn" and activation == "relu" and ndim == 2
    parity_ok = parity and norm in ("bn", "id") and ndim == 2
    policy = remat_policy(remat_policy_name) if remat else None

    def factory(in_dims, out_dims, *, first_block=False, upsample=True):
        if (parity_ok and upsample and not first_block
                and out_dims <= PARITY_MAX_DIMS):
            return _rematted(ParityResidualGeneratorBlock(
                in_dims, out_dims, norm=norm, activation=activation), policy)
        if fused_ok and upsample and not first_block:
            return FusedResidualGeneratorBlock(
                in_dims, out_dims, norm=norm, activation=activation)
        return _rematted(ResidualGeneratorBlock(
            in_dims, out_dims, upsample=upsample, first_block=first_block,
            norm=norm, activation=activation, ndim=ndim,
        ), policy)
    return factory


def g_output_factory(norm: str, activation: str, output_activation="tanh",
                     ndim: int = 2):
    def factory(in_dims, out_dims):
        return GeneratorOutput(in_dims, out_dims, norm=norm,
                               activation=activation,
                               output_activation=output_activation,
                               ndim=ndim)
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


def d_input_factory(ndim: int = 2):
    def factory(in_dims, out_dims):
        return DiscriminatorInput(in_dims, out_dims, ndim=ndim)
    return factory


def d_block_factory(norm: str, activation: str, parity: bool = False,
                    remat: bool = False, remat_policy_name: str = "full",
                    ndim: int = 2):
    """``parity=True`` builds blocks with out_dims <= PARITY_MAX_DIMS as
    ``ParityResidualDiscriminatorBlock`` (2-D only); ``remat=True``
    rematerializes every block under ``remat_policy_name``."""
    parity_ok = parity and norm in ("bn", "id") and ndim == 2
    policy = remat_policy(remat_policy_name) if remat else None

    def factory(in_dims, out_dims, *, first_block=False):
        if parity_ok and out_dims <= PARITY_MAX_DIMS:
            block = ParityResidualDiscriminatorBlock(
                in_dims, out_dims, first_block=first_block, norm=norm,
                activation=activation)
        else:
            block = ResidualDiscriminatorBlock(
                in_dims, out_dims, first_block=first_block, norm=norm,
                activation=activation, ndim=ndim)
        return _rematted(block, policy)
    return factory


def d_output_factory(norm: str, activation: str):
    def factory(in_dims, out_dims):
        return DiscriminatorOutput(in_dims, out_dims, norm=norm,
                                   activation=activation)
    return factory


def iqn_d_output_factory(norm: str, activation: str):
    def factory(in_dims, out_dims):
        return IQNDiscriminatorOutput(in_dims, out_dims, norm=norm,
                                      activation=activation)
    return factory


def info_d_output_factory(norm: str, activation: str, code_dims: int):
    """Two heads on one trunk: the adversarial logit and the latent code's
    reconstruction (``factories.py:197-211``)."""
    heads = (lambda in_dims: LinearOutput(in_dims, 1),
             lambda in_dims: LinearOutput(in_dims, code_dims))

    def factory(in_dims, out_dims):
        del out_dims
        return MultiModelDiscriminatorOutput(
            in_dims, head_factories=heads, norm=norm, activation=activation)
    return factory
