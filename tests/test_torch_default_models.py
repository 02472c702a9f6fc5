"""The models' remaining pieces against the JAX package on the same
weights: ``PixelNorm``, the non-residual ``GeneratorBlock`` and
``DiscriminatorBlock`` (2-D and 1-D), ``Generator`` and ``Discriminator``
built with the default factories, and the hinge losses. Float32: 1e-5 for
layers, blocks and losses, 1e-4 for whole models (summation order differs
between the frameworks and the difference grows through the tower, as in
``test_torch_discriminator.py``).
"""
import torch_threads  # noqa: F401  (this process's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tartangan_tpu.configs import GAN_CONFIGS as JAX_GAN_CONFIGS
from tartangan_tpu.models import blocks as jblocks
from tartangan_tpu.models import layers as jlayers
from tartangan_tpu.models import losses as jlosses
from tartangan_tpu.models.pluggan import Discriminator as JaxDiscriminator
from tartangan_tpu.models.pluggan import Generator as JaxGenerator
from tartangan_torch.configs import GAN_CONFIGS
from tartangan_torch.convert import from_flax, to_flax
from tartangan_torch.models import blocks, layers, losses
from tartangan_torch.models.pluggan import Discriminator, Generator

TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def _channels_first(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _channels_last(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _perturbed(variables, rng):
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(
            np.shape(a))).astype(np.float32), jax.device_get(variables))


def test_pixel_norm(rng):
    x = rng.standard_normal((2, 5, 6, 7)).astype(np.float32)
    ref = jlayers.PixelNorm().apply({}, jnp.asarray(x))
    np.testing.assert_allclose(
        _channels_last(layers.PixelNorm()(_channels_first(x))),
        np.asarray(ref), **TOL)


@pytest.mark.parametrize("kind,ndim,first,up", [
    ("g", 2, False, True), ("g", 2, True, True), ("g", 2, False, False),
    ("g", 1, False, True), ("d", 2, False, None), ("d", 2, True, None),
    ("d", 1, False, None),
])
def test_plain_blocks(rng, kind, ndim, first, up):
    """The blocks and their flax names (``NormAct_i``, ``Conv_i``) through
    ``from_flax``/``to_flax``, in train mode (batch statistics) and eval
    mode (the running statistics, perturbed)."""
    in_dims, out_dims = 6, 4
    if kind == "g":
        jmod = jblocks.GeneratorBlock(in_dims, out_dims, upsample=up,
                                      first_block=first, ndim=ndim)
        tmod = blocks.GeneratorBlock(in_dims, out_dims, upsample=up,
                                     first_block=first, ndim=ndim)
    else:
        jmod = jblocks.DiscriminatorBlock(in_dims, out_dims,
                                          first_block=first, ndim=ndim)
        tmod = blocks.DiscriminatorBlock(in_dims, out_dims,
                                         first_block=first, ndim=ndim)
    shape = (3,) + (8,) * ndim + (in_dims,)
    x = rng.standard_normal(shape).astype(np.float32)
    variables = _perturbed(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                           rng)
    tmod.load_state_dict(from_flax(variables))
    back = to_flax(tmod)
    for a, b in zip(jax.tree_util.tree_leaves(variables),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    for train in (True, False):
        ref, _ = jmod.apply(variables, jnp.asarray(x), train=train,
                            mutable=["batch_stats"])
        out = tmod(_channels_first(x), train)
        np.testing.assert_allclose(_channels_last(out), np.asarray(ref),
                                   **TOL)


@pytest.mark.parametrize("config", ["32", "test128"])
def test_default_factory_models(rng, config):
    """Generator and Discriminator without factories (TiledZ input, plain
    blocks): same outputs as the JAX models on the same weights."""
    jcfg, cfg = JAX_GAN_CONFIGS[config], GAN_CONFIGS[config]
    jg, jd = JaxGenerator(jcfg), JaxDiscriminator(jcfg)
    g, d = Generator(cfg), Discriminator(cfg)
    assert isinstance(g.input_block, blocks.TiledZGeneratorInput)
    assert isinstance(g.blocks[0], blocks.GeneratorBlock)
    assert isinstance(d.blocks[0], blocks.DiscriminatorBlock)
    z = rng.standard_normal((2, cfg.latent_dims)).astype(np.float32)
    gv = _perturbed(jg.init(jax.random.PRNGKey(0), jnp.asarray(z)), rng)
    if "blocks_4" in gv["params"]:
        gv["params"]["blocks_4"]["gamma"] = np.array(0.7, np.float32)
    g.load_state_dict(from_flax(gv))
    ref, _ = jg.apply(gv, jnp.asarray(z), train=True, mutable=["batch_stats"])
    img = g(torch.from_numpy(z), train=True)
    np.testing.assert_allclose(_channels_last(img), np.asarray(ref),
                               **MODEL_TOL)

    x = np.asarray(ref)
    dv = _perturbed(jd.init(jax.random.PRNGKey(1), jnp.asarray(x)), rng)
    d.load_state_dict(from_flax(dv))
    ref_logits, _ = jd.apply(dv, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    logits = d(_channels_first(x), train=True)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(ref_logits), **MODEL_TOL)


def test_hinge_losses(rng):
    real = rng.standard_normal((16, 1)).astype(np.float32) * 2
    fake = rng.standard_normal((16, 1)).astype(np.float32) * 2
    ref_real, ref_fake = jlosses.discriminator_hinge_loss(
        jnp.asarray(real), jnp.asarray(fake))
    got_real, got_fake = losses.discriminator_hinge_loss(
        torch.from_numpy(real), torch.from_numpy(fake))
    np.testing.assert_allclose(float(got_real), float(ref_real), **TOL)
    np.testing.assert_allclose(float(got_fake), float(ref_fake), **TOL)
    np.testing.assert_allclose(
        float(losses.generator_hinge_loss(torch.from_numpy(fake))),
        float(jlosses.generator_hinge_loss(jnp.asarray(fake))), **TOL)
    half = losses.generator_hinge_loss(torch.from_numpy(fake).bfloat16())
    assert half.dtype == torch.float32
