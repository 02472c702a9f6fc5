"""The port's G and D towers with parity blocks (the output fusion, the
input fusion and the chained seams of ``tartangan_torch/models/pluggan.py``)
and the factories' routing, against the JAX package on weights carried over
with ``convert.from_flax``; the blocks themselves are held in
``tests/test_torch_parity_blocks.py``.

Inputs and weight perturbations come from numpy with a seed. Tolerances
(float32): outputs and statistics 1e-4 (summation order differs between the
frameworks and grows through a tower); gradients 1e-4 of the max-abs over
the whole gradient (a conv bias before a train-mode BatchNorm has a gradient
of 0 up to rounding, so a leaf's own max-abs is no scale); R1 double
gradients 1e-3 of it (a second order through BatchNorm's statistics).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tartangan_tpu.configs import GAN_CONFIGS as JAX_GAN_CONFIGS
from tartangan_tpu.models import factories as JF
from tartangan_tpu.models.pluggan import Discriminator as JaxDiscriminator
from tartangan_tpu.models.pluggan import Generator as JaxGenerator
from tartangan_torch.configs import GAN_CONFIGS
from tartangan_torch.convert import _to_tree, from_flax, to_flax
from tartangan_torch.models import blocks
from tartangan_torch.models import factories as F
from tartangan_torch.models.layers import update_batch_stats
from tartangan_torch.models.losses import r1_gradient_penalty
from tartangan_torch.models.pluggan import Discriminator, Generator



def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _perturb(tree, rng, scale=0.3):
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + scale * rng.standard_normal(
            np.shape(a))).astype(np.float32), tree)


def _leaves(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    return zip(la, lb)


def _variables(mod, x, rng):
    v = jax.device_get(mod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                train=True))
    # running variances kept off 0, where eval mode's 1/sqrt(var + eps)
    # would turn rounding into visible differences
    stats = jax.tree_util.tree_map(
        lambda a: 0.2 + np.abs(a), _perturb(v.get("batch_stats", {}), rng,
                                            0.5))
    return {"params": _perturb(v["params"], rng), "batch_stats": stats}


def _grad_tree(module):
    return _to_tree((n, p.grad if p.grad is not None else torch.zeros_like(p))
                    for n, p in module.named_parameters())["params"]


def _assert_scaled(ours, ref, atol):
    pairs = [(np.asarray(a, np.float64), np.asarray(b, np.float64))
             for a, b in _leaves(ours, ref)]
    scale = max(float(np.abs(b).max()) for _, b in pairs)
    for a, b in pairs:
        np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=atol)


# ------------------------------------------------------- G and D towers
JCFG = dataclasses.replace(JAX_GAN_CONFIGS["16"], blocks=(80, 16, 8))
CFG = dataclasses.replace(GAN_CONFIGS["16"], blocks=(80, 16, 8))


def test_parity_generator_matches_jax(rng):
    """The G tower with parity blocks and the output fusion: forward,
    statistics, gradients, and eval mode on the running statistics."""
    jg = JaxGenerator(JCFG, input_factory=JF.g_input_factory("mlp", "relu"),
                      block_factory=JF.g_block_factory("bn", "relu",
                                                       parity=True),
                      output_factory=JF.g_output_factory("bn", "relu"))
    g = Generator(CFG, input_factory=F.g_input_factory("mlp", "relu"),
                  block_factory=F.g_block_factory("bn", "relu", parity=True),
                  output_factory=F.g_output_factory("bn", "relu"))
    assert [type(b).__name__ for b in g.blocks] == [
        "ResidualGeneratorBlock", "ParityResidualGeneratorBlock",
        "ParityResidualGeneratorBlock"]
    assert isinstance(g.output_block, blocks.ParityGeneratorOutput)
    assert g.blocks[-1].emit_parity and not g.blocks[1].emit_parity
    z = rng.standard_normal((4, JCFG.latent_dims)).astype(np.float32)
    variables = _variables(jg, z, rng)
    ref, upd = jg.apply(variables, jnp.asarray(z), train=True,
                        mutable=["batch_stats"])
    g.load_state_dict(from_flax(variables))
    with update_batch_stats(g):
        out = g(torch.from_numpy(z), train=True)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    for a, b in _leaves(to_flax(g)["batch_stats"],
                        jax.device_get(upd["batch_stats"])):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)

    g.load_state_dict(from_flax(variables))
    g(torch.from_numpy(z), train=True).square().sum().backward()

    def loss(params):
        o, _ = jg.apply({"params": params,
                         "batch_stats": variables["batch_stats"]},
                        jnp.asarray(z), train=True, mutable=["batch_stats"])
        return jnp.sum(jnp.square(o))

    _assert_scaled(_grad_tree(g),
                   jax.device_get(jax.jit(jax.grad(loss))(
                       variables["params"])), 1e-4)
    # eval mode on the running statistics, with the init's weights (the
    # perturbed ones above, unnormalized by batch statistics, blow the
    # activations up until rounding shows through tanh)
    init = jax.device_get(jg.init(jax.random.PRNGKey(1), jnp.asarray(z),
                                  train=True))
    g.load_state_dict(from_flax(init))
    with torch.no_grad():
        out_e = g(torch.from_numpy(z), train=False)
    np.testing.assert_allclose(
        _nhwc(out_e), np.asarray(jg.apply(init, jnp.asarray(z), train=False)),
        rtol=1e-4, atol=1e-4)


def test_parity_discriminator_matches_jax(rng):
    """The D tower with the input fusion and a chained seam: forward,
    statistics and the R1 double gradient plus the logits' own gradient
    (``tests/test_parity_blocks.py:562``)."""
    jd = JaxDiscriminator(JCFG, block_factory=JF.d_block_factory(
        "bn", "relu", parity=True),
        output_factory=JF.d_output_factory("bn", "relu"))
    d = Discriminator(CFG, input_factory=F.d_input_factory(),
                      block_factory=F.d_block_factory("bn", "relu",
                                                      parity=True),
                      output_factory=F.d_output_factory("bn", "relu"))
    assert isinstance(d.input_block, blocks.ParityDiscriminatorInput)
    assert [(b.accept_parity, b.emit_parity) for b in d.blocks[:2]] == [
        (True, True), (True, False)]
    assert type(d.blocks[2]).__name__ == "ResidualDiscriminatorBlock"
    x = rng.standard_normal((3, 16, 16, 3)).astype(np.float32)
    variables = _variables(jd, x, rng)
    ref, upd = jd.apply(variables, jnp.asarray(x), train=True,
                        mutable=["batch_stats"])
    d.load_state_dict(from_flax(variables))
    with update_batch_stats(d):
        out = d(_nchw(x), train=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)
    for a, b in _leaves(to_flax(d)["batch_stats"],
                        jax.device_get(upd["batch_stats"])):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)

    def r1_loss(params):
        def d_sum(xx):
            o, _ = jd.apply({"params": params,
                             "batch_stats": variables["batch_stats"]},
                            xx, train=True, mutable=["batch_stats"])
            return jnp.sum(o)
        gx = jax.grad(d_sum)(jnp.asarray(x))
        o, _ = jd.apply({"params": params,
                         "batch_stats": variables["batch_stats"]},
                        jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.mean(jnp.sum(jnp.square(gx).reshape(3, -1), axis=1)) \
            + jnp.sum(jnp.square(o))

    ref_g = jax.device_get(jax.jit(jax.grad(r1_loss))(variables["params"]))
    d.load_state_dict(from_flax(variables))
    gp, p_real = r1_gradient_penalty(d, _nchw(x).requires_grad_())
    (gp + p_real.square().sum()).backward()
    _assert_scaled(_grad_tree(d), ref_g, 1e-3)


# ------------------------------------------------------------- routing
def test_factories_route_parity_and_fused_blocks():
    """The reference's routing (``factories.py:88-164``, tested at
    ``tests/test_parity_blocks.py:369`` and ``test_fused_gblock.py:219``):
    parity first for out_dims <= 64, then fused, else plain."""
    gf = F.g_block_factory("bn", "relu", parity=True, fused=True)
    assert isinstance(gf(128, 64), blocks.ParityResidualGeneratorBlock)
    assert isinstance(gf(128, 128), blocks.FusedResidualGeneratorBlock)
    assert isinstance(gf(128, 64, first_block=True),
                      blocks.ResidualGeneratorBlock)
    assert isinstance(gf(64, 64, upsample=False),
                      blocks.ResidualGeneratorBlock)
    assert isinstance(F.g_block_factory("bn", "relu", parity=True)(256, 128),
                      blocks.ResidualGeneratorBlock)
    assert isinstance(F.g_block_factory("id", "relu", fused=True)(24, 16),
                      blocks.ResidualGeneratorBlock)
    assert isinstance(F.g_block_factory("bn", "elu", fused=True)(24, 16),
                      blocks.ResidualGeneratorBlock)
    df = F.d_block_factory("bn", "relu", parity=True)
    assert isinstance(df(16, 32), blocks.ParityResidualDiscriminatorBlock)
    assert isinstance(df(64, 128), blocks.ResidualDiscriminatorBlock)
    assert isinstance(F.d_block_factory("bn", "relu")(16, 32),
                      blocks.ResidualDiscriminatorBlock)


def test_512thin_parity_layout():
    """'512thin' with parity and fused forms: G [Residual, Fused x2,
    Parity, attention, Parity x3], D [Parity x4, attention, Residual x3],
    as the JAX factories build it."""
    cfg = GAN_CONFIGS["512thin"]
    g = Generator(cfg, input_factory=F.g_input_factory("mlp", "relu"),
                  block_factory=F.g_block_factory("bn", "relu", parity=True,
                                                  fused=True),
                  output_factory=F.g_output_factory("bn", "relu"))
    assert [type(b).__name__ for b in g.blocks] == [
        "ResidualGeneratorBlock", "FusedResidualGeneratorBlock",
        "FusedResidualGeneratorBlock", "ParityResidualGeneratorBlock",
        "SelfAttention2d", "ParityResidualGeneratorBlock",
        "ParityResidualGeneratorBlock", "ParityResidualGeneratorBlock"]
    d = Discriminator(cfg, input_factory=F.d_input_factory(),
                      block_factory=F.d_block_factory("bn", "relu",
                                                      parity=True),
                      output_factory=F.d_output_factory("bn", "relu"))
    assert [type(b).__name__ for b in d.blocks] == \
        ["ParityResidualDiscriminatorBlock"] * 4 + ["SelfAttention2d"] + \
        ["ResidualDiscriminatorBlock"] * 3
    assert [(b.accept_parity, b.emit_parity) for b in d.blocks[:4]] == [
        (True, True), (True, True), (True, True), (True, False)]
