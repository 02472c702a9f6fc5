"""The port's layers, blocks and ``Generator`` (``tartangan_torch/models``)
against the JAX package, on weights carried over with ``convert.from_flax``.

Inputs and weight perturbations come from numpy with a seed; every module
runs with train-mode (batch-statistics) BatchNorm, as serving runs it.
Tolerances: float32 1e-5 for single ops and layers, 1e-4 for blocks and
the whole generator (summation order differs between the frameworks and
the difference grows through the tower).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tartangan_tpu.ops.pallas.attention as pallas_attn
from tartangan_tpu.configs import GAN_CONFIGS as JAX_GAN_CONFIGS
from tartangan_tpu.models import blocks as jblocks
from tartangan_tpu.models import factories as JF
from tartangan_tpu.models import layers as jlayers
from tartangan_tpu.models.pluggan import Generator as JaxGenerator
from tartangan_tpu.ops import resize as jresize
from tartangan_torch.configs import GAN_CONFIGS
from tartangan_torch.convert import from_flax, to_flax
from tartangan_torch.models import blocks, layers
from tartangan_torch.models.attention import SelfAttention2d
from tartangan_torch.models import factories as F
from tartangan_torch.models.pluggan import Generator
from tartangan_torch.ops import resize
from tartangan_torch.ops.init import init_module_


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _perturb(tree, rng, scale=0.3):
    """Add seeded noise to every leaf, so BatchNorm scale/bias and gamma
    are not at their init values."""
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + scale * rng.standard_normal(
            np.shape(a))).astype(np.float32), tree)


def _init(module, x, rng, **kw):
    variables = jax.device_get(module.init(jax.random.PRNGKey(0),
                                           jnp.asarray(x), **kw))
    return {"params": _perturb(variables["params"], rng)}


def test_resize_ops_match_jax(rng):
    x = rng.standard_normal((2, 6, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        _nhwc(resize.upsample_nearest_2x(_nchw(x))),
        np.asarray(jresize.upsample_nearest_2x(jnp.asarray(x))))
    np.testing.assert_array_equal(
        _nhwc(resize.max_pool_2x(_nchw(x))),
        np.asarray(jresize.max_pool_2x(jnp.asarray(x))))


@pytest.mark.parametrize("name", ["relu", "selu", "elu"])
def test_activations_match_jax(rng, name):
    x = rng.standard_normal((64,)).astype(np.float32) * 3
    np.testing.assert_allclose(
        layers.activation_fn(name)(torch.from_numpy(x)).numpy(),
        np.asarray(jlayers.activation_fn(name)(jnp.asarray(x))),
        rtol=1e-5, atol=1e-6)


def test_batchnorm_uses_biased_batch_variance(rng):
    x = (rng.standard_normal((3, 5, 4, 4)) * 2 + 1).astype(np.float32)
    bn = layers.BatchNorm(5)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.standard_normal(5).astype(np.float32)))
        bn.bias.copy_(torch.from_numpy(rng.standard_normal(5).astype(np.float32)))
    before = {k: v.clone() for k, v in bn.state_dict().items()}
    out = bn(torch.from_numpy(x), train=True).detach().numpy()
    mean = x.mean(axis=(0, 2, 3), keepdims=True)
    var = x.var(axis=(0, 2, 3), keepdims=True)  # ddof=0: biased
    w = bn.weight.detach().numpy()[None, :, None, None]
    b = bn.bias.detach().numpy()[None, :, None, None]
    np.testing.assert_allclose(out, (x - mean) / np.sqrt(var + 1e-5) * w + b,
                               rtol=1e-5, atol=1e-5)
    # a train-mode forward leaves the running statistics alone
    for k, v in bn.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)


@pytest.mark.parametrize("norm,activation,train", [
    ("bn", "relu", True), ("bn", "selu", True), ("id", "elu", True),
    ("bn", "relu", False),  # eval mode: the running statistics
])
def test_norm_act_matches_jax(rng, norm, activation, train):
    x = (rng.standard_normal((4, 6, 6, 8)) * 2 + 0.5).astype(np.float32)
    mod = jlayers.NormAct(norm, activation)
    variables = jax.device_get(mod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params = _perturb(variables.get("params", {}), rng)
    stats = jax.tree_util.tree_map(np.abs, _perturb(
        variables.get("batch_stats", {}), rng, scale=1.0))
    variables = {"params": params, "batch_stats": stats}
    ref, _ = mod.apply(variables, jnp.asarray(x), train=train,
                       mutable=["batch_stats"])
    ours = layers.NormAct(8, norm, activation)
    ours.load_state_dict(from_flax(variables))
    with torch.no_grad():
        out = ours(_nchw(x), train=train)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("in_dims,out_dims,first_block,upsample", [
    (8, 8, True, True),     # the tower's first block: no input norm
    (8, 6, False, True),    # width change: 1x1 projection shortcut
    (6, 6, False, False),   # a non-upsampling block within a scale
])
def test_residual_generator_block_matches_jax(rng, in_dims, out_dims,
                                              first_block, upsample):
    x = rng.standard_normal((3, 4, 4, in_dims)).astype(np.float32)
    mod = jblocks.ResidualGeneratorBlock(in_dims, out_dims, upsample=upsample,
                                         first_block=first_block)
    variables = _init(mod, x, rng, train=True)
    ref, _ = mod.apply(variables, jnp.asarray(x), train=True,
                       mutable=["batch_stats"])
    ours = blocks.ResidualGeneratorBlock(in_dims, out_dims, upsample=upsample,
                                         first_block=first_block)
    ours.load_state_dict(from_flax(variables), strict=False)
    with torch.no_grad():
        out = ours(_nchw(x), train=True)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("kind", ["mlp", "tiledz", "output"])
def test_input_and_output_blocks_match_jax(rng, kind):
    if kind == "output":
        x = rng.standard_normal((3, 8, 8, 6)).astype(np.float32)
        mod = jblocks.GeneratorOutput(6, 3)
        ours = blocks.GeneratorOutput(6, 3)
        tx = _nchw(x)
    else:
        x = rng.standard_normal((3, 12)).astype(np.float32)
        dims = 12 if kind == "tiledz" else 5
        cls = {"mlp": "GeneratorInputMLP", "tiledz": "TiledZGeneratorInput"}
        mod = getattr(jblocks, cls[kind])(12, dims, 4)
        ours = getattr(blocks, cls[kind])(12, dims, 4)
        tx = torch.from_numpy(x)
    variables = jax.device_get(mod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params = _perturb(variables.get("params", {}), rng)
    ref, _ = mod.apply({"params": params,
                        "batch_stats": variables.get("batch_stats", {})},
                       jnp.asarray(x), train=True, mutable=["batch_stats"])
    ours.load_state_dict(from_flax({"params": params}), strict=False)
    with torch.no_grad():
        out = ours(tx, train=True)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


# a narrow tower with the attention layer after block 3, at 64x64 like
# the '512thin' generator's (there at C = 64)
NARROW = dataclasses.replace(GAN_CONFIGS["512thin"], latent_dims=16,
                             blocks=(16, 16, 12, 16))
JAX_NARROW = dataclasses.replace(JAX_GAN_CONFIGS["512thin"], latent_dims=16,
                                 blocks=(16, 16, 12, 16))


def _jax_generator(cfg):
    return JaxGenerator(cfg, input_factory=JF.g_input_factory("mlp", "relu"),
                        block_factory=JF.g_block_factory("bn", "relu"),
                        output_factory=JF.g_output_factory("bn", "relu"))


def _generator(cfg):
    return Generator(cfg, input_factory=F.g_input_factory("mlp", "relu"),
                     block_factory=F.g_block_factory("bn", "relu"),
                     output_factory=F.g_output_factory("bn", "relu"))


def test_generator_matches_jax(rng, monkeypatch):
    """The whole generator, attention included (gamma != 0), with the JAX
    attention running the Pallas kernel body in interpret mode."""
    assert NARROW.max_size == 64 and NARROW.attention == (3,)
    monkeypatch.setattr(pallas_attn, "_INTERPRET", True)
    jg = _jax_generator(JAX_NARROW)
    z = rng.standard_normal((3, NARROW.latent_dims)).astype(np.float32)
    variables = jax.device_get(jg.init(jax.random.PRNGKey(0), jnp.asarray(z)))
    params = _perturb(variables["params"], rng, scale=0.05)
    params["blocks_4"]["gamma"] = np.array(0.8, np.float32)
    variables = {"params": params, "batch_stats": variables["batch_stats"]}
    ref, _ = jg.apply(variables, jnp.asarray(z), train=True,
                      mutable=["batch_stats"])

    g = _generator(NARROW)
    assert isinstance(g.blocks[4], SelfAttention2d)  # flax's blocks_4
    g.load_state_dict(from_flax(variables))
    with torch.no_grad():
        out = g(torch.from_numpy(z), train=True)
    assert out.shape == (3, 3, 64, 64)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)

    # without the attention layer's contribution the images differ
    g.blocks[4].gamma.data.zero_()
    with torch.no_grad():
        no_attn = g(torch.from_numpy(z), train=True)
    assert (no_attn - out).abs().max() > 1e-3


def test_to_flax_round_trip_and_tree_match(rng):
    """to_flax gives the JAX generator's exact tree (paths, shapes), and
    from_flax(to_flax(g)) restores every tensor bit for bit."""
    g = init_module_(_generator(NARROW), torch.Generator().manual_seed(3))
    with torch.no_grad():
        g.blocks[4].gamma.fill_(0.25)
    tree = to_flax(g)
    ref = jax.device_get(_jax_generator(JAX_NARROW).init(
        jax.random.PRNGKey(0), jnp.zeros((1, NARROW.latent_dims))))
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(dict(ref))
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(dict(ref))):
        assert np.shape(a) == np.shape(b)
    g2 = _generator(NARROW)
    g2.load_state_dict(from_flax(tree))
    for (k, v), (k2, v2) in zip(g.state_dict().items(),
                                g2.state_dict().items()):
        assert k == k2
        torch.testing.assert_close(v, v2, rtol=0, atol=0)


def test_init_is_torch_default_from_generator():
    """Seeded init is reproducible and within torch's default bounds."""
    a = init_module_(_generator(NARROW), torch.Generator().manual_seed(1))
    b = init_module_(_generator(NARROW), torch.Generator().manual_seed(1))
    for (k, v), (_, w) in zip(a.state_dict().items(), b.state_dict().items()):
        torch.testing.assert_close(v, w, rtol=0, atol=0)
    conv = a.blocks[1].Conv_0.requires_grad_(False)
    bound = 1.0 / np.sqrt(conv.weight[0].numel())
    assert float(conv.weight.abs().max()) <= bound
    assert float(conv.bias.abs().max()) <= bound
    assert a.blocks[4].gamma.item() == 0.0
