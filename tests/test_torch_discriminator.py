"""The port's discriminator side, BatchNorm's running-statistics update and
Adam (``tartangan_torch/models``, ``train/common.py``, ``convert.py``)
against the JAX package, on weights carried over with ``convert.from_flax``.

Inputs and weight perturbations come from numpy with a seed. Tolerances:
float32 1e-5 for single ops, layers and optimizer updates, 1e-4 for blocks
and the whole discriminator (summation order differs between the
frameworks and the difference grows through the tower).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

import tartangan_tpu.ops.pallas.attention as pallas_attn
from tartangan_tpu.configs import GAN_CONFIGS as JAX_GAN_CONFIGS
from tartangan_tpu.models import blocks as jblocks
from tartangan_tpu.models import factories as JF
from tartangan_tpu.models.pluggan import Discriminator as JaxDiscriminator
from tartangan_tpu.ops import resize as jresize
from tartangan_torch.configs import GAN_CONFIGS
from tartangan_torch.convert import (
    adam_from_flax,
    adam_to_flax,
    from_flax,
    to_flax,
)
from tartangan_torch.models import blocks, layers
from tartangan_torch.models import factories as F
from tartangan_torch.models.attention import SelfAttention2d
from tartangan_torch.models.layers import update_batch_stats
from tartangan_torch.models.pluggan import Discriminator
from tartangan_torch.ops import resize
from tartangan_torch.ops.init import init_module_
from tartangan_torch.train.common import make_adam
from tartangan_torch.utils import msgpack


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


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


@pytest.mark.parametrize("hw", [(8, 8), (7, 10), (2, 5)])
def test_d_resize_ops_match_jax(rng, hw):
    """2x2 average pool and the bilinear half-size shortcut
    (align_corners) at even and odd sizes."""
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    np.testing.assert_allclose(
        _nhwc(resize.downsample_bilinear_half(_nchw(x))),
        np.asarray(jresize.downsample_bilinear_half(jnp.asarray(x))),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        _nhwc(resize.avg_pool_2x(_nchw(x))),
        np.asarray(jresize.avg_pool_2x(jnp.asarray(x))),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind,in_dims,out_dims,first_block", [
    ("input", 3, 8, False),
    ("block", 8, 8, True),      # the tower's first block: no input norm
    ("block", 8, 12, False),    # width change: 1x1 projection shortcut
    ("block", 12, 12, False),
    ("output", 12, 1, False),
])
def test_d_blocks_match_jax(rng, kind, in_dims, out_dims, first_block):
    x = rng.standard_normal((3, 8, 8, in_dims)).astype(np.float32)
    if kind == "input":
        mod = jblocks.DiscriminatorInput(in_dims, out_dims)
        ours = blocks.DiscriminatorInput(in_dims, out_dims)
    elif kind == "block":
        mod = jblocks.ResidualDiscriminatorBlock(in_dims, out_dims,
                                                 first_block=first_block)
        ours = blocks.ResidualDiscriminatorBlock(in_dims, out_dims,
                                                 first_block=first_block)
    else:
        mod = jblocks.DiscriminatorOutput(in_dims, out_dims)
        ours = blocks.DiscriminatorOutput(in_dims, out_dims)
    variables = jax.device_get(mod.init(jax.random.PRNGKey(0),
                                        jnp.asarray(x), train=True))
    variables = {"params": _perturb(variables["params"], rng),
                 "batch_stats": variables.get("batch_stats", {})}
    ref, _ = mod.apply(variables, jnp.asarray(x), train=True,
                       mutable=["batch_stats"])
    ours.load_state_dict(from_flax(variables))
    with torch.no_grad():
        out = ours(_nchw(x), train=True)
    out = out.numpy() if kind == "output" else _nhwc(out)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-4, atol=1e-4)


# the 16 px attention config of test_r1_double_grad_through_pallas_attention
JCFG = dataclasses.replace(JAX_GAN_CONFIGS["16"], blocks=(16, 8),
                           attention=(1,))
CFG = dataclasses.replace(GAN_CONFIGS["16"], blocks=(16, 8), attention=(1,))


def _jax_d(use_pallas=True):
    return JaxDiscriminator(JCFG,
                            block_factory=JF.d_block_factory("bn", "relu"),
                            output_factory=JF.d_output_factory("bn", "relu"),
                            attn_use_pallas=use_pallas)


def _d(cfg=CFG):
    return Discriminator(cfg, input_factory=F.d_input_factory(),
                         block_factory=F.d_block_factory("bn", "relu"),
                         output_factory=F.d_output_factory("bn", "relu"))


def _d_variables(rng, x):
    variables = jax.device_get(_jax_d().init(jax.random.PRNGKey(0),
                                             jnp.asarray(x), train=True))
    params = _perturb(variables["params"], rng, scale=0.05)
    params["blocks_1"]["gamma"] = np.array(-0.8, np.float32)
    stats = jax.tree_util.tree_map(np.abs, _perturb(
        variables["batch_stats"], rng, scale=1.0))
    return {"params": params, "batch_stats": stats}


def test_discriminator_matches_jax_and_updates_stats_as_flax(rng,
                                                             monkeypatch):
    """The whole D with attention (the Pallas kernel in interpret mode on
    the JAX side), its logits and, with ``update_batch_stats``, its new
    running statistics against flax's ``batch_stats`` after one train-mode
    forward; without it the statistics stay."""
    monkeypatch.setattr(pallas_attn, "_INTERPRET", True)
    x = rng.standard_normal((3, 16, 16, 3)).astype(np.float32)
    variables = _d_variables(rng, x)
    ref, updates = _jax_d().apply(variables, jnp.asarray(x), train=True,
                                  mutable=["batch_stats"])
    d = _d()
    assert isinstance(d.blocks[1], SelfAttention2d)  # flax's blocks_1
    d.load_state_dict(from_flax(variables))
    with torch.no_grad():
        out = d(_nchw(x), train=True)
    for a, b in _leaves(to_flax(d)["batch_stats"], variables["batch_stats"]):
        np.testing.assert_array_equal(a, b)
    with torch.no_grad(), update_batch_stats(d):
        out2 = d(_nchw(x), train=True)
    assert out.shape == (3, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(out, out2, rtol=0, atol=0)
    for a, b in _leaves(to_flax(d)["batch_stats"],
                        jax.device_get(updates["batch_stats"])):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    assert not any(m.update_stats for m in d.modules()
                   if isinstance(m, layers.BatchNorm))


def test_d_to_flax_round_trip_and_tree_match():
    d = init_module_(_d(), torch.Generator().manual_seed(3))
    tree = to_flax(d)
    ref = jax.device_get(_jax_d().init(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 16, 16, 3))))
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(dict(ref))
    for a, b in _leaves(tree, dict(ref)):
        assert np.shape(a) == np.shape(b)
    d2 = _d()
    d2.load_state_dict(from_flax(tree))
    for (k, v), (k2, v2) in zip(d.state_dict().items(),
                                d2.state_dict().items()):
        assert k == k2
        torch.testing.assert_close(v, v2, rtol=0, atol=0)


def test_512thin_discriminator_layout():
    """D's attention sits at blocks_4, at 32x32 with C = 64 (Ck 8, Cv 32)."""
    d = _d(GAN_CONFIGS["512thin"])
    assert isinstance(d.blocks[4], SelfAttention2d)
    assert d.blocks[4].theta.out_channels == 8
    assert d.blocks[4].g.out_channels == 32
    assert len(d.blocks) == 8


def test_parity_blocks_resolve_off():
    """'auto' is off, the JAX package's rule off a TPU; 'on' gives the
    parity block forms."""
    assert F.resolve_parity("auto") is False
    assert F.resolve_parity("off") is False
    assert F.resolve_parity("on") is True
    with pytest.raises(ValueError):
        F.resolve_parity("sometimes")


@pytest.mark.parametrize("steps", [1, 2])
def test_make_adam_matches_optax(rng, steps):
    """make_adam on the same gradients as ``optax.adam(b1=0, b2=0.999,
    eps=1e-8)``: parameters and state after each step, and the state
    carried through convert.py both ways."""
    d = init_module_(_d(), torch.Generator().manual_seed(4))
    params = to_flax(d)["params"]
    opt = make_adam(d.parameters(), 4e-4)
    jopt = optax.adam(4e-4, b1=0.0, b2=0.999, eps=1e-8)
    jstate = jopt.init(params)
    for _ in range(steps):
        grads = _perturb(jax.tree_util.tree_map(np.zeros_like, params), rng,
                         scale=1.0)
        tgrads = from_flax({"params": grads})
        for name, p in d.named_parameters():
            p.grad = tgrads[name].clone()
        opt.step()
        updates, jstate = jopt.update(grads, jstate, params)
        params = jax.device_get(optax.apply_updates(params, updates))
    for a, b in _leaves(to_flax(d)["params"], params):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    tree = adam_to_flax(d, opt)
    jtree = serialization.to_state_dict(jstate)
    assert int(tree["0"]["count"]) == steps
    for a, b in _leaves(tree, jax.device_get(jtree)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-9)
    # through the msgpack files: flax restores the port's bytes into the
    # optax state, and the port restores flax's bytes into a new Adam
    back = serialization.from_bytes(jstate, msgpack.dumps(tree))
    for a, b in _leaves(back, jstate):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-9)
    opt2 = make_adam(d.parameters(), 4e-4)
    adam_from_flax(d, opt2, msgpack.loads(serialization.to_bytes(jstate)))
    for p in d.parameters():
        for key in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(opt2.state[p][key], opt.state[p][key],
                                       rtol=1e-5, atol=1e-9)
        assert int(opt2.state[p]["step"]) == steps


def test_adam_state_before_any_step_is_optax_init():
    d = init_module_(_d(), torch.Generator().manual_seed(5))
    tree = adam_to_flax(d, make_adam(d.parameters(), 1e-4))
    ref = serialization.to_state_dict(optax.adam(1e-4).init(
        to_flax(d)["params"]))
    for a, b in _leaves(tree, jax.device_get(ref)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_r1_gradient_through_the_attention_functions_matches_jax(
        rng, monkeypatch):
    """The R1 penalty's gradient w.r.t. D's parameters, as
    tests/test_attention.py::test_r1_double_grad_through_pallas_attention
    takes it (JAX: K1, K2 and the nested rule in interpret mode; the port:
    the two autograd Functions), compared after dividing by the max-abs
    over the whole gradient (conv biases before a train-mode BatchNorm have
    a gradient of 0 up to rounding)."""
    from tartangan_torch.models.losses import r1_gradient_penalty
    monkeypatch.setattr(pallas_attn, "_INTERPRET", True)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    variables = _d_variables(rng, x)
    jd = _jax_d()

    def r1(params):
        def d_sum(x):
            out, _ = jd.apply({"params": params,
                               "batch_stats": variables["batch_stats"]},
                              x, train=True, mutable=["batch_stats"])
            return jnp.sum(out.astype(jnp.float32))
        gx = jax.grad(d_sum)(x)
        return jnp.mean(jnp.sum(jnp.square(gx).reshape(2, -1), axis=1))

    ref = jax.device_get(jax.jit(jax.grad(r1))(variables["params"]))

    d = _d()
    d.load_state_dict(from_flax(variables))
    gp, _ = r1_gradient_penalty(d, _nchw(x).requires_grad_())
    gp.backward()
    grads = _d()
    with torch.no_grad():
        for (name, p), (_, q) in zip(grads.named_parameters(),
                                     d.named_parameters()):
            p.copy_(q.grad if q.grad is not None else torch.zeros_like(q))
    ours = to_flax(grads)["params"]
    pairs = list(_leaves(ours, ref))
    scale = max(float(np.abs(b).max()) for _, b in pairs)
    assert np.abs(ref["blocks_1"]["theta"]["kernel"]).max() > 1e-3 * scale
    for a, b in pairs:
        np.testing.assert_allclose(a / scale, np.asarray(b) / scale, rtol=0,
                                   atol=1e-4)
