"""The plain versions of the port's K4 and K5 (``ops/gblock.py``), the
``fused_gblock`` Function and ``FusedResidualGeneratorBlock`` against the
JAX package: ``_fused_gblock_fwd_impl(..., interpret=True)`` and the fused
block as ``tests/test_fused_gblock.py`` runs them; and ``convert.py`` on a
fused generator's tree and Adam state. K3: ``test_torch_parity_kernels.py``.

On the CPU the wrappers run the plain versions, so this holds the function
each kernel must compute and the wiring around it; the kernels themselves
are held to the plain versions on the card (``chip_smoke.py``,
``tests/test_torch_kernels_cuda.py``). Tolerances (float32): forward values
1e-5 relative with 1e-5 absolute for one conv, 1e-4 for the whole block
(two convs and two BatchNorms); gradients 1e-4 of the max-abs over the
whole gradient (conv1's bias before a train-mode BatchNorm has a gradient
of 0 up to rounding); the statistics 1e-5.
"""
import torch_threads  # noqa: F401  (this process's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from tartangan_tpu.configs import GAN_CONFIGS as JAX_GAN_CONFIGS
from tartangan_tpu.models import blocks as jblocks
from tartangan_tpu.models import factories as JF
from tartangan_tpu.models.pluggan import Generator as JaxGenerator
from tartangan_tpu.ops.pallas import gblock as JG
from tartangan_torch.configs import GAN_CONFIGS
from tartangan_torch.convert import (
    adam_from_flax,
    adam_to_flax,
    from_flax,
    to_flax,
)
from tartangan_torch.models import blocks
from tartangan_torch.models import factories as F
from tartangan_torch.models.layers import update_batch_stats
from tartangan_torch.models.pluggan import Generator
from tartangan_torch.ops import gblock as G
from tartangan_torch.ops.parity import depth_to_space
from tartangan_torch.train.common import make_adam


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _leaves(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    return zip(la, lb)


# ------------------------------------------------------------- K4 / K5
def _gblock_params(rng, cin, cout):
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    p = {"w1": 0.1 * r(3, 3, cin, cout), "b1": r(cout),
         "w2": 0.1 * r(3, 3, cout, cout), "b2": r(cout),
         "s1": 1 + 0.2 * r(cin), "o1": 0.2 * r(cin),
         "s2": 1 + 0.2 * r(cout), "o2": 0.2 * r(cout)}
    if cin == cout:
        p["wp"], p["bp"] = np.eye(cin, dtype=np.float32), np.zeros(
            cout, np.float32)
    else:
        p["wp"], p["bp"] = 0.1 * r(cin, cout), r(cout)
    return p


def _port_params(p):
    """The port's parameters: OIHW convs, and the identity shortcut (the
    JAX side's ``jnp.eye`` projection) as ``wp = bp = None``, as
    ``FusedResidualGeneratorBlock._params`` passes it."""
    q = {k: _oihw(v) if k in ("w1", "w2") else _t(v) for k, v in p.items()}
    if p["w1"].shape[2] == p["w1"].shape[3]:
        q["wp"] = q["bp"] = None
    return q


@pytest.mark.parametrize("cin,cout", [(12, 8), (8, 8)])
def test_k4_k5_plain_match_jax_interpret(rng, cin, cout):
    """y1p, the four statistics and the output, projected and identity
    shortcuts."""
    x = rng.standard_normal((3, 6, 6, cin)).astype(np.float32)
    p = _gblock_params(rng, cin, cout)
    out_ref, y1_ref, stats_ref = JG._fused_gblock_fwd_impl(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
        interpret=True)
    q = _port_params(p)
    xt = _t(x)
    m1, v1 = G._moments(xt)
    y1p, sums = G.gblock_a(xt, m1, v1, q["s1"], q["o1"], q["w1"], q["b1"])
    np.testing.assert_allclose(y1p.numpy(), np.asarray(y1_ref), rtol=1e-5,
                               atol=1e-5)
    n = 4 * 3 * 6 * 6
    s4 = sums.reshape(2, 4, cout).sum(1)
    m2, v2 = s4[0] / n, s4[1] / n - (s4[0] / n).square()
    for a, r in zip((m1, v1, m2, v2), stats_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)
    out_p = G.gblock_b(y1p, xt, m2, v2, q["s2"], q["o2"], q["w2"], q["b2"],
                       q["wp"], q["bp"])
    out_full = depth_to_space(out_p.permute(0, 3, 1, 2), cout) \
        .permute(0, 2, 3, 1)
    np.testing.assert_allclose(out_full.numpy(), np.asarray(out_ref),
                               rtol=1e-4, atol=1e-4)
    out, stats = G.fused_gblock(xt, q)
    torch.testing.assert_close(out, out_full)
    ref_out, _ = G._gblock_reference(xt, q)
    torch.testing.assert_close(out, ref_out, rtol=1e-4, atol=1e-4)


def _gradients_against_jax(rng, use_kernel, cin, cout):
    x = rng.standard_normal((2, 4, 4, cin)).astype(np.float32)
    p = _gblock_params(rng, cin, cout)
    cot = rng.standard_normal((2, 8, 8, cout)).astype(np.float32)

    def jloss(xx, pp):
        return jnp.sum(JG.fused_gblock(xx, pp)[0] * cot)

    gx, gp = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    q = _port_params(p)
    names = [k for k in G.PARAMS if q[k] is not None]
    for k in names:
        q[k].requires_grad_()
    xt = _t(x).requires_grad_()
    (G.fused_gblock(xt, q, use_kernel=use_kernel)[0] * _t(cot)).sum() \
        .backward()
    ref = [np.asarray(gx)] + [np.asarray(gp[k]) for k in names]
    ours = [xt.grad.numpy()] + [
        q[k].grad.numpy().transpose(2, 3, 1, 0) if k in ("w1", "w2")
        else q[k].grad.numpy() for k in names]
    scale = max(np.abs(r).max() for r in ref)
    for name, a, r in zip(["x"] + names, ours, ref):
        np.testing.assert_allclose(a / scale, r / scale, rtol=0, atol=1e-4,
                                   err_msg=name)
    return names


@pytest.mark.parametrize("use_kernel", [True, False])
def test_fused_gblock_identity_gradients_match_jax(rng, use_kernel):
    """The identity shortcut (``wp = bp = None``, closed over by the
    Function's backward) against JAX's ``jnp.eye`` projection: every
    gradient but the projection's, which the port has no parameter for."""
    assert "wp" not in _gradients_against_jax(rng, use_kernel, 8, 8)


def test_identity_shortcut_is_x(rng):
    """``wp = bp = None`` gives what the I-projection gave, in
    ``gblock_b_plain`` and ``_gblock_reference``; one of the two alone is
    refused."""
    x = _t(rng.standard_normal((2, 5, 3, 8)).astype(np.float32))
    q = _port_params(_gblock_params(rng, 8, 8))
    eye = dict(q, wp=torch.eye(8), bp=torch.zeros(8))
    y1p = _t(rng.standard_normal((2, 5, 3, 32)).astype(np.float32))
    stats = (torch.rand(8), 1 + torch.rand(8))
    args = (q["s2"], q["o2"], q["w2"], q["b2"])
    torch.testing.assert_close(
        G.gblock_b(y1p, x, *stats, *args, None, None),
        G.gblock_b_plain(y1p, x, *stats, *args, eye["wp"], eye["bp"]))
    torch.testing.assert_close(G._gblock_reference(x, q)[0],
                               G._gblock_reference(x, eye)[0])
    with pytest.raises(ValueError, match="both"):
        G.gblock_b(y1p, x, *stats, *args, None, eye["bp"])
    with pytest.raises(ValueError, match="fit"):
        G.gblock_b(y1p, torch.zeros(2, 5, 3, 4), *stats, *args, None, None)


@pytest.mark.parametrize("cin,cout", [(12, 8), (8, 8), (8, 16)])
def test_params_identity_exactly_when_widths_match(cin, cout):
    p = blocks.FusedResidualGeneratorBlock(cin, cout)._params()
    assert (p["wp"] is None) == (cin == cout)
    assert (p["bp"] is None) == (cin == cout)
    if cin != cout:
        assert p["wp"].shape == (cin, cout) and p["bp"].shape == (cout,)


@pytest.mark.parametrize("shape,rows,floats", [
    # (b, h, w, cin, cout): K4's partial rows, K4 / K5 scratch
    ((64, 8, 8, 128, 128), 64, (590208, 295296)),
    ((64, 16, 16, 128, 128), 256, (786816, 295296)),
    ((3, 9, 19, 5, 7), 18, (17416, 9240)),
    ((1, 17, 10, 12, 200), 6, (140720, 922200)),
])
def test_workspace_of_the_tiling(shape, rows, floats):
    """The mirror of the kernels' tiling: one partial row per 8 x 8 tile;
    the scratch as packed weights (hi, lo: 16 or 9 blocks x 64 channels x
    8, per channel slice and 8-channel chunk), 3 bn vectors padded to 8
    and K4's (rows, 2, 4*Cout) sums."""
    b, h, w, cin, cout = shape
    assert G.partial_rows(b, h, w) == rows == b * -(-h // 8) * -(-w // 8)
    for full, want in zip((False, True), floats):
        nch = -(-(cout if full else cin) // 8)
        packed = (9 if full else 16) * 64 * 8 * nch * -(-cout // 64)
        assert want == 2 * packed + 24 * nch + (0 if full else
                                                rows * 8 * cout)
        assert G.workspace_floats(full, *shape) == want


@pytest.mark.parametrize("use_kernel", [True, False])
def test_fused_gblock_gradients_match_jax(rng, use_kernel):
    """The Function's recomputed backward (and, with ``use_kernel=False``,
    autograd through the plain K4/K5) against JAX's ``fused_gblock``."""
    x = rng.standard_normal((2, 4, 4, 12)).astype(np.float32)
    p = _gblock_params(rng, 12, 8)
    cot = rng.standard_normal((2, 8, 8, 8)).astype(np.float32)
    names = ["x"] + list(G.PARAMS)

    def jloss(xx, pp):
        return jnp.sum(JG.fused_gblock(xx, pp)[0] * cot)

    gx, gp = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    ref = [np.asarray(gx)] + [np.asarray(gp[k]) for k in G.PARAMS]
    q = {k: v.requires_grad_() for k, v in _port_params(p).items()}
    xt = _t(x).requires_grad_()
    (G.fused_gblock(xt, q, use_kernel=use_kernel)[0] * _t(cot)).sum() \
        .backward()
    ours = [xt.grad.numpy()] + [
        q[k].grad.numpy().transpose(2, 3, 1, 0) if k in ("w1", "w2")
        else q[k].grad.numpy() for k in G.PARAMS]
    scale = max(np.abs(r).max() for r in ref)
    for name, a, r in zip(names, ours, ref):
        np.testing.assert_allclose(a / scale, r / scale, rtol=0, atol=1e-4,
                                   err_msg=name)


def flax_to_fused_params(flax_params, cin, cout):
    """A flax ResidualGeneratorBlock tree -> the fused block's flat tree
    (``tests/test_fused_gblock.py:21-43``)."""
    def bn(tree):
        while "scale" not in tree:
            tree = tree[next(iter(tree))]
        return tree["scale"], tree["bias"]

    s1, o1 = bn(flax_params["NormAct_0"])
    s2, o2 = bn(flax_params["NormAct_1"])
    out = {"conv1_kernel": flax_params["Conv_0"]["kernel"],
           "conv1_bias": flax_params["Conv_0"]["bias"],
           "conv2_kernel": flax_params["Conv_1"]["kernel"],
           "conv2_bias": flax_params["Conv_1"]["bias"],
           "bn1_scale": s1, "bn1_bias": o1, "bn2_scale": s2, "bn2_bias": o2}
    if cin != cout:
        out["project_kernel"] = flax_params["project_input"]["kernel"]
        out["project_bias"] = flax_params["project_input"]["bias"]
    return out


@pytest.mark.parametrize("cin,cout", [(12, 8), (8, 8)])
def test_fused_block_matches_jax_train_and_eval(rng, cin, cout):
    """``FusedResidualGeneratorBlock`` against the JAX one on the same
    weights: the train-mode forward, the running statistics after it
    (momentum 0.9), and eval mode on those statistics; then against the
    plain ``ResidualGeneratorBlock`` on the plain tree."""
    x = rng.standard_normal((3, 6, 6, cin)).astype(np.float32)
    flax_vars = jblocks.ResidualGeneratorBlock(cin, cout).init(
        jax.random.PRNGKey(0), jnp.asarray(x), train=True)
    flax_vars = jax.device_get(flax_vars)
    params = jax.tree_util.tree_map(
        lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        flax_vars["params"])
    jmod = jblocks.FusedResidualGeneratorBlock(cin, cout)
    fused = {"params": flax_to_fused_params(params, cin, cout),
             "batch_stats": jax.device_get(jmod.init(
                 jax.random.PRNGKey(1), jnp.asarray(x),
                 train=True))["batch_stats"]}
    ref, upd = jmod.apply(fused, jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
    ours = blocks.FusedResidualGeneratorBlock(cin, cout)
    ours.load_state_dict(from_flax(fused))
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    with torch.no_grad():
        out_nostats = ours(xt, train=True)
        assert float(ours.bn1_mean.abs().max()) == 0  # not updated
        with update_batch_stats(ours):
            out = ours(xt, train=True)
    torch.testing.assert_close(out, out_nostats)
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 1),
                               np.asarray(ref), rtol=1e-4, atol=1e-4)
    tree = to_flax(ours)
    for a, b in _leaves(tree["batch_stats"],
                        jax.device_get(upd["batch_stats"])):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    ref_eval = jmod.apply({"params": fused["params"], **upd}, jnp.asarray(x),
                          train=False)
    with torch.no_grad():
        out_eval = ours(xt, train=False)
    np.testing.assert_allclose(out_eval.numpy().transpose(0, 2, 3, 1),
                               np.asarray(ref_eval), rtol=1e-4, atol=1e-4)
    plain = blocks.ResidualGeneratorBlock(cin, cout)
    plain.load_state_dict(from_flax({"params": params,
                                     "batch_stats": flax_vars["batch_stats"]}))
    with torch.no_grad():
        torch.testing.assert_close(plain(xt, train=True), out, rtol=1e-4,
                                   atol=1e-4)


# --------------------------------------------------------------- convert
def test_fused_generator_tree_and_adam_round_trip(rng):
    """A JAX fused-and-parity G's variables and its optax Adam state,
    through ``from_flax``/``to_flax`` and ``adam_from_flax``/
    ``adam_to_flax``, unchanged; the trees match leaf for leaf in
    structure and shape."""
    import dataclasses
    jcfg = dataclasses.replace(JAX_GAN_CONFIGS["16"], blocks=(80, 80, 16, 8),
                               base_size=2)
    cfg = dataclasses.replace(GAN_CONFIGS["16"], blocks=(80, 80, 16, 8),
                              base_size=2)
    jg = JaxGenerator(jcfg, input_factory=JF.g_input_factory("mlp", "relu"),
                      block_factory=JF.g_block_factory(
                          "bn", "relu", parity=True, fused=True),
                      output_factory=JF.g_output_factory("bn", "relu"))
    v = jax.device_get(jg.init(jax.random.PRNGKey(0),
                               jnp.zeros((2, jcfg.latent_dims)), train=True))
    v = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(np.shape(a)))
        .astype(np.float32), dict(v))
    g = Generator(cfg, input_factory=F.g_input_factory("mlp", "relu"),
                  block_factory=F.g_block_factory("bn", "relu", parity=True,
                                                  fused=True),
                  output_factory=F.g_output_factory("bn", "relu"))
    assert isinstance(g.blocks[1], blocks.FusedResidualGeneratorBlock)
    assert g.blocks[1].conv1_kernel.shape == (80, 80, 3, 3)
    g.load_state_dict(from_flax(v))
    back = to_flax(g)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(v)
    for a, b in _leaves(back, v):
        np.testing.assert_array_equal(a, b)

    opt = optax.adam(1e-4, b1=0.0, b2=0.999, eps=1e-8)
    state = opt.init(v["params"])
    grads = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(np.shape(a)).astype(np.float32),
        v["params"])
    _, state = opt.update(grads, state, v["params"])
    tree = jax.device_get(serialization.to_state_dict(state))
    topt = make_adam(g.parameters(), 1e-4)
    adam_from_flax(g, topt, tree)
    assert torch.equal(topt.state[g.blocks[1].conv1_kernel]["exp_avg"],
                       torch.from_numpy(np.ascontiguousarray(
                           np.asarray(tree["0"]["mu"]["blocks_1"]
                                      ["conv1_kernel"]).transpose(3, 2, 0, 1))))
    for a, b in _leaves(adam_to_flax(g, topt), tree):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
