"""The port's parity-domain blocks (``tartangan_torch/models/blocks.py``;
the towers and fusions: ``test_torch_parity_towers.py``) against the JAX
package's, on weights carried over with ``convert.from_flax``: forward
values, the running statistics after one train-mode forward, input and
parameter gradients, and the R1 penalty's double gradient through the parity
D, as ``tests/test_parity_blocks.py`` holds the JAX parity blocks to flax.

Inputs and weight perturbations come from numpy with a seed. Tolerances
(float32): outputs and statistics 1e-4 (summation order differs between the
frameworks and grows through a tower); gradients 1e-4 of the max-abs over
the whole gradient (a conv bias before a train-mode BatchNorm has a gradient
of 0 up to rounding, so a leaf's own max-abs is no scale); R1 double
gradients 1e-3 of it (a second order through BatchNorm's statistics).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tartangan_tpu.models import blocks as jblocks
from tartangan_tpu.ops import parity as JP
from tartangan_torch.convert import _to_tree, from_flax, to_flax
from tartangan_torch.models import blocks
from tartangan_torch.models.layers import update_batch_stats

CIN, COUT, H, B = 12, 8, 8, 3


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


def _check_block(jmod, ours, x_jax, x_port, rng, grads=True):
    """Forward, updated statistics and (sum of squares) gradients."""
    variables = _variables(jmod, x_jax, rng)
    ref, upd = jmod.apply(variables, jnp.asarray(x_jax), train=True,
                          mutable=["batch_stats"])
    ours.load_state_dict(from_flax(variables))
    xt = x_port.clone().requires_grad_()
    with update_batch_stats(ours):
        out = ours(xt, train=True)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    for a, b in _leaves(to_flax(ours)["batch_stats"],
                        jax.device_get(upd["batch_stats"])):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    if not grads:
        return variables
    # again from the loaded statistics: the forward above moved them
    ours.load_state_dict(from_flax(variables))
    ours(xt, train=True).square().sum().backward()

    def loss(params, x):
        o, _ = jmod.apply({"params": params,
                           "batch_stats": variables["batch_stats"]},
                          x, train=True, mutable=["batch_stats"])
        return jnp.sum(jnp.square(o))

    gp, gx = jax.device_get(jax.grad(loss, argnums=(0, 1))(
        variables["params"], jnp.asarray(x_jax)))
    _assert_scaled(_grad_tree(ours), gp, 1e-4)
    gx_ours = _nhwc(xt.grad)
    np.testing.assert_allclose(gx_ours / np.abs(gx).max(),
                               np.asarray(gx) / np.abs(gx).max(), rtol=0,
                               atol=1e-4)
    return variables


# ------------------------------------------------------------------ G block
@pytest.mark.parametrize("cin,cout,emit", [(CIN, COUT, False),
                                           (COUT, COUT, False),
                                           (CIN, COUT, True)])
def test_parity_g_block_matches_jax(rng, cin, cout, emit):
    """Forward, statistics and gradients; a projected and an identity
    shortcut; the parity-stacked output (``emit_parity``)."""
    x = rng.standard_normal((B, H, H, cin)).astype(np.float32)
    jmod = jblocks.ParityResidualGeneratorBlock(cin, cout, emit_parity=emit)
    ours = blocks.ParityResidualGeneratorBlock(cin, cout, emit_parity=emit)
    _check_block(jmod, ours, x, _nchw(x), rng)


def test_parity_g_block_eval_mode_matches_jax(rng):
    x = rng.standard_normal((B, H, H, CIN)).astype(np.float32)
    jmod = jblocks.ParityResidualGeneratorBlock(CIN, COUT)
    variables = _variables(jmod, x, rng)
    ref = jmod.apply(variables, jnp.asarray(x), train=False)
    ours = blocks.ParityResidualGeneratorBlock(CIN, COUT)
    ours.load_state_dict(from_flax(variables))
    with torch.no_grad():
        out = ours(_nchw(x), train=False)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


# ------------------------------------------------------------------ D block
@pytest.mark.parametrize("first,accept,emit", [
    (False, False, False), (True, False, False), (False, True, False),
    (False, False, True), (False, True, True), (True, True, True)])
def test_parity_d_block_matches_jax(rng, first, accept, emit):
    x = rng.standard_normal((B, 2 * H, 2 * H, CIN)).astype(np.float32)
    if accept:
        x = np.asarray(JP.space_to_depth(jnp.asarray(x)))
    jmod = jblocks.ParityResidualDiscriminatorBlock(
        CIN, COUT, first_block=first, accept_parity=accept, emit_parity=emit)
    ours = blocks.ParityResidualDiscriminatorBlock(
        CIN, COUT, first_block=first, accept_parity=accept, emit_parity=emit)
    if accept and not first:
        assert isinstance(ours.NormAct_0, blocks._ParityNormAct)
    _check_block(jmod, ours, x, _nchw(x), rng)


@pytest.mark.parametrize("first,accept,emit", [(False, False, False),
                                               (True, True, True)])
def test_parity_d_block_r1_double_grad_matches_jax(rng, first, accept, emit):
    """The R1 penalty's gradient w.r.t. the parameters, through the parity
    D block (``tests/test_parity_blocks.py:339``)."""
    x = rng.standard_normal((B, 2 * H, 2 * H, CIN)).astype(np.float32)
    if accept:
        x = np.asarray(JP.space_to_depth(jnp.asarray(x)))
    jmod = jblocks.ParityResidualDiscriminatorBlock(
        CIN, COUT, first_block=first, accept_parity=accept, emit_parity=emit)
    variables = _variables(jmod, x, rng)

    def penalty(params):
        def d_sum(xx):
            out, _ = jmod.apply({"params": params,
                                 "batch_stats": variables["batch_stats"]},
                                xx, train=True, mutable=["batch_stats"])
            return jnp.sum(out)
        return jnp.sum(jnp.square(jax.grad(d_sum)(jnp.asarray(x))))

    ref = jax.device_get(jax.jit(jax.grad(penalty))(variables["params"]))
    ours = blocks.ParityResidualDiscriminatorBlock(
        CIN, COUT, first_block=first, accept_parity=accept, emit_parity=emit)
    ours.load_state_dict(from_flax(variables))
    xt = _nchw(x).requires_grad_()
    (gx,) = torch.autograd.grad(ours(xt, train=True).sum(), xt,
                                create_graph=True)
    gx.square().sum().backward()
    _assert_scaled(_grad_tree(ours), ref, 1e-3)


def test_d_block_set_layout_keeps_the_norm_state():
    block = blocks.ParityResidualDiscriminatorBlock(4, 4)
    with torch.no_grad():
        block.NormAct_0.BatchNorm_0.running_mean.fill_(0.5)
    block.set_layout(accept_parity=True, emit_parity=True)
    assert isinstance(block.NormAct_0, blocks._ParityNormAct)
    assert block.emit_parity and block.accept_parity
    assert float(block.NormAct_0.BatchNorm_0.running_mean[0]) == 0.5
