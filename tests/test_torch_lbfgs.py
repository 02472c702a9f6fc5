"""The port's L-BFGS (``tartangan_torch/explore/lbfgs.py``) against
``optax.lbfgs`` iterate for iterate, and find_image's perceptual features
(forward hooks on the port's Inception) against flax's
``capture_intermediates`` on the same weights.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tartangan_torch.explore.lbfgs import LBFGS

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
CALIBRATED = os.path.join(FIXTURES, "inception_calibrated.npz")

_A = np.array([[3.0, 1.0, 0.0], [1.0, 2.0, 0.5], [0.0, 0.5, 1.0]],
              np.float32)
_B = np.array([1.0, -2.0, 0.5], np.float32)


def _quadratic(x, lib):
    a = lib.asarray(_A) if lib is jnp else torch.from_numpy(_A)
    b = lib.asarray(_B) if lib is jnp else torch.from_numpy(_B)
    return 0.5 * x @ (a @ x) - b @ x


def _rosenbrock(x, lib):
    del lib
    return (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2


@pytest.mark.parametrize("fn,x0,lr", [
    (_quadratic, (1.0, 1.0, 1.0), None),
    (_rosenbrock, (-1.2, 1.0), None),
    (_rosenbrock, (-1.2, 1.0), 0.1),
], ids=["quadratic", "rosenbrock", "rosenbrock-lr0.1"])
def test_lbfgs_matches_optax(fn, x0, lr):
    """Ten iterations, each with its line search: iterates within 1e-4
    relative of optax's in float32."""
    x0 = np.asarray(x0, np.float32)
    opt = optax.lbfgs(lr)
    x = jnp.asarray(x0)
    state = opt.init(x)
    value_and_grad = jax.value_and_grad(lambda v: fn(v, jnp))
    ref = []
    for _ in range(10):
        value, grad = value_and_grad(x)
        updates, state = opt.update(grad, state, x, value=value, grad=grad,
                                    value_fn=lambda v: fn(v, jnp))
        x = optax.apply_updates(x, updates)
        ref.append(np.asarray(x))

    def torch_value_and_grad(t):
        t = t.detach().requires_grad_(True)
        value = fn(t, torch)
        (grad,) = torch.autograd.grad(value, t)
        return value.detach(), grad

    ours = LBFGS(lr)
    t = torch.from_numpy(x0)
    tstate = ours.init(t)
    for i in range(10):
        value, grad = torch_value_and_grad(t)
        updates, tstate = ours.update(grad, tstate, t, value=value,
                                      value_and_grad_fn=torch_value_and_grad)
        t = t + updates
        assert tstate.num_linesearch_steps >= 1
        np.testing.assert_allclose(t.numpy(), ref[i], rtol=1e-4, atol=1e-6,
                                   err_msg=f"iteration {i}")


def test_perceptual_features_match_flax():
    """The hooks' capture of ``Mixed_5b``/``Mixed_6b``/``Mixed_7b`` of the
    port's Inception at B 1 against flax's ``capture_intermediates`` on the
    calibrated weights, within 1e-4 of each layer's max-abs (the deepest
    differs by up to 2.6e-4 in absolute terms, as the whole network's
    output is held to 2e-4 in ``test_torch_eval.py``)."""
    import tartangan_torch.explore.find_image as T
    import tartangan_tpu.explore.find_image as J
    argv = ["run", "out", "target", "--vgg", "--inception-weights",
            CALIBRATED]
    jax_app = J.FindImage(J.FindImage.parse_cli_args(argv))
    torch_app = T.FindImage(T.FindImage.parse_cli_args(
        argv + ["--device", "cpu"]))
    torch_app.device = torch.device("cpu")
    imgs = np.random.default_rng(0).uniform(
        -1, 1, (1, 32, 32, 3)).astype(np.float32)
    ref = jax_app._make_feature_extractor()(jnp.asarray(imgs))
    with torch.no_grad():
        ours = torch_app._make_feature_extractor()(
            torch.from_numpy(imgs.transpose(0, 3, 1, 2)))
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        a = a.numpy().transpose(0, 2, 3, 1)
        assert a.shape == b.shape
        b = np.asarray(b)
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()
