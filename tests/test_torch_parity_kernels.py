"""The plain version of the port's K3 (``ops/parity_conv.py``) and its
autograd Function against the JAX package's ``fused_parity_conv`` with its
Pallas kernel in interpret mode, as ``tests/test_parity_fused_conv.py``
runs it. K4/K5 and the fused block: ``test_torch_fused_gblock.py``.

On the CPU the wrapper runs the plain version, so this holds the function
the kernel must compute and the wiring around it; the kernel itself is held
to the plain version on the card (``chip_smoke.py``,
``tests/test_torch_kernels_cuda.py``). Tolerances (float32): 1e-5 relative
with 1e-5 absolute, forward values and gradients (one conv, summed in
another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tartangan_tpu.ops.pallas import parity_conv as JPC
from tartangan_torch.ops import parity_conv as PC


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------- K3
def _k3_inputs(rng, mode, b, h, w, cin, cout):
    ci = cin if mode == "up" else 4 * cin
    x = rng.standard_normal((b, h, w, ci)).astype(np.float32)
    w = (0.1 * rng.standard_normal((3, 3, cin, cout))).astype(np.float32)
    bias = rng.standard_normal((cout,)).astype(np.float32)
    return x, w, bias


@pytest.mark.parametrize("mode", ["up", "full"])
@pytest.mark.parametrize("shape", [(2, 6, 6, 3, 5), (1, 7, 7, 4, 3),
                                   (2, 4, 4, 8, 8), (2, 5, 9, 3, 2)])
def test_k3_plain_matches_jax_interpret(rng, monkeypatch, mode, shape):
    monkeypatch.setattr(JPC, "_INTERPRET", True)
    x, w, bias = _k3_inputs(rng, mode, *shape)
    cout = shape[-1]
    ref = JPC.fused_parity_conv(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(bias), cout, mode)
    before = PC.merged_tap_conv.launches
    out = PC.fused_parity_conv(_t(x), _oihw(w), _t(bias), cout, mode)
    assert PC.merged_tap_conv.launches == before  # no kernel on the CPU
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    plain = PC.fused_parity_conv_plain(_t(x), _oihw(w), cout, mode)
    torch.testing.assert_close(plain + _t(bias).repeat(4), out)


@pytest.mark.parametrize("mode", ["up", "full"])
def test_k3_function_gradients_match_jax(rng, monkeypatch, mode):
    """The Function's backward (the 3x3-packed form's vector-Jacobian
    product) against JAX's ``custom_vjp`` of ``fused_parity_conv``."""
    monkeypatch.setattr(JPC, "_INTERPRET", True)
    x, w, bias = _k3_inputs(rng, mode, 2, 4, 4, 4, 3)
    cot = rng.standard_normal((2, 4, 4, 12)).astype(np.float32)
    ref = jax.grad(lambda a, b, c: jnp.sum(
        JPC.fused_parity_conv(a, b, c, 3, mode) * cot), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    leaves = [_t(x).requires_grad_(), _oihw(w).requires_grad_(),
              _t(bias).requires_grad_()]
    (PC.fused_parity_conv(*leaves, 3, mode) * _t(cot)).sum().backward()
    ours = [leaves[0].grad.numpy(),
            leaves[1].grad.numpy().transpose(2, 3, 1, 0),
            leaves[2].grad.numpy()]
    for a, r in zip(ours, ref):
        np.testing.assert_allclose(a, np.asarray(r), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["up", "full"])
def test_k3_bias_on_the_cpu(rng, mode):
    """``merged_tap_conv(..., bias=b)`` on the CPU is the plain version plus
    ``tile(b, 4)``; ``fused_parity_conv``'s forward and gradients are those
    of the plain version with the bias added outside, as before."""
    x, w, bias = _k3_inputs(rng, mode, 2, 5, 3, 4, 3)
    x, w, bias = _t(x), _oihw(w), _t(bias)
    plain = PC.fused_parity_conv_plain(x, w, 3, mode)
    before = PC.merged_tap_conv.launches
    out = PC.merged_tap_conv(x, w, 3, mode, bias=bias)
    assert PC.merged_tap_conv.launches == before
    torch.testing.assert_close(out, plain + bias.repeat(4), rtol=0, atol=0)
    torch.testing.assert_close(
        PC.fused_parity_conv_plain(x, w, 3, mode, bias), out, rtol=0, atol=0)
    cot = _t(rng.standard_normal(out.shape).astype(np.float32))

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (x, w, bias)]
        y = fn(*leaves)
        return (y,) + torch.autograd.grad((y * cot).sum(), leaves)

    ours = grads(lambda a, b, c: PC.fused_parity_conv(a, b, c, 3, mode))
    ref = grads(lambda a, b, c: PC.fused_parity_conv_plain(a, b, 3, mode)
                + c.repeat(4))
    for a, r in zip(ours, ref):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)


def test_k3_wrapper_rejects_what_it_cannot_take():
    x = torch.zeros(1, 4, 4, 8)
    w = torch.zeros(3, 8, 3, 3)
    with pytest.raises(TypeError):
        PC.merged_tap_conv(x.double(), w.double(), 3, "up")
    with pytest.raises(ValueError, match="mode"):
        PC.merged_tap_conv(x, w, 3, "down")
    with pytest.raises(ValueError):
        PC.merged_tap_conv(x, w, 3, "full")  # 'full' needs 4 * cin channels
    with pytest.raises(ValueError, match="bias"):
        PC.merged_tap_conv(x, w, 3, "up", bias=torch.zeros(4))
    with pytest.raises(TypeError):
        PC.merged_tap_conv(x, w, 3, "up", bias=torch.zeros(3).double())
