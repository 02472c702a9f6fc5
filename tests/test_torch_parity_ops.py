"""The port's parity-domain ops (``tartangan_torch/ops/parity.py`` and the
parity downsamplers of ``ops/resize.py``) against the JAX package's, on the
same numpy inputs, in the manner of ``tests/test_parity_blocks.py:45-196``.

Weights are drawn HWIO for JAX and handed to the port as OIHW; each packed
weight comes back to HWIO for the comparison. Tolerances (float32): the
packers are sums of at most four weights, 1e-6; layout ops are exact; the
convolutions 1e-5 relative with 1e-5 absolute (another summation order);
the moments 1e-5 (``mean(x^2) - mean^2`` in float32 on both sides).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tartangan_tpu.ops import parity as JP
from tartangan_tpu.ops import resize as jresize
from tartangan_torch.ops import parity as P
from tartangan_torch.ops import resize

CIN, COUT = 6, 5


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def _hwio(t):
    return t.detach().numpy().transpose(2, 3, 1, 0)


@pytest.mark.parametrize("name,ksize", [
    ("pack_up_conv", 3), ("pack_up_conv2", 3), ("pack_full_conv", 3),
    ("pack_full_conv2", 3), ("pack_down_conv", 3),
    ("pack_down_parity_conv", 3), ("pack_point_conv", 1)])
def test_packers_match_jax(rng, name, ksize):
    w = rng.standard_normal((ksize, ksize, CIN, COUT)).astype(np.float32)
    ref = np.asarray(getattr(JP, name)(jnp.asarray(w)))
    out = _hwio(getattr(P, name)(_oihw(w)))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_packers_are_differentiable_twice(rng):
    """The D side's packed convs sit under R1's double backward."""
    w = _oihw(rng.standard_normal((3, 3, CIN, COUT)).astype(np.float32))
    w.requires_grad_()
    (g,) = torch.autograd.grad(P.pack_down_parity_conv(w).square().sum(), w,
                               create_graph=True)
    (g2,) = torch.autograd.grad(g.square().sum(), w)
    assert g2.shape == w.shape and g2.abs().max() > 0


@pytest.mark.parametrize("shape", [(2, 8, 10, 5), (1, 2, 2, 3)])
def test_depth_space_match_jax(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    s2d = P.space_to_depth(_nchw(x))
    np.testing.assert_array_equal(_nhwc(s2d),
                                  np.asarray(JP.space_to_depth(jnp.asarray(x))))
    assert s2d.is_contiguous(memory_format=torch.channels_last)
    c = shape[-1]
    y = rng.standard_normal((2, 3, 4, 4 * c)).astype(np.float32)
    np.testing.assert_array_equal(
        _nhwc(P.depth_to_space(_nchw(y), c)),
        np.asarray(JP.depth_to_space(jnp.asarray(y), c)))
    np.testing.assert_array_equal(
        P.depth_to_space(s2d, c).numpy(), _nchw(x).numpy())


@pytest.mark.parametrize("mode", ["up", "full"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_conv_parity2_matches_jax(rng, mode, with_bias):
    x = rng.standard_normal((2, 7, 9, CIN if mode == "up" else 4 * CIN)) \
        .astype(np.float32)
    w = rng.standard_normal((3, 3, CIN, COUT)).astype(np.float32)
    b = rng.standard_normal((4 * COUT,)).astype(np.float32)
    jpack = JP.pack_up_conv2 if mode == "up" else JP.pack_full_conv2
    pack = P.pack_up_conv2 if mode == "up" else P.pack_full_conv2
    ref = JP.conv_parity2(jnp.asarray(x), jpack(jnp.asarray(w)), COUT,
                          jnp.asarray(b) if with_bias else None)
    out = P.conv_parity2(_nchw(x), pack(_oihw(w)), COUT,
                         torch.from_numpy(b) if with_bias else None)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mode", ["up", "full"])
def test_merged_tap_equals_packed_3x3(rng, mode):
    """``conv_parity2`` with the 2x2 packers and ``F.conv2d`` with the 3x3
    ones are the same function (the port's MERGED_TAP switch)."""
    x = _nchw(rng.standard_normal(
        (2, 6, 5, CIN if mode == "up" else 4 * CIN)).astype(np.float32))
    w = _oihw(rng.standard_normal((3, 3, CIN, COUT)).astype(np.float32))
    pack2, pack3 = ((P.pack_up_conv2, P.pack_up_conv) if mode == "up"
                    else (P.pack_full_conv2, P.pack_full_conv))
    torch.testing.assert_close(P.conv_parity2(x, pack2(w), COUT),
                               P.conv2d(x, pack3(w), padding=1),
                               rtol=1e-5, atol=1e-5)


def test_folded_moments_match_jax(rng):
    x = (rng.standard_normal((3, 6, 6, 4 * COUT)) * 2 + 1).astype(np.float32)
    m, v = P.folded_moments(_nchw(x), COUT)
    jm, jv = JP.folded_moments(jnp.asarray(x), COUT)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("hw", [(12, 8), (16, 4)])
def test_parity_downsamplers_match_jax(rng, align_corners, hw):
    x = rng.standard_normal((2, *hw, 5)).astype(np.float32)
    xp = np.asarray(JP.space_to_depth(jnp.asarray(x)))
    np.testing.assert_allclose(
        _nhwc(resize.downsample_bilinear_half_parity(_nchw(xp), 5,
                                                     align_corners)),
        np.asarray(jresize.downsample_bilinear_half_parity(
            jnp.asarray(xp), 5, align_corners=align_corners)),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        _nhwc(resize.downsample_bilinear_half_parity_to_parity(
            _nchw(xp), 5, align_corners)),
        np.asarray(jresize.downsample_bilinear_half_parity_to_parity(
            jnp.asarray(xp), 5, align_corners=align_corners)),
        rtol=1e-5, atol=1e-6)
    # and the full-resolution shortcut it replaces (``F.interpolate``
    # computes its weights in another order: 1e-5)
    if align_corners:
        np.testing.assert_allclose(
            _nhwc(resize.downsample_bilinear_half_parity(_nchw(xp), 5)),
            _nhwc(resize.downsample_bilinear_half(_nchw(x))),
            rtol=1e-5, atol=1e-5)
