"""The port's cached constants (``tartangan_torch/ops/consts.py``): after a
first call, the parity packers and the parity downsamplers make no tensor
from numpy, so on the card they neither copy from the host nor synchronize
the stream; and what they multiply by is bit for bit what it was when each
call made it anew with ``torch.as_tensor``."""
import torch_threads  # noqa: F401  (this process's share of the cores)
import numpy as np
import pytest
import torch

from tartangan_torch.ops import consts
from tartangan_torch.ops import parity as P
from tartangan_torch.ops import resize

PACKERS = ["pack_up_conv", "pack_up_conv2", "pack_full_conv",
           "pack_full_conv2", "pack_down_conv", "pack_down_parity_conv",
           "pack_point_conv"]
KINDS = ["up", "up2", "full", "full2", "down", "down_parity"]


def _calls(rng, dtype):
    """Every packer and both parity downsamplers, as zero-argument calls."""
    w3 = torch.from_numpy(rng.standard_normal((5, 6, 3, 3))).to(dtype)
    w1 = torch.from_numpy(rng.standard_normal((5, 6, 1, 1))).to(dtype)
    xp = torch.from_numpy(rng.standard_normal((2, 4 * 3, 8, 8))).to(dtype)
    calls = [lambda name=name: getattr(P, name)(
        w1 if name == "pack_point_conv" else w3) for name in PACKERS]
    for align in (True, False):
        calls.append(lambda a=align: resize.downsample_bilinear_half_parity(
            xp, 3, align_corners=a))
        calls.append(
            lambda a=align: resize.downsample_bilinear_half_parity_to_parity(
                xp, 3, align_corners=a))
    return calls


def _refuse(*args, **kwargs):
    raise AssertionError("a tensor was made from host data")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_no_tensor_from_numpy_after_the_first_call(rng, monkeypatch, dtype):
    calls = _calls(rng, dtype)
    first = [fn() for fn in calls]
    for name in ("as_tensor", "from_numpy", "tensor"):
        monkeypatch.setattr(torch, name, _refuse)
    again = [fn() for fn in calls]
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_cached_constant_is_one_object_per_key_dtype_device():
    made = []

    def make():
        made.append(1)
        return np.arange(6, dtype=np.float32).reshape(2, 3)

    key = ("test", "arange")
    a = consts.device_constant(key, make, torch.float32, "cpu")
    b = consts.device_constant(key, make, torch.float32, torch.device("cpu"))
    c = consts.device_constant(key, make, torch.float64, "cpu")
    assert a is b and c is not a and len(made) == 2
    assert c.dtype == torch.float64 and not a.requires_grad
    assert torch.equal(c, a.double())
    assert consts.device_constant(("test", "other"), make, torch.float32,
                                  "cpu") is not a


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_constants_are_bit_identical_to_a_fresh_copy(dtype):
    w = torch.zeros(1, dtype=dtype)
    for kind in KINDS:
        fresh = torch.as_tensor(P._selection(kind), dtype=dtype)
        assert torch.equal(P._sel(kind, w), fresh), kind
        assert P._sel(kind, w) is P._sel(kind, w)
    for n_in, n_out in ((16, 8), (8, 4), (5, 2)):
        for align in (True, False):
            fresh = torch.as_tensor(
                resize._linear_interp_matrix(n_in, n_out, align), dtype=dtype)
            assert torch.equal(resize._interp(n_in, n_out, align, w), fresh)


def test_constant_made_under_inference_mode_serves_autograd(rng,
                                                            monkeypatch):
    """The serve app runs the generator under inference mode; a constant
    first made there must still be saved for a training step's backward
    (R1 differentiates the D packers twice)."""
    monkeypatch.setattr(consts, "_CACHE", {})
    w = torch.from_numpy(rng.standard_normal((3, 3, 3, 3)).astype(np.float32))
    with torch.inference_mode():
        P.pack_full_conv2(w.clone())
        P.pack_down_parity_conv(w.clone())
    w.requires_grad_()
    for pack in (P.pack_full_conv2, P.pack_down_parity_conv):
        (g,) = torch.autograd.grad(pack(w).square().sum(), w,
                                   create_graph=True)
        (g2,) = torch.autograd.grad(g.square().sum(), w)
        assert g2.abs().max() > 0
