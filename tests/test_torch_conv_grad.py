"""The port's 2-D convolution and its derivatives (``ops/conv.py``) on the
CPU: gradients of the first three orders against ``F.conv2d``'s autograd,
R1's gradients of a small float64 discriminator against the same D on
``F.conv2d``, no convolution with an image-sized filter in R1's backward,
the same convolution calls as autograd's own node wherever no second
derivative is taken, and the counter of R1's weight term."""
import torch_threads  # noqa: F401  (this process's share of the cores)
import dataclasses

import pytest
import torch
import torch.nn.functional as F
from torch.autograd import gradcheck, gradgradcheck
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from tartangan_torch.configs import GAN_CONFIGS
from tartangan_torch.models import factories as MF
from tartangan_torch.models import layers
from tartangan_torch.models.attention import SelfAttention2d
from tartangan_torch.models.layers import Conv, _Conv2d
from tartangan_torch.models.losses import bce_with_logits, r1_gradient_penalty
from tartangan_torch.models.pluggan import Discriminator, Generator
from tartangan_torch.ops import conv
from tartangan_torch.train.cnn import make_cnn_train_step
from tartangan_torch.train.common import bce_labels, make_adam
from tartangan_torch.train.state import GANTrainState

CFG = dataclasses.replace(GAN_CONFIGS["16"], blocks=(16, 8), attention=(1,))
B = 4
F64 = torch.float64


def _randn(gen, *shape, requires_grad=False):
    return torch.randn(*shape, generator=gen, dtype=F64,
                       requires_grad=requires_grad)


@pytest.mark.parametrize("kernel", [3, 1])
@pytest.mark.parametrize("needs", [(True, True), (True, False),
                                   (False, True)], ids=["xw", "x", "w"])
def test_conv_gradcheck_and_gradgradcheck(kernel, needs):
    gen = torch.Generator().manual_seed(kernel)
    x = _randn(gen, 2, 2, 5, 4, requires_grad=needs[0])
    w = _randn(gen, 3, 2, kernel, kernel, requires_grad=needs[1])

    def f(x, w):
        return conv.conv2d(x, w, padding=kernel // 2)
    assert gradcheck(f, (x, w))
    assert gradgradcheck(f, (x, w))


@pytest.mark.parametrize("kernel", [3, 1])
def test_conv_layer_with_bias_gradgradcheck(kernel):
    """``_Conv2d`` (``Conv``) in float64: the bias added after the
    Function, every operand differentiated twice."""
    layer = Conv(2, 3, kernel).double()
    gen = torch.Generator().manual_seed(10 + kernel)
    x = _randn(gen, 2, 2, 4, 5, requires_grad=True)

    def f(x, w, b):
        return torch.func.functional_call(layer, {"weight": w, "bias": b},
                                          (x,))
    args = (x, layer.weight, layer.bias)
    assert gradcheck(f, args)
    assert gradgradcheck(f, args)


def test_third_derivative_matches_autograd():
    gen = torch.Generator().manual_seed(3)
    x = _randn(gen, 2, 3, 7, 6, requires_grad=True)
    w = _randn(gen, 4, 3, 3, 3, requires_grad=True)

    def third(op):
        y = op(x, w, None, padding=1)
        (g1,) = torch.autograd.grad((y * y).sum(), x, create_graph=True)
        (g2,) = torch.autograd.grad((g1 * g1).sum(), w, create_graph=True)
        return torch.autograd.grad((g2 * g2).sum(), (x, w))
    for ours, ref in zip(third(conv.conv2d), third(F.conv2d)):
        assert ((ours - ref).norm() / ref.norm()).item() < 1e-12


def _discriminator(dtype=F64):
    torch.manual_seed(0)
    d = Discriminator(CFG, input_factory=MF.d_input_factory(),
                      block_factory=MF.d_block_factory("bn", "relu"),
                      output_factory=MF.d_output_factory("bn", "relu"))
    for m in d.modules():
        if isinstance(m, SelfAttention2d):
            m.use_kernel = False  # K1/K2 take float32 and bfloat16
            m.gamma.data.fill_(0.7)  # the attention counts from the start
    return d.to(dtype)


def _inputs(dtype=F64):
    gen = torch.Generator().manual_seed(1)
    return (torch.randn(B, 3, 16, 16, generator=gen).to(dtype),
            torch.randn(B, 3, 16, 16, generator=gen).to(dtype))


def _d_update_grads(d, real, fake):
    """The gradients of one D update: BCE on reals and fakes, R1 (weight
    5) on the reals."""
    d.zero_grad(set_to_none=True)
    gp, p_real = r1_gradient_penalty(d, real.detach().requires_grad_())
    p_fake = d(fake)
    loss = bce_with_logits(torch.cat([p_real, p_fake], 0), bce_labels(B))
    (loss + 5.0 * gp).backward()
    return [p.grad.clone() for p in d.parameters()]


def _plain(monkeypatch):
    """The parent's path: ``_Conv2d`` on ``F.conv2d`` and autograd's own
    node."""
    monkeypatch.setattr(layers, "conv2d", F.conv2d)


def test_r1_d_gradients_match_autograd(monkeypatch):
    """A float64 D update with R1: every parameter's gradient as autograd
    gives it through ``F.conv2d``, to 1e-10 of the whole gradient's norm
    (a conv bias ahead of a train-mode BatchNorm has a zero gradient)."""
    real, fake = _inputs()
    ours = _d_update_grads(_discriminator(), real, fake)
    _plain(monkeypatch)
    ref = _d_update_grads(_discriminator(), real, fake)
    scale = torch.cat([g.flatten() for g in ref]).norm()
    assert scale > 0
    for a, b in zip(ours, ref):
        assert ((a - b).norm() / scale).item() <= 1e-10


def _image_filter_convs(d, real, fake):
    """The ``aten::convolution`` calls of a D update whose weight is as
    wide as its input: autograd's (C, B, H, W) form of R1's weight term."""
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as p:
        _d_update_grads(d, real, fake)
    return [e.input_shapes[:2] for e in p.events()
            if e.name == "aten::convolution"
            and e.input_shapes[1][2:] == e.input_shapes[0][2:]]


def test_r1_backward_runs_no_image_sized_filter(monkeypatch):
    real, fake = _inputs(torch.float32)
    assert _image_filter_convs(_discriminator(torch.float32), real, fake) \
        == []
    _plain(monkeypatch)  # the form is there without ops/conv.py
    found = _image_filter_convs(_discriminator(torch.float32), real, fake)
    assert found and all(w[1] == B for _, w in found)


class _ConvCalls(TorchDispatchMode):
    """Every convolution op dispatched: its name, its tensors' shapes and
    its output mask."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if "convolution" in func.__name__:
            self.calls.append((func.__name__, tuple(
                tuple(a.shape) if isinstance(a, torch.Tensor) else a
                for a in args)))
        return func(*args, **(kwargs or {}))


def _first_order_calls(dtype):
    """The convolution calls of G's no-grad forward, then those of D's
    update on fakes alone and of the G update (D frozen), in ``dtype``."""
    torch.manual_seed(0)
    g = Generator(CFG, input_factory=MF.g_input_factory("mlp", "relu"),
                  block_factory=MF.g_block_factory("bn", "relu"),
                  output_factory=MF.g_output_factory("bn", "relu"),
                  dtype=dtype)
    d = _discriminator(torch.float32)
    d.dtype = dtype
    z = torch.randn(B, CFG.latent_dims)
    with _ConvCalls() as no_grad, torch.no_grad():
        fake = g(z)
    with _ConvCalls() as first_order:
        bce_with_logits(d(fake), torch.zeros(B, 1)).backward()
        d.requires_grad_(False)
        bce_with_logits(d(g(z)), torch.ones(B, 1)).backward()
    return no_grad.calls, first_order.calls


def _sized(call):
    """A call with autograd's size of an absent bias, [0], as None."""
    name, args = call
    if name == "convolution_backward.default" and args[3] == [0]:
        return name, args[:3] + (None,) + args[4:]
    return call


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_first_order_paths_make_autograds_calls(monkeypatch, dtype):
    """Where no second derivative is taken, ``_Conv2d`` makes the
    convolution calls that ``F.conv2d`` and autograd's own node make, call
    for call, output masks included (autograd gives an absent bias the size
    [0], ``ops/conv.py`` None; neither is read)."""
    no_grad, first_order = _first_order_calls(dtype)
    _plain(monkeypatch)
    ref_no_grad, ref_first_order = _first_order_calls(dtype)
    assert no_grad == ref_no_grad
    assert [c[0] for c in first_order].count(
        "convolution_backward.default") > 0
    assert first_order == [_sized(c) for c in ref_first_order]


def _state():
    torch.manual_seed(0)
    g = Generator(CFG, input_factory=MF.g_input_factory("mlp", "relu"),
                  block_factory=MF.g_block_factory("bn", "relu"),
                  output_factory=MF.g_output_factory("bn", "relu"))
    target = Generator(CFG, input_factory=MF.g_input_factory("mlp", "relu"),
                       block_factory=MF.g_block_factory("bn", "relu"),
                       output_factory=MF.g_output_factory("bn", "relu"))
    d = _discriminator(torch.float32)
    return GANTrainState(g=g, g_target=target, d=d,
                         opt_g=make_adam(g.parameters(), 1e-4),
                         opt_d=make_adam(d.parameters(), 4e-4))


@pytest.mark.parametrize("r1_interval", [1, 2])
def test_weight_term_counter(r1_interval):
    """``conv.weight_term.launches``: one a 2-D conv of D in a D update
    with R1; none in the G update, in the step without R1 (``r1_interval``
    2's ``no_r1``) and in a no-grad forward."""
    state = _state()
    n_convs = sum(isinstance(m, _Conv2d) for m in state.d.modules())
    step = make_cnn_train_step(grad_penalty=5.0, ema_factor=1e-3,
                               r1_interval=r1_interval)
    if r1_interval > 1:
        step = step.no_r1
    counts = []
    opt_step = state.opt_d.step

    def d_done(*args, **kwargs):  # the end of the D update
        counts.append(conv.weight_term.launches)
        return opt_step(*args, **kwargs)
    state.opt_d.step = d_done
    gen = torch.Generator().manual_seed(2)
    batch = torch.randint(0, 256, (B, 16, 16, 3), generator=gen,
                          dtype=torch.uint8)
    z_d = torch.randn(1, B, CFG.latent_dims, generator=gen)
    z_g = torch.randn(B, CFG.latent_dims, generator=gen)
    before = conv.weight_term.launches
    step(state, batch, z_d, z_g)
    after = conv.weight_term.launches
    assert counts == [before + (n_convs if r1_interval == 1 else 0)]
    assert after == counts[0]  # the G update
    with torch.no_grad():
        state.d(state.g(z_g))
    assert conv.weight_term.launches == after
