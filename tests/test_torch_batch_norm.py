"""Train-mode BatchNorm (``tartangan_torch/ops/batch_norm.py``) on the CPU:
the autograd functions the card runs (``_BatchNorm``, whose backward is
``_BatchNormBackward``), here on their plain versions, against the layer's
arithmetic before the kernels (``torch.var_mean`` and ``F.batch_norm`` in
float32, differentiated by autograd); their second derivatives (R1's
path) by ``gradgradcheck`` in float64 and against ATen's double backward;
and which path a forward takes. The kernels themselves are held against the
plain versions on the card (``tests/test_torch_kernels_cuda.py``).

Tolerances: forward and running statistics equal to the bit (the same
ops); first and second derivatives within torch's default float32 / float64
tolerances (the same formulas, the statistics taken by another op).
"""
import torch_threads  # noqa: F401  (this process's share of the cores)
import pytest
import torch
import torch.nn.functional as F

from tartangan_torch.models import layers
from tartangan_torch.ops import batch_norm as BN

SHAPES = [(16, 5), (6, 4, 7), (4, 3, 5, 6)]
EPS = 1e-5


def _today(x, w, b, running):
    """The layer's train-mode forward before the kernels."""
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    if running is not None:
        with torch.no_grad():
            dims = [d for d in range(x.dim()) if d != 1]
            var, mean = torch.var_mean(x32.detach(), dim=dims, correction=0)
            running[0].mul_(0.9).add_(mean, alpha=1 - 0.9)
            running[1].mul_(0.9).add_(var, alpha=1 - 0.9)
    y = F.batch_norm(x32, None, None, w, b, training=True, eps=EPS)
    return y.to(x.dtype)


def _case(shape, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    c = shape[1]
    x = (torch.randn(shape, generator=gen, dtype=torch.float64) * 2 + 0.5)
    w = torch.rand(c, generator=gen, dtype=torch.float64) + 0.5
    b = torch.randn(c, generator=gen, dtype=torch.float64)
    dy = torch.randn(shape, generator=gen, dtype=torch.float64)
    running = (torch.randn(c, generator=gen, dtype=torch.float64),
               torch.rand(c, generator=gen, dtype=torch.float64) + 0.5)
    return ([t.to(dtype).requires_grad_() for t in (x, w, b)],
            dy.to(dtype), [t.to(dtype) for t in running])


def _function(x, w, b, running):
    return BN._BatchNorm.apply(x, w, b, EPS, *(running or (None, None)),
                               0.9)


def _layer(x, w, b, running):
    bn = layers.BatchNorm(x.shape[1]).to(x.dtype)
    with torch.no_grad():
        bn.weight.copy_(w)
        bn.bias.copy_(b)
        bn.running_mean.copy_(running[0])
        bn.running_var.copy_(running[1])
    with layers.update_batch_stats(bn):
        y = bn(x)
    running[0].copy_(bn.running_mean)
    running[1].copy_(bn.running_var)
    return y, bn


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("path", ["function", "layer"])
def test_matches_todays_batch_norm(shape, dtype, path):
    """Forward, running statistics and first-order gradients (x, w, b) of
    ``_BatchNorm`` on its plain versions, and of the layer, against the
    layer's arithmetic before the kernels."""
    (x, w, b), dy, running = _case(shape, dtype)
    ref_running = [t.clone() for t in running]
    ref = _today(x, w, b, ref_running)
    ref_grads = torch.autograd.grad(ref, (x, w, b), dy)
    if path == "function":
        y = _function(x, w, b, running)
        grads = torch.autograd.grad(y, (x, w, b), dy)
    else:
        y, bn = _layer(x, w, b, running)
        grads = torch.autograd.grad(y, (x, bn.weight, bn.bias), dy)
    assert torch.equal(y, ref)
    for got, want in zip(running, ref_running):
        assert torch.equal(got, want)
    for got, want in zip(grads, ref_grads):
        torch.testing.assert_close(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_second_derivatives_gradgradcheck(shape):
    """``_BatchNormBackward``'s backward (R1's second-order terms) against
    finite differences of its forward, in float64, with and without the
    running statistics' update."""
    (x, w, b), _, running = _case(shape, torch.float64, seed=1)
    torch.autograd.gradcheck(lambda *t: _function(*t, running), (x, w, b))
    torch.autograd.gradgradcheck(lambda *t: _function(*t, None), (x, w, b))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("terms", ["x", "w", "b", "xwb"])
def test_second_derivatives_match_aten(shape, dtype, terms):
    """R1's path ("x"): the gradient with respect to x built with
    ``create_graph``, contracted with a vector and differentiated again
    with respect to x, w and the upstream gradient, against autograd's own
    double backward of ``F.batch_norm``; likewise for the gradients of w
    and b, alone and all three together."""
    (x, w, b), dy, _ = _case(shape, dtype, seed=2)
    dy.requires_grad_()
    gen = torch.Generator().manual_seed(3)
    v = torch.randn(shape, generator=gen, dtype=dtype)
    vw, vb = torch.randn((2, shape[1]), generator=gen, dtype=dtype)
    out = []
    for fn in (_today, _function):
        grads = torch.autograd.grad(fn(x, w, b, None), (x, w, b), dy,
                                    create_graph=True)
        loss = sum((gr * vec).sum() for gr, vec, t
                   in zip(grads, (v, vw, vb), "xwb") if t in terms)
        out.append(torch.autograd.grad(loss, (x, w, dy), allow_unused=True,
                                       materialize_grads=True))
    for got, want in zip(*out[::-1]):
        torch.testing.assert_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_r1_between_convs_matches_aten(dtype):
    """R1's path as a D runs it: conv, ``_BatchNorm``, leaky-relu, conv;
    the penalty on the input gradient (built with ``create_graph``) and a
    loss on the output, backward into the convs' and BatchNorm's
    parameters, against the same with the layer's arithmetic before the
    kernels. dy and x of ``_BatchNormBackward`` are then outputs of the
    graph, and w lies on dy's history."""
    gen = torch.Generator().manual_seed(4)
    x0 = torch.randn((4, 2, 6, 6), generator=gen, dtype=dtype)
    k1, k2 = (torch.randn(s, generator=gen, dtype=dtype) * 0.5
              for s in ((3, 2, 3, 3), (2, 3, 3, 3)))
    w, b = torch.rand(3, generator=gen, dtype=dtype) + 0.5, torch.randn(
        3, generator=gen, dtype=dtype)
    out = []
    for fn in (_today, _function):
        params = [t.clone().requires_grad_() for t in (k1, k2, w, b)]
        real = x0.clone().requires_grad_()
        h = F.conv2d(real, params[0], padding=1)
        h = F.leaky_relu(fn(h, params[2], params[3], None), 0.2)
        logits = F.conv2d(h, params[1], padding=1).sum((1, 2, 3))
        (g,) = torch.autograd.grad(logits.sum(), real, create_graph=True)
        (F.softplus(-logits).mean()
         + 5.0 * g.square().sum((1, 2, 3)).mean()).backward()
        out.append([p.grad for p in params])
    for got, want in zip(*out[::-1]):
        torch.testing.assert_close(got, want)


def test_cpu_eval_and_mesh_take_their_paths(monkeypatch):
    """A CPU train-mode forward takes the plain version (no autograd
    function, no launch count); eval mode normalizes with the running
    statistics; under a data mesh the layer takes ``_global_batch_norm``."""
    def refuse(*args):
        raise AssertionError("the CPU path ran the kernels' function")

    monkeypatch.setattr(BN._BatchNorm, "apply", refuse)
    (x, w, b), _, running = _case((4, 3, 5, 6), torch.float32)
    before = BN.batch_norm.launches
    y, bn = _layer(x, w, b, running)
    assert torch.equal(y, _today(x, w, b, None))
    assert BN.batch_norm.launches == before

    bn.eval()
    want = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                        bn.bias, training=False, eps=bn.eps)
    assert torch.equal(bn(x, train=False), want)

    seen = []
    monkeypatch.setattr(layers.C, "data_reducing", lambda: object())
    monkeypatch.setattr(layers.BatchNorm, "_global_batch_norm",
                        lambda self, x32: seen.append(x32) or x32)
    bn.train()
    assert torch.equal(bn(x), x) and len(seen) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64])
def test_other_devices_go_to_the_kernels(dtype):
    """A tensor not on the CPU goes to the kernels, which launch or raise
    (here on the meta device: raise), with a gradient or without, float64
    too; a layer with ``use_kernel = False`` takes the plain version on any
    device."""
    x = torch.zeros((2, 3, 4), device="meta", dtype=dtype)
    w, b = (torch.ones(3, device="meta") for _ in range(2))
    with pytest.raises(ValueError, match="run on cuda"):
        BN._forward_kernel(x, w, b, EPS, None, None, 0.9)
    with pytest.raises(ValueError, match="run on cuda"):
        BN.batch_norm(x, w.requires_grad_(), b, EPS)
    bn = layers.BatchNorm(3).to(device="meta", dtype=dtype)
    with pytest.raises(ValueError, match="run on cuda"):
        bn(x)
    bn.use_kernel = False
    assert bn(x).shape == x.shape


@pytest.mark.parametrize("m, c, runs", [
    (64 * 512 * 512, 8, 264),    # D's and G's 8-channel blocks at 512^2
    (64 * 256 * 256, 16, 132),   # the 16-channel blocks at 256^2
    (64 * 32 * 32, 128, 16),     # a 128-channel block at 32^2: 2048 CTAs
    (64 * 4 * 4, 128, 1),        # small planes: one run a channel
    (64, 512, 1),                # a (B, C) input: one value a plane
])
def test_split_grid(m, c, runs):
    """The runs a channel is cut into at the cells' shapes on 132 SMs:
    each at least RUN_MIN values, and enough CTAs over all channels to give
    every SM RUNS_PER_SM where there are values for them."""
    assert BN.splits(m, c, 132) == runs
    assert runs == 1 or m // runs >= BN.RUN_MIN
    assert runs * c >= min(132 * BN.RUNS_PER_SM, c * (m // BN.RUN_MIN))
