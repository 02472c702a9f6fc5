"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips elsewhere: a CUDA kernel has
no CPU mode. This file imports neither jax nor the JAX package, so on a
machine with a card and without jax it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerances as in ``chip_smoke.py``: float32 1e-4 (exp2 of log2(e)-scaled
logits and another summation order), bfloat16 2e-2 (bf16 output rounding).
The backward's gradients compare after dividing by their max-abs (a sum
over Lq or Lk terms grows with the length), at the same tolerances.
"""
import pytest
import torch

from tartangan_torch.ops.attention import (
    attention,
    attention_bwd,
    attention_bwd_plain,
    attention_plain,
)

TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    # full float32 references: cuDNN's convolutions default to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (1, 4096, 1024, 8, 32),     # '512thin' generator, /generate
    (2, 200, 75, 5, 12),        # ragged Lq, Lk and Ck
    (3, 4096, 1024, 32, 128),   # '1024' generator
    (1, 70, 5000, 64, 33),      # Lk past the TPU kernel's 4096 limit
])
def test_attention_kernel_matches_plain(cuda, shape, dtype):
    b, lq, lk, ck, cv = shape
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(s, device=cuda, generator=gen).to(dtype)
               for s in ((b, lq, ck), (b, lk, ck), (b, lk, cv)))
    before = attention.launches
    out = attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    assert out.dtype == dtype and out.shape == (b, lq, cv)
    torch.testing.assert_close(out.float(), attention_plain(q, k, v).float(),
                               **TOL[dtype])


@pytest.mark.cuda
def test_attention_kernel_rejects_what_it_cannot_take(cuda):
    q = torch.zeros(1, 8, 65, device=cuda)
    with pytest.raises(ValueError, match="Ck"):
        attention(q, torch.zeros(1, 4, 65, device=cuda),
                  torch.zeros(1, 4, 8, device=cuda))
    q = torch.zeros(1, 4, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        attention(q, torch.zeros(1, 8, 4, device=cuda).transpose(1, 2),
                  torch.zeros(1, 4, 8, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (4, 4096, 1024, 8, 32),     # '512thin' generator, training
    (4, 1024, 256, 8, 32),      # '512thin' discriminator, training
    (2, 4096, 1024, 32, 128),   # '1024' generator
    (3, 1000, 333, 7, 40),      # ragged Lq, Lk, Ck and Cv
    (1, 70, 5000, 64, 33),      # Lk past the TPU kernel's 4096 limit
])
def test_attention_bwd_kernel_matches_plain(cuda, shape, dtype):
    b, lq, lk, ck, cv = shape
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v, do = (torch.randn(s, device=cuda, generator=gen).to(dtype)
                   for s in ((b, lq, ck), (b, lk, ck), (b, lk, cv),
                             (b, lq, cv)))
    before = attention_bwd.launches
    out = attention_bwd(q, k, v, do)
    torch.cuda.synchronize()
    assert attention_bwd.launches == before + 1
    for got, ref in zip(out, attention_bwd_plain(q, k, v, do)):
        assert got.dtype == dtype and got.shape == ref.shape
        scale = ref.float().abs().max()
        torch.testing.assert_close(got.float() / scale, ref.float() / scale,
                                   **TOL[dtype])


@pytest.mark.cuda
def test_attention_double_backward_on_the_card(cuda):
    """First- and second-order gradients through the two Functions (K1,
    K2 and the plain vector-Jacobian product) against autograd through
    ``attention_plain``, at the '512thin' discriminator's shape."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    shapes = ((2, 1024, 8), (2, 256, 8), (2, 256, 32))

    def grads(fn):
        q, k, v = (torch.randn(s, device=cuda, generator=gen.manual_seed(3 + i))
                   .requires_grad_() for i, s in enumerate(shapes))
        o = fn(q, k, v)
        w = torch.linspace(-1, 1, o.numel(), device=cuda).reshape(o.shape)
        g1 = torch.autograd.grad((o * w).sum(), (q, k, v), create_graph=True)
        g2 = torch.autograd.grad(g1[0].square().sum(), (q, k, v))
        return g1 + g2

    before = (attention.launches, attention_bwd.launches)
    ours = grads(attention)
    assert (attention.launches, attention_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    for got, ref in zip(ours, grads(attention_plain)):
        scale = ref.abs().max()
        torch.testing.assert_close(got / scale, ref / scale, rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.cuda
def test_attention_bwd_kernel_rejects_what_it_cannot_take(cuda):
    z = torch.zeros
    with pytest.raises(ValueError, match="Cv"):
        attention_bwd(z(1, 8, 8, device=cuda), z(1, 4, 8, device=cuda),
                      z(1, 4, 129, device=cuda), z(1, 8, 129, device=cuda))


# ------------------------------------------- K3, K4, K5 (parity forms)
# float32 against the plain versions, each error over the plain output's
# max-abs: K = 4*Ci products summed in another order than cuDNN's
TOL_PARITY = dict(rtol=0, atol=1e-4)


def _scaled_close(out, ref):
    scale = ref.abs().max()
    torch.testing.assert_close(out / scale, ref / scale, **TOL_PARITY)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["up", "full"])
@pytest.mark.parametrize("shape", [
    (4, 32, 128, 64),    # '512thin' G block 3
    (2, 256, 16, 8),     # '512thin' G block 7
    (3, 7, 5, 7),        # ragged spatial size and channels
    (1, 9, 3, 100),      # two channel blocks per parity
])
def test_parity_conv_kernel_matches_plain(cuda, mode, shape):
    from tartangan_torch.ops.parity_conv import (
        fused_parity_conv_plain,
        merged_tap_conv,
    )
    b, h, cin, cout = shape
    gen = torch.Generator(device=cuda).manual_seed(3)
    ci = cin if mode == "up" else 4 * cin
    x = torch.randn(b, h, h, ci, device=cuda, generator=gen)
    w = 0.1 * torch.randn(cout, cin, 3, 3, device=cuda, generator=gen)
    before = merged_tap_conv.launches
    out = merged_tap_conv(x, w, cout, mode)
    torch.cuda.synchronize()
    assert merged_tap_conv.launches == before + 1
    assert out.shape == (b, h, h, 4 * cout)
    _scaled_close(out, fused_parity_conv_plain(x, w, cout, mode))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 8, 128, 128), (4, 12, 96, 40),
                                   (2, 5, 7, 3)])
def test_gblock_kernels_match_plain(cuda, shape):
    from tartangan_torch.ops import gblock as G
    b, h, cin, cout = shape
    gen = torch.Generator(device=cuda).manual_seed(4)
    r = lambda *s: torch.randn(*s, device=cuda, generator=gen)  # noqa: E731
    x = r(b, h, h, cin)
    w1, w2 = 0.05 * r(cout, cin, 3, 3), 0.05 * r(cout, cout, 3, 3)
    b1, b2, bp = r(cout), r(cout), r(cout)
    wp = 0.05 * r(cin, cout)
    s1, o1, s2, o2 = 1 + 0.1 * r(cin), r(cin), 1 + 0.1 * r(cout), r(cout)
    m1, v1 = G._moments(x)
    before = (G.gblock_a.launches, G.gblock_b.launches)
    y1p, sums = G.gblock_a(x, m1, v1, s1, o1, w1, b1)
    y1r, sumr = G.gblock_a_plain(x, m1, v1, s1, o1, w1, b1)
    for out, ref in ((y1p, y1r), (sums[0], sumr[0]), (sums[1], sumr[1])):
        _scaled_close(out, ref)
    n = 4 * b * h * h
    m2 = sumr.reshape(2, 4, cout).sum(1)[0] / n
    v2 = sumr.reshape(2, 4, cout).sum(1)[1] / n - m2.square()
    out = G.gblock_b(y1r, x, m2, v2, s2, o2, w2, b2, wp, bp)
    _scaled_close(out, G.gblock_b_plain(y1r, x, m2, v2, s2, o2, w2, b2, wp,
                                        bp))
    torch.cuda.synchronize()
    assert (G.gblock_a.launches, G.gblock_b.launches) == \
        (before[0] + 1, before[1] + 1)
    # the same launch twice gives the same sums: no float atomics
    torch.testing.assert_close(G.gblock_a(x, m1, v1, s1, o1, w1, b1)[1],
                               sums, rtol=0, atol=0)


@pytest.mark.cuda
def test_parity_kernels_reject_other_dtypes(cuda):
    from tartangan_torch.ops.parity_conv import merged_tap_conv
    x = torch.zeros(1, 4, 4, 8, device=cuda, dtype=torch.bfloat16)
    w = torch.zeros(3, 8, 3, 3, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        merged_tap_conv(x, w, 3, "up")
