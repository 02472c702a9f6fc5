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
    torch.backends.cuda.matmul.allow_tf32 = False
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
