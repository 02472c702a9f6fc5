"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips elsewhere: a CUDA kernel has
no CPU mode. This file imports neither jax nor the JAX package, so on a
machine with a card and without jax it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerances as in ``chip_smoke.py``: float32 1e-4 (exp2 of log2(e)-scaled
logits and another summation order), bfloat16 2e-2 (bf16 output rounding).
"""
import pytest
import torch

from tartangan_torch.ops.attention import attention, attention_plain

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
