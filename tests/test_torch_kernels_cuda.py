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
import torch_threads  # noqa: F401  (this process's share of the cores)
import pytest
import torch

from tartangan_torch.ops.attention import (
    _bwd,
    _fwd,
    attention,
    attention_bwd,
    attention_bwd_plain,
    attention_lse_plain,
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (4, 4096, 1024, 8, 32),     # '512thin' generator, training
    (2, 200, 75, 5, 12),        # ragged Lq, Lk and Ck
    (1, 70, 5000, 64, 33),      # Lk past the TPU kernel's 4096 limit
])
def test_attention_kernel_lse_matches_plain(cuda, shape, dtype):
    """K1's lse (what K2 reads) against the plain forward's: both in f32
    from the same (bf16 or f32) inputs, so at the f32 tolerance."""
    b, lq, lk, ck, cv = shape
    gen = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (torch.randn(s, device=cuda, generator=gen).to(dtype)
               for s in ((b, lq, ck), (b, lk, ck), (b, lk, cv)))
    out, lse = _fwd(q, k, v, with_lse=True)
    torch.cuda.synchronize()
    assert lse.dtype == torch.float32 and lse.shape == (b, lq)
    torch.testing.assert_close(lse, attention_lse_plain(q, k),
                               **TOL[torch.float32])
    torch.testing.assert_close(out.float(), attention_plain(q, k, v).float(),
                               **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 1, 1024, 8, 32, 1),       # one query row
    (3, 257, 37, 8, 32, 1),       # Lq past a CTA's rows by one; Lk < a tile
    (2, 1000, 333, 8, 32, 1),     # ragged Lq and Lk
    (4, 1000, 1, 8, 32, 1),       # one key
    (2, 257, 333, 5, 3, 1),       # Ck 5, Cv 3: the 4-byte copies
    (1, 4096, 1024, 8, 32, 1),    # B 1 at the G shape: keys split over CTAs
    (1, 4096, 1024, 32, 128, 1),  # the same with '1024''s wide heads
    (8, 4096, 1024, 8, 32, 6),    # large logits: many lazy rescales
    (1, 4096, 1024, 8, 32, 6),    # the same with the keys split
    (3, 1000, 333, 7, 40, 6),     # the same, ragged
])
def test_attention_kernel_edges(cuda, shape, dtype):
    """K1's output and lse at the edges of its tiling and launch choices,
    and with large logits (q scaled), where rows rescale many times."""
    b, lq, lk, ck, cv, scale = shape
    gen = torch.Generator(device=cuda).manual_seed(8)
    q, k, v = (torch.randn(s, device=cuda, generator=gen).to(dtype)
               for s in ((b, lq, ck), (b, lk, ck), (b, lk, cv)))
    q = (q.float() * scale).to(dtype)
    before = attention.launches
    out, lse = _fwd(q, k, v, with_lse=True)
    served = attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.launches == before + 2
    assert out.dtype == dtype and out.shape == (b, lq, cv)
    ref = attention_plain(q, k, v).float()
    torch.testing.assert_close(out.float(), ref, **TOL[dtype])
    assert torch.equal(served, out)
    torch.testing.assert_close(lse, attention_lse_plain(q, k),
                               **TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("b", [64, 1])
def test_attention_kernel_is_deterministic(cuda, b):
    """No atomics: two launches at the G shape, and at B 1 where the keys
    are split over CTAs and merged, give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    q, k, v = (torch.randn(s, device=cuda, generator=gen)
               for s in ((b, 4096, 8), (b, 1024, 8), (b, 1024, 32)))
    first = _fwd(q, k, v, with_lse=True)
    second = _fwd(q, k, v, with_lse=True)
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


@pytest.mark.cuda
def test_parity_blocks_and_attention_do_not_sync(cuda, monkeypatch):
    """After a warm-up call, a forward and backward of the parity blocks
    (G on K3, the fused G block on K4/K5 with the identity shortcut and
    with a projection, D through both parity downsamplers and the packers)
    and of the attention (K1, K2) make no call that synchronizes the
    stream with the host, and no host-to-device copy."""
    from tartangan_torch.models.blocks import (
        FusedResidualGeneratorBlock,
        ParityResidualDiscriminatorBlock,
        ParityResidualGeneratorBlock,
    )
    from tartangan_torch.ops import gblock as G
    from tartangan_torch.ops import parity as P
    from tartangan_torch.ops.parity_conv import merged_tap_conv
    monkeypatch.setattr(P, "FUSED_G", True)
    torch.manual_seed(0)
    gen = torch.Generator(device=cuda).manual_seed(10)
    blocks = [(ParityResidualGeneratorBlock(16, 8), (2, 16, 8, 8)),
              (FusedResidualGeneratorBlock(16, 16), (2, 16, 4, 4)),
              (FusedResidualGeneratorBlock(16, 8), (2, 16, 4, 4)),
              (ParityResidualDiscriminatorBlock(
                  4, 8, accept_parity=True, emit_parity=True),
               (2, 16, 16, 16))]
    blocks = [(m.to(cuda), torch.randn(s, device=cuda, generator=gen)
               .requires_grad_()) for m, s in blocks]
    d_to_plain = ParityResidualDiscriminatorBlock(
        8, 16, accept_parity=True).to(cuda)
    qkv = [torch.randn(s, device=cuda, generator=gen).requires_grad_()
           for s in ((2, 64, 8), (2, 16, 8), (2, 16, 32))]
    counters = (attention, attention_bwd, merged_tap_conv, G.gblock_a,
                G.gblock_b)

    def run():
        outs = [m(x, train=True) for m, x in blocks]
        outs.append(d_to_plain(outs[-1], train=True))
        outs.append(attention(*qkv))
        sum(o.float().square().mean() for o in outs).backward()

    run()
    torch.cuda.synchronize()
    before = [f.launches for f in counters]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(counters, before)] == \
        [1, 1, 2, 2, 2]
    copies = [e.name for e in prof.events() if "HtoD" in e.name]
    assert not copies, copies


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
    (2, 33, 5, 3, 6),           # Lk under one key block, Cv not 4k
    (40, 4096, 1024, 8, 32),    # enough blocks for the 256-thread tiling
])
def test_attention_bwd_kernel_matches_plain(cuda, shape, dtype):
    """K2 fed from K1's (o, lse), as the train step runs it, and through
    the public ``attention_bwd`` (K1, then K2)."""
    b, lq, lk, ck, cv = shape
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v, do = (torch.randn(s, device=cuda, generator=gen).to(dtype)
                   for s in ((b, lq, ck), (b, lk, ck), (b, lk, cv),
                             (b, lq, cv)))
    refs = attention_bwd_plain(q, k, v, do)
    before = (attention.launches, attention_bwd.launches)
    o, lse = _fwd(q, k, v, with_lse=True)
    fed = _bwd(q, k, v, do, o, lse)
    public = attention_bwd(q, k, v, do)
    torch.cuda.synchronize()
    assert (attention.launches, attention_bwd.launches) == \
        (before[0] + 2, before[1] + 2)
    for out in (fed, public):
        for got, ref in zip(out, refs):
            assert got.dtype == dtype and got.shape == ref.shape
            scale = ref.float().abs().max()
            torch.testing.assert_close(got.float() / scale,
                                       ref.float() / scale, **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 1024, 256, 8, 32),
                                   (40, 2048, 1024, 8, 32),
                                   (3, 1000, 333, 7, 40)])
def test_attention_bwd_kernel_is_deterministic(cuda, shape):
    """No atomics: two launches on the same inputs give the same bits."""
    b, lq, lk, ck, cv = shape
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k, v, do = (torch.randn(s, device=cuda, generator=gen)
                   for s in ((b, lq, ck), (b, lk, ck), (b, lk, cv),
                             (b, lq, cv)))
    o, lse = _fwd(q, k, v, with_lse=True)
    first = _bwd(q, k, v, do, o, lse)
    second = _bwd(q, k, v, do, o, lse)
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


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
    q, k, v, do = (z(1, 8, 8, device=cuda), z(1, 4, 8, device=cuda),
                   z(1, 4, 16, device=cuda), z(1, 8, 16, device=cuda))
    with pytest.raises(ValueError, match="lse"):
        _bwd(q, k, v, do, do, z(1, 7, device=cuda))


# ------------------------------------------- K3, K4, K5 (parity forms)
# float32 against the plain versions, each error over the plain output's
# max-abs: K = 4*Ci products summed in another order than cuDNN's
TOL_PARITY = dict(rtol=0, atol=1e-4)


def _scaled_close(out, ref):
    scale = ref.abs().max()
    torch.testing.assert_close(out / scale, ref / scale, **TOL_PARITY)


def _k3_case(dev, mode, b, h, w, cin, cout, seed=3):
    gen = torch.Generator(device=dev).manual_seed(seed)
    ci = cin if mode == "up" else 4 * cin
    x = torch.randn(b, h, w, ci, device=dev, generator=gen)
    wt = 0.1 * torch.randn(cout, cin, 3, 3, device=dev, generator=gen)
    bias = torch.randn(cout, device=dev, generator=gen)
    return x, wt, bias


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["up", "full"])
@pytest.mark.parametrize("shape", [
    (2, 32, 32, 128, 64),   # '512thin' G block 3
    (2, 64, 64, 64, 32),    # '512thin' G block 5
    (2, 128, 128, 32, 16),  # '512thin' G block 6
    (2, 256, 256, 16, 8),   # '512thin' G block 7
    (2, 37, 19, 5, 7),      # ragged: both tile edges, cout % 4, partial chunk
    (3, 7, 7, 5, 7),        # smaller than one tile
    (1, 9, 11, 12, 100),    # co past one channel slice; 'up' partial chunk
    (1, 20, 33, 6, 12),     # 'full' cin 6: a partial chunk of 2
])
@pytest.mark.parametrize("with_bias", [False, True])
def test_parity_conv_kernel_matches_plain(cuda, mode, shape, with_bias):
    from tartangan_torch.ops.parity_conv import (
        fused_parity_conv_plain,
        merged_tap_conv,
    )
    b, h, w, cin, cout = shape
    x, wt, bias = _k3_case(cuda, mode, *shape)
    bias = bias if with_bias else None
    before = merged_tap_conv.launches
    out = merged_tap_conv(x, wt, cout, mode, bias=bias)
    torch.cuda.synchronize()
    assert merged_tap_conv.launches == before + 1
    assert out.shape == (b, h, w, 4 * cout)
    _scaled_close(out, fused_parity_conv_plain(x, wt, cout, mode, bias))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["up", "full"])
def test_parity_conv_kernel_is_deterministic(cuda, mode):
    """Two launches give bit-identical outputs: no atomics, one order."""
    from tartangan_torch.ops.parity_conv import merged_tap_conv
    x, wt, bias = _k3_case(cuda, mode, 2, 37, 19, 8, 16, seed=5)
    first = merged_tap_conv(x, wt, 16, mode, bias=bias)
    second = merged_tap_conv(x, wt, 16, mode, bias=bias)
    assert torch.equal(first, second)


def _gblock_case(dev, b, h, w, cin, cout, identity, seed=4,
                 dtype=torch.float32):
    """x, the block's parameters (``wp = bp = None`` for the identity) and
    bn1's moments, made on the card from a seed."""
    from tartangan_torch.ops import gblock as G
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(*s, device=dev, generator=gen)  # noqa: E731
    x = r(b, h, w, cin)
    p = {"w1": 0.05 * r(cout, cin, 3, 3), "w2": 0.05 * r(cout, cout, 3, 3),
         "b1": r(cout), "b2": r(cout), "s1": 1 + 0.1 * r(cin), "o1": r(cin),
         "s2": 1 + 0.1 * r(cout), "o2": r(cout), "wp": None, "bp": None}
    if not identity:
        p["wp"], p["bp"] = 0.05 * r(cin, cout), r(cout)
    p = {k: None if v is None else v.to(dtype) for k, v in p.items()}
    x = x.to(dtype)
    return x, p, G._moments(x)


def _gblock_run(G, x, p, m1, v1, kernels=True):
    """K4 then K5 (or their plain versions) as ``_fused_forward`` chains
    them: (y1p, sums, out_p)."""
    fa, fb = (G.gblock_a, G.gblock_b) if kernels else (G.gblock_a_plain,
                                                       G.gblock_b_plain)
    b, h, w, _ = x.shape
    cout = p["w1"].shape[0]
    y1p, sums = fa(x, m1, v1, p["s1"], p["o1"], p["w1"], p["b1"])
    s4 = sums.reshape(2, 4, cout).sum(1) / (4 * b * h * w)
    m2, v2 = s4[0], s4[1] - s4[0].square()
    out = fb(y1p, x, m2, v2, p["s2"], p["o2"], p["w2"], p["b2"], p["wp"],
             p["bp"])
    return y1p, sums, out


GBLOCK_CASES = [
    (64, 8, 8, 128, 128, True),     # '512thin' fused block 1, identity
    (64, 16, 16, 128, 128, True),   # '512thin' fused block 2, identity
    (8, 8, 8, 128, 128, False),     # the same width with a projection
    (4, 12, 12, 96, 40, False),     # Cin != Cout
    (2, 11, 13, 6, 6, True),        # ragged H, W; Cout 6 (no 16-byte loads)
    (3, 9, 19, 5, 7, False),        # ragged, Cin 5 -> Cout 7
    (1, 17, 10, 12, 200, False),    # Cout past three channel slices
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", GBLOCK_CASES)
def test_gblock_kernels_match_plain(cuda, case):
    """K4 (y1p and its sums) and K5 (out_p) against their plain versions,
    K5 fed the plain y1p and statistics."""
    from tartangan_torch.ops import gblock as G
    b, h, w, cin, cout, identity = case
    x, p, (m1, v1) = _gblock_case(cuda, *case)
    before = (G.gblock_a.launches, G.gblock_b.launches)
    y1p, sums = G.gblock_a(x, m1, v1, p["s1"], p["o1"], p["w1"], p["b1"])
    y1r, sumr = G.gblock_a_plain(x, m1, v1, p["s1"], p["o1"], p["w1"],
                                 p["b1"])
    assert y1p.shape == (b, h, w, 4 * cout) and sums.shape == (2, 4 * cout)
    for out, ref in ((y1p, y1r), (sums[0], sumr[0]), (sums[1], sumr[1])):
        _scaled_close(out, ref)
    n = 4 * b * h * w
    m2 = sumr.reshape(2, 4, cout).sum(1)[0] / n
    v2 = sumr.reshape(2, 4, cout).sum(1)[1] / n - m2.square()
    args = (y1r, x, m2, v2, p["s2"], p["o2"], p["w2"], p["b2"], p["wp"],
            p["bp"])
    out = G.gblock_b(*args)
    _scaled_close(out, G.gblock_b_plain(*args))
    torch.cuda.synchronize()
    assert (G.gblock_a.launches, G.gblock_b.launches) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [GBLOCK_CASES[1], GBLOCK_CASES[5]])
def test_gblock_kernels_are_deterministic(cuda, case):
    """No float atomics: two launches give the same bits for y1p, the sums
    and out_p."""
    from tartangan_torch.ops import gblock as G
    x, p, (m1, v1) = _gblock_case(cuda, *case, seed=6)
    first = _gblock_run(G, x, p, m1, v1)
    second = _gblock_run(G, x, p, m1, v1)
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


# each kernel's max error against its plain version in float64, over the
# float64 output's max-abs: 3xTF32 products (a ~2^-22 relative split
# error a product) and float32 accumulation over K = 4*Cin (K4) or 9*Cout
# (K5) terms
TOL_GBLOCK_F64 = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("case", GBLOCK_CASES[:2])
def test_gblock_kernels_error_against_float64(cuda, case):
    from tartangan_torch.ops import gblock as G
    x, p, (m1, v1) = _gblock_case(cuda, *case, seed=8)
    ours = _gblock_run(G, x, p, m1, v1)
    x64, p64, (m64, v64) = _gblock_case(cuda, *case, seed=8,
                                        dtype=torch.float64)
    refs = _gblock_run(G, x64, p64, m64, v64, kernels=False)
    for name, a, r in zip(("y1p", "sums", "out_p"), ours, refs):
        err = ((a.double() - r).abs().max() / r.abs().max()).item()
        assert err <= TOL_GBLOCK_F64, (name, err)


@pytest.mark.cuda
def test_gblock_kernels_reject_what_they_cannot_take(cuda):
    from tartangan_torch.ops import gblock as G
    x, p, (m1, v1) = _gblock_case(cuda, 2, 8, 8, 16, 16, True)
    args = (m1, v1, p["s1"], p["o1"], p["w1"], p["b1"])
    with pytest.raises(ValueError, match="contiguous"):
        G.gblock_a(x.transpose(1, 2), *args)
    with pytest.raises(TypeError):
        G.gblock_a(x.double(), *args)
    y1p, _ = G.gblock_a(x, *args)
    rest = (p["s2"], p["o2"], p["w2"], p["b2"])
    m2, v2 = p["b2"].abs(), 1 + p["b2"].abs()
    with pytest.raises(ValueError, match="contiguous"):
        G.gblock_b(y1p, x.transpose(1, 2), m2, v2, *rest, None, None)
    with pytest.raises(TypeError):
        G.gblock_b(y1p.double(), x, m2, v2, *rest, None, None)
    with pytest.raises(ValueError, match="both"):
        G.gblock_b(y1p, x, m2, v2, *rest, None, p["b2"])


@pytest.mark.cuda
def test_gblock_workspace_matches_the_kernels(cuda):
    """``ops/gblock.py::workspace_floats``, the mirror of the kernels' tile
    policy, against ``tt_gblock_workspace`` of the built library."""
    from tartangan_torch.ops import build
    from tartangan_torch.ops import gblock as G
    lib = build.load("gblock")
    for full in (False, True):
        for b, h, w, cin, cout in ((64, 8, 8, 128, 128), (64, 16, 16, 128, 128),
                                   (3, 9, 19, 5, 7), (1, 17, 10, 12, 200),
                                   (2, 1, 1, 3, 1)):
            assert lib.tt_gblock_workspace(int(full), b, h, w, cin, cout) == \
                G.workspace_floats(full, b, h, w, cin, cout)


# bfloat16 (``--dtype bf16``) against the plain versions, which round at the
# same points: where the float32 sums before a rounding differ in their last
# bits (another summation order), a value lands one bfloat16 ulp away; one
# ulp in the max-abs's binade is at most 2^-7 of the max-abs
TOL_PARITY_BF16 = dict(rtol=0, atol=2 ** -7)


def _scaled_close_bf16(out, ref):
    assert out.dtype == ref.dtype == torch.bfloat16
    scale = ref.float().abs().max()
    torch.testing.assert_close(out.float() / scale, ref.float() / scale,
                               **TOL_PARITY_BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["up", "full"])
@pytest.mark.parametrize("shape", [
    (2, 32, 32, 128, 64),   # '512thin' G block 3
    (2, 64, 64, 64, 32),    # '512thin' G block 5
    (2, 128, 128, 32, 16),  # '512thin' G block 6
    (2, 256, 256, 16, 8),   # '512thin' G block 7
    (2, 37, 19, 5, 7),      # ragged: one-channel copies, cout % 4
    (1, 9, 11, 12, 100),    # co past one channel slice
    (1, 20, 33, 6, 12),     # 'full' cin 6: a partial chunk of 2
])
def test_parity_conv_kernel_bf16_matches_plain(cuda, mode, shape):
    """K3 in bfloat16: bfloat16 in and out, float32 weights and bias."""
    from tartangan_torch.ops.parity_conv import (
        fused_parity_conv_plain,
        merged_tap_conv,
    )
    b, h, w, cin, cout = shape
    x, wt, bias = _k3_case(cuda, mode, *shape)
    x = x.bfloat16()
    before = merged_tap_conv.launches
    out = merged_tap_conv(x, wt, cout, mode, bias=bias)
    torch.cuda.synchronize()
    assert merged_tap_conv.launches == before + 1
    assert out.shape == (b, h, w, 4 * cout)
    _scaled_close_bf16(out, fused_parity_conv_plain(x, wt, cout, mode, bias))


@pytest.mark.cuda
@pytest.mark.parametrize("case", GBLOCK_CASES)
def test_gblock_kernels_bf16_match_plain(cuda, case):
    """K4 and K5 in bfloat16 against their plain versions (K5 fed the plain
    y1p and statistics); K4's sums are float32 and are the sums of the
    y1p it stored, after rounding (to float32 summation error)."""
    from tartangan_torch.ops import gblock as G
    b, h, w, cin, cout, _ = case
    x, p, _ = _gblock_case(cuda, *case)
    x = x.bfloat16()
    m1, v1 = G._moments(x)
    before = (G.gblock_a.launches, G.gblock_b.launches)
    y1p, sums = G.gblock_a(x, m1, v1, p["s1"], p["o1"], p["w1"], p["b1"])
    y1r, sumr = G.gblock_a_plain(x, m1, v1, p["s1"], p["o1"], p["w1"],
                                 p["b1"])
    assert y1p.dtype == torch.bfloat16 and sums.dtype == torch.float32
    _scaled_close_bf16(y1p, y1r)
    y = y1p.double().reshape(-1, 4 * cout)
    ref = torch.stack([y.sum(0), y.square().sum(0)])
    bound = 1e-5 * torch.stack([y.abs().sum(0), y.square().sum(0)]) + 1e-30
    assert ((sums.double() - ref).abs() <= bound).all()
    n = 4 * b * h * w
    m2 = sumr.reshape(2, 4, cout).sum(1)[0] / n
    v2 = sumr.reshape(2, 4, cout).sum(1)[1] / n - m2.square()
    args = (y1r, x, m2, v2, p["s2"], p["o2"], p["w2"], p["b2"], p["wp"],
            p["bp"])
    out = G.gblock_b(*args)
    assert out.dtype == torch.bfloat16
    _scaled_close_bf16(out, G.gblock_b_plain(*args))
    torch.cuda.synchronize()
    assert (G.gblock_a.launches, G.gblock_b.launches) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_parity_kernels_reject_other_dtypes(cuda):
    from tartangan_torch.ops.parity_conv import merged_tap_conv
    x = torch.zeros(1, 4, 4, 8, device=cuda, dtype=torch.bfloat16)
    w = torch.zeros(3, 8, 3, 3, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        merged_tap_conv(x, w, 3, "up")


# ------------------------------------------- K-step calls as CUDA graphs
def _graph_trainer(tmp_path, dtype, device_data):
    """'test128' (attention in G and D: K1, K2) with --parity-blocks on and
    FUSED_G (K3 in G's parity blocks), B 8, two steps a call, lazy R1 every
    2 steps, on a 24-image archive of 160 px (a crop per image)."""
    import numpy as np

    from tartangan_torch.ops import parity as P
    from tartangan_torch.train.cnn import CNNTrainer
    P.FUSED_G = True
    images = np.random.default_rng(0).integers(0, 256, (24, 160, 144, 3),
                                               dtype=np.uint8)
    np.save(tmp_path / "data.npy", images)
    trainer = CNNTrainer.create_from_cli([
        str(tmp_path / "data.npy"), "--config", "test128", "--batch-size",
        "8", "--epochs", "1", "--output", str(tmp_path / "out"), "--run-id",
        "g", "--dtype", dtype, "--quiet-logs", "--device", "cuda",
        "--parity-blocks", "on", "--steps-per-call", "2", "--r1-interval",
        "2", "--gen-freq", "100", *(["--device-data"] if device_data
                                     else [])])
    trainer.train()
    return trainer


def _chunk_inputs(trainer, device_data, gen):
    """One call's inputs (the device archive, or stacked random crops) and
    its draws, as the trainer makes them."""
    draws = trainer.chunk_draws(device_data)
    if device_data:
        return trainer._archive, draws
    k, b = trainer.steps_per_call, trainer.args.batch_size
    crops = torch.randint(0, 256, (k, b, 128, 128, 3), generator=gen,
                          device=trainer.device, dtype=torch.uint8)
    return crops, draws


def _run_call(state, fn, inputs, step0, draws, tensors, start):
    """The state put back at ``start``, one call through ``fn``; its
    metrics, the state by group and Adam's step counts (clones)."""
    with torch.no_grad():
        for t, s0 in zip(tensors, start):
            t.copy_(s0)
    metrics = fn(state, inputs, step0, **draws)
    return ({k: v.clone() for k, v in metrics.items()},
            {name: [t.detach().clone() for t in ts]
             for name, ts in _state_groups(state).items()},
            [o.state[p]["step"].clone() for o in (state.opt_g, state.opt_d)
             for p in o.state])


def _errors(run, ref, before):
    """``run`` against ``ref`` (each a ``_run_call``): the losses' largest
    relative error; each parameter group's error in the norm of its change
    from ``before`` over that norm; the other groups' max abs error over
    their max-abs."""
    errs = {"losses": max(float(((run[0][k] - ref[0][k]).abs()
                                 / ref[0][k].abs()).max()) for k in ref[0])}
    for name, group in ref[1].items():
        if name in before:
            norms = [float(torch.cat([(a - b).flatten().double() for a, b in
                                      zip(r, before[name])]).norm())
                     for r in (run[1][name], group)]
            errs[name] = abs(norms[0] - norms[1]) / (norms[1] or 1.0)
        else:
            scale = max(float(t.abs().max()) for t in group) or 1.0
            errs[name] = max(float((a - b).abs().max())
                             for a, b in zip(run[1][name], group)) / scale
    return errs


def _equal(a, b):
    return (all(torch.equal(a[0][k], b[0][k]) for k in b[0])
            and all(torch.equal(x, y) for k in b[1]
                    for x, y in zip(a[1][k], b[1][k]))
            and all(torch.equal(x, y) for x, y in zip(a[2], b[2])))


@pytest.mark.cuda
@pytest.mark.parametrize("device_data", [True, False],
                         ids=["broadcast", "scan"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_graph_replay_matches_eager(cuda, tmp_path, dtype, device_data):
    """The trainer's own K = 2 call (both R1 patterns; the second captured
    here, by the trainer's call) replayed against the same call run
    eagerly, from one state and one set of draws, as ``chip_smoke.py``'s
    ``hold_graph``. At the training rates: equal bit for bit, or else a
    second eager run differs from the first too and the losses and each
    parameter group's change (in norm, and it moved) are within 1e-2
    relative (float32's atomic sums differ from run to run, and Adam with
    beta1 = 0 moves a weight whose gradient is near 0 by +-lr on the sign
    of that noise). With both rates 0 (the device tensors the graph
    reads): losses 1e-4 relative, statistics, the EMA target and Adam's
    moments 1e-3 of each group's max-abs, and the losses farther than 1e-2
    from the trained call's. Adam's step counts equal throughout."""
    from tartangan_torch.ops.attention import attention
    from tartangan_torch.ops.parity_conv import merged_tap_conv
    from tartangan_torch.train.multi import GraphedChunk, state_tensors
    before = (attention.launches, merged_tap_conv.launches)
    trainer = _graph_trainer(tmp_path, dtype, device_data)
    assert isinstance(trainer._chunk_call, GraphedChunk)
    assert len(trainer._chunk_call.graphs) == 1  # the one call, steps 0-1
    assert attention.launches > before[0]
    assert merged_tap_conv.launches > before[1]
    state, own = trainer.state, trainer._chunk_call
    groups = [g for o in (state.opt_g, state.opt_d) for g in o.param_groups]
    rates = [float(g["lr"]) for g in groups]
    gen = torch.Generator(device=cuda).manual_seed(1)
    tensors = state_tensors(state)
    start = [t.detach().clone() for t in tensors]
    params = {name: [t.detach().clone() for t in ts]
              for name, ts in _state_groups(state).items()
              if name in ("g_target", "g params", "d params")}
    for step0 in (trainer.steps, trainer.steps + 1):
        inputs, draws = _chunk_inputs(trainer, device_data, gen)
        args = (inputs, step0, draws, tensors, start)
        graph = _run_call(state, own, *args)
        eager = _run_call(state, own.multi_step, *args)
        if not _equal(graph, eager):
            assert not _equal(_run_call(state, own.multi_step, *args), eager)
            errs = _errors(graph, eager, params)
            for name in ["losses", *params]:
                assert errs[name] <= 1e-2, (name, errs)
        for name in params:
            assert not all(torch.equal(a, b) for a, b in
                           zip(eager[1][name], params[name])), name
        assert all(torch.equal(a, b) for a, b in zip(graph[2], eager[2]))
        for group in groups:
            group["lr"].fill_(0.0)
        graph0 = _run_call(state, own, *args)
        eager0 = _run_call(state, own.multi_step, *args)
        for group, rate in zip(groups, rates):
            group["lr"].fill_(rate)
        torch.cuda.synchronize()
        for name in eager0[0]:
            torch.testing.assert_close(graph0[0][name], eager0[0][name],
                                       rtol=1e-4, atol=1e-6)
        errs0 = _errors(graph0, eager0, params)
        assert all(v <= 1e-3 for v in errs0.values()), errs0
        assert _errors(eager0, eager, {})["losses"] > 1e-2
        assert all(torch.equal(a, b) for a, b in zip(graph0[2], eager0[2]))
    assert len(own.graphs) == 2


def _state_groups(state):
    """Parameters, statistics and Adam's moments of G and D, and the EMA
    target's parameters, each a group compared at its own max-abs."""
    groups = {"g_target": list(state.g_target.parameters())}
    for name in ("g", "d"):
        m, opt = getattr(state, name), getattr(state, f"opt_{name}")
        groups[f"{name} params"] = list(m.parameters())
        groups[f"{name} stats"] = list(m.buffers())
        for key in ("exp_avg", "exp_avg_sq"):
            groups[f"{name} {key}"] = [opt.state[p][key]
                                       for p in m.parameters()]
    return groups


@pytest.mark.cuda
def test_graph_call_does_not_sync(cuda, tmp_path):
    """After its capture, a --device-data call (draws, replay, metrics)
    makes no host synchronization and no host-to-device copy."""
    trainer = _graph_trainer(tmp_path, "bf16", True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = trainer.train_batch(None)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(metrics["g_loss"]).all()


@pytest.mark.cuda
def test_failed_capture_raises(cuda):
    """A call whose step cannot be captured (a host readback) raises; it
    does not fall back to running eagerly."""
    from tartangan_torch.train.multi import GraphedChunk, chunk_train_step
    from tartangan_torch.train.state import GANTrainState

    lin = torch.nn.Linear(4, 4).to(cuda)
    opt = torch.optim.Adam(lin.parameters(), capturable=True)
    state = GANTrainState(g=lin, g_target=lin, d=lin, opt_g=opt, opt_d=opt)

    def step(state, batch):
        loss = state.g(batch).square().mean()
        return {"loss": loss, "host": torch.tensor(loss.item())}

    call = GraphedChunk(chunk_train_step(step, 2, "scan"))
    with pytest.raises(RuntimeError, match="capture"):
        call(state, torch.ones((2, 3, 4), device=cuda))


@pytest.mark.cuda
def test_capturable_adam_matches_plain(cuda):
    """``make_adam`` on CUDA parameters is capturable (the optimizer of
    every CUDA run); over 3 steps its parameters, moments and step counts
    equal torch's Adam with ``capturable=False`` (the form the CPU tests
    hold against optax) within a few float32 ulps, eagerly and replayed
    from a captured graph."""
    from tartangan_torch.train.common import make_adam
    gen = torch.Generator(device=cuda).manual_seed(0)
    shapes = [(64, 32, 3, 3), (64,), (256, 128)]
    base = [torch.randn(s, generator=gen, device=cuda) for s in shapes]
    grads = [[1e-3 * torch.randn(s, generator=gen, device=cuda)
              for s in shapes] for _ in range(3)]
    lr = 4e-4
    runs = []
    for mode in ("plain", "eager", "graph"):
        ps = [b.clone().requires_grad_() for b in base]
        if mode == "plain":
            opt = torch.optim.Adam(ps, lr=lr, betas=(0.0, 0.999), eps=1e-8,
                                   capturable=False)
        else:
            opt = make_adam(ps, lr)
            assert opt.defaults["capturable"]
        for p, g in zip(ps, grads[0]):
            p.grad = g.clone()
        if mode == "graph":
            opt.step()  # the state exists before the capture
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                opt.step()
            for gs in grads[1:]:
                for p, g in zip(ps, gs):
                    p.grad.copy_(g)
                graph.replay()
        else:
            opt.step()
            for gs in grads[1:]:
                for p, g in zip(ps, gs):
                    p.grad = g.clone()
                opt.step()
        torch.cuda.synchronize()
        runs.append([(p.detach(), opt.state[p]) for p in ps])
    for run in runs[1:]:
        for (p, st), (p0, st0) in zip(run, runs[0]):
            torch.testing.assert_close(p, p0, rtol=1e-6, atol=1e-3 * lr)
            for key in ("exp_avg", "exp_avg_sq"):
                torch.testing.assert_close(st[key], st0[key], rtol=1e-6,
                                           atol=0)
            assert float(st["step"]) == float(st0["step"]) == 3.0


def _kernels_under(event):
    """The device kernels launched inside a profiler CPU event."""
    names = [k.name for k in event.kernels]
    for child in event.cpu_children:
        names += _kernels_under(child)
    return names


@pytest.mark.cuda
def test_r1_d_update_matches_autograd_without_image_sized_filters(
        cuda, monkeypatch):
    """One bfloat16 D update with R1 of '512thin''s D at B 4: every
    parameter's gradient through ``ops/conv.py`` against plain autograd
    (``F.conv2d`` and ATen's own double backward), after dividing by the
    plain gradients' max-abs (a conv bias ahead of a train-mode BatchNorm
    has a rounding-noise gradient); one R1 weight term for each of D's 23
    2-D convs; and no ``aten::convolution`` of autograd's (C, B, H, W) form,
    a filter as wide as its input, so none of the "indexed" kernels cuDNN
    runs for it."""
    from torch.profiler import ProfilerActivity, profile

    from tartangan_torch.configs import GAN_CONFIGS
    from tartangan_torch.models import factories as MF
    from tartangan_torch.models import layers
    from tartangan_torch.models.attention import SelfAttention2d
    from tartangan_torch.models.losses import (
        bce_with_logits,
        r1_gradient_penalty,
    )
    from tartangan_torch.models.pluggan import Discriminator
    from tartangan_torch.ops import conv
    from tartangan_torch.train.common import bce_labels

    b = 4
    gen = torch.Generator(device=cuda).manual_seed(0)
    real, fake = (torch.rand(b, 3, 512, 512, device=cuda, generator=gen)
                  * 2 - 1 for _ in range(2))

    def update():
        torch.manual_seed(0)
        d = Discriminator(GAN_CONFIGS["512thin"],
                          input_factory=MF.d_input_factory(),
                          block_factory=MF.d_block_factory("bn", "relu"),
                          output_factory=MF.d_output_factory("bn", "relu"),
                          dtype=torch.bfloat16).to(cuda)
        for m in d.modules():
            if isinstance(m, SelfAttention2d):
                m.gamma.data.fill_(0.7)  # the attention counts
        before = conv.weight_term.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            gp, p_real = r1_gradient_penalty(d, real.clone().requires_grad_())
            loss = bce_with_logits(torch.cat([p_real, d(fake)], 0),
                                   bce_labels(b, device=cuda))
            (loss + 5.0 * gp).backward()
            torch.cuda.synchronize()
        forms = [e for e in prof.events() if e.name == "aten::convolution"
                 and e.input_shapes[1][2:] == e.input_shapes[0][2:]]
        return ([p.grad.float() for p in d.parameters()], forms,
                conv.weight_term.launches - before)

    ours, forms, terms = update()
    assert forms == [] and terms == 23
    monkeypatch.setattr(layers, "conv2d", torch.nn.functional.conv2d)
    ref, ref_forms, ref_terms = update()
    assert ref_forms and ref_terms == 0  # the form is there without it
    print("plain autograd's (C, B, H, W) convolutions ran",
          sorted({k for e in ref_forms for k in _kernels_under(e)}))
    scale = max(float(g.abs().max()) for g in ref)
    worst = max(float((a - r).abs().max()) for a, r in zip(ours, ref))
    print(f"largest gradient difference / max-abs: {worst / scale:.3e}")
    for a, r in zip(ours, ref):
        torch.testing.assert_close(a / scale, r / scale,
                                   **TOL[torch.bfloat16])


# ------------------------------------------------ BatchNorm (csrc/batch_norm.cu)
def _bn_case(dev, shape, dtype, offset=0, seed=5):
    """x, dy (``offset`` elements into their storage: not 16-byte aligned
    when odd), float32 w and b, and running statistics."""
    from math import prod
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = shape[1]
    x, dy = ((torch.randn(prod(shape) + offset, device=dev, generator=gen)
              * 1.5 + 0.3).to(dtype)[offset:].view(shape) for _ in range(2))
    w = torch.rand(c, device=dev, generator=gen) + 0.5
    b = torch.randn(c, device=dev, generator=gen)
    running = (torch.randn(c, device=dev, generator=gen),
               torch.rand(c, device=dev, generator=gen) + 0.5)
    return x, dy, w, b, running


def _sum_bound(terms, x):
    """Per channel, the sum of |terms|: what a float32 sum's rounding
    error scales with."""
    dims = [d for d in range(x.dim()) if d != 1]
    return terms.abs().float().sum(dims)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, offset", [
    ((64, 8, 512, 512), 0),     # the cells' 8-channel blocks at 512^2
    ((64, 16, 256, 256), 0),    # the 16-channel blocks at 256^2
    ((64, 128, 4, 4), 0),       # small planes: one run a channel
    ((3, 5, 7, 9), 0),          # a plane of 63: one value at a time
    ((2, 3, 1000), 1),          # NCL, not 16-byte aligned
    ((16, 5), 0),               # (B, C), IQN's
])
def test_batch_norm_kernels_match_plain(cuda, shape, offset, dtype):
    """The forward (y, mean, biased var, the running statistics) and the
    backward (dx, dw, db) against the plain versions on the same inputs.
    Tolerances: the statistics and dw, db are sums in another order (mean
    and var 1e-5 relative, dw and db 1e-5 of the sum of their terms'
    magnitudes); y and dx are float32 results of those statistics rounded
    once to x's dtype (1e-4 of dx's max-abs and of y, float32; one bf16 ulp,
    2**-7 relative, bfloat16)."""
    from tartangan_torch.ops import batch_norm as BN
    x, dy, w, b, running = _bn_case(cuda, shape, dtype, offset)
    ref_running = tuple(t.clone() for t in running)
    before = BN.batch_norm.launches
    y, mean, var, rstd = BN._forward_kernel(x, w, b, 1e-5, *running, 0.9)
    dx, dw, db = BN._backward_kernel(dy, x, w, mean, rstd)
    torch.cuda.synchronize()
    assert BN.batch_norm.launches == before + 2
    assert BN.batch_norm.launches_by_dtype[dtype] >= 2
    ref_y, ref_mean, ref_var, ref_rstd = BN.batch_norm_plain(
        x, w, b, 1e-5, ref_running, 0.9)
    ref_dx, ref_dw, ref_db = BN.batch_norm_backward_plain(
        dy, x, w, ref_mean, ref_rstd)
    stats = dict(rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(mean, ref_mean, **stats)
    torch.testing.assert_close(var, ref_var, **stats)
    torch.testing.assert_close(rstd, ref_rstd, **stats)
    for got, want in zip(running, ref_running):
        torch.testing.assert_close(got, want, **stats)
    rounded = (dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32
               else dict(rtol=2 ** -7, atol=1e-4))
    assert y.dtype == dx.dtype == dtype and y.is_contiguous()
    torch.testing.assert_close(y.float(), ref_y.float(), **rounded)
    scale = float(ref_dx.abs().max())
    torch.testing.assert_close(dx.float() / scale, ref_dx.float() / scale,
                               **rounded)
    xhat = (x.float() - ref_mean.view((1, -1) + (1,) * (x.dim() - 2))) \
        * ref_rstd.view((1, -1) + (1,) * (x.dim() - 2))
    for got, want, terms in ((db, ref_db, dy),
                             (dw, ref_dw, dy.float() * xhat)):
        assert ((got - want).abs() <= 1e-5 * _sum_bound(terms, x)
                + 1e-6).all(), (got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batch_norm_kernels_are_deterministic(cuda, dtype):
    """No atomics: two calls give the same bits."""
    from tartangan_torch.ops import batch_norm as BN
    x, dy, w, b, _ = _bn_case(cuda, (64, 16, 128, 128), dtype)
    runs = []
    for _ in range(2):
        y, mean, var, rstd = BN._forward_kernel(x, w, b, 1e-5, None, None,
                                                0.9)
        runs.append((y, mean, var, rstd)
                    + BN._backward_kernel(dy, x, w, mean, rstd))
    for a, b_ in zip(*runs):
        assert torch.equal(a, b_)


@pytest.mark.cuda
def test_batch_norm_kernels_reject_what_they_cannot_take(cuda):
    """A CUDA tensor the kernels cannot take raises, float64 too; a layer
    with ``use_kernel = False`` takes the plain version and launches
    nothing."""
    from tartangan_torch.models.layers import BatchNorm
    from tartangan_torch.ops import batch_norm as BN
    x, _, w, b, _ = _bn_case(cuda, (4, 3, 8, 8), torch.float32)
    with pytest.raises(TypeError):
        BN.batch_norm(x.half(), w, b)
    with pytest.raises(TypeError):
        BN.batch_norm(x, w.bfloat16(), b)
    with pytest.raises(ValueError):
        BN.batch_norm(x[0, 0, 0], w[:8], b[:8])
    with pytest.raises(ValueError):
        BN.batch_norm(x, w[:2], b[:2])
    with pytest.raises(TypeError):
        BN.batch_norm(x.double(), w, b)
    with pytest.raises(TypeError):
        BN.batch_norm(x.double().requires_grad_(), w.double(), b.double())
    bn = BatchNorm(3).to(cuda).double()
    with pytest.raises(TypeError):
        bn(x.double())
    bn.use_kernel = False
    before = BN.batch_norm.launches
    y = bn(x.double())
    assert y.dtype == torch.float64 and BN.batch_norm.launches == before


@pytest.mark.cuda
def test_batch_norm_export_records_the_op(cuda):
    """Outside autograd the layer's forward is the custom op
    ``tartangan::batch_norm``, which ``torch.export`` records by name and
    which runs the kernels."""
    from tartangan_torch.models.layers import BatchNorm
    from tartangan_torch.ops import batch_norm as BN
    bn = BatchNorm(3).to(cuda).requires_grad_(False)
    x, _, _, _, _ = _bn_case(cuda, (4, 3, 16, 16), torch.bfloat16)
    program = torch.export.export(bn, (x,))
    assert "tartangan.batch_norm" in str(program.graph)
    before = BN.batch_norm.launches
    torch.testing.assert_close(program.module()(x), bn(x), rtol=0, atol=0)
    assert BN.batch_norm.launches == before + 2


def _thin_models(dev, dtype=torch.bfloat16):
    """'512thin''s G and D as the trainer builds them (--dtype ``dtype``, the
    CLI's defaults), attention's gamma 0.7 so that it counts."""
    from tartangan_torch.configs import GAN_CONFIGS
    from tartangan_torch.models import factories as MF
    from tartangan_torch.models.attention import SelfAttention2d
    from tartangan_torch.models.pluggan import Discriminator, Generator
    torch.manual_seed(0)
    cfg = GAN_CONFIGS["512thin"]
    g = Generator(cfg, input_factory=MF.g_input_factory("mlp", "relu"),
                  block_factory=MF.g_block_factory("bn", "relu"),
                  output_factory=MF.g_output_factory("bn", "relu"),
                  dtype=dtype).to(dev)
    d = Discriminator(cfg, input_factory=MF.d_input_factory(),
                      block_factory=MF.d_block_factory("bn", "relu"),
                      output_factory=MF.d_output_factory("bn", "relu"),
                      dtype=dtype).to(dev)
    for m in list(g.modules()) + list(d.modules()):
        if isinstance(m, SelfAttention2d):
            m.gamma.data.fill_(0.7)
    return cfg, g, d


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_r1_d_update_batch_norm_kernels_match_plain(cuda, dtype):
    """One D update with R1 of '512thin''s D at B 4 through the BatchNorm
    kernels (R1's second-order terms through ``_BatchNormBackward``) and
    the same update on the plain version (``use_kernel = False``: casts,
    ``F.batch_norm`` and ATen's double backward), in ``dtype``, each
    against the plain update in float64: every parameter's gradient and
    running statistic, after dividing by the float64 values' max-abs. The
    kernels' largest error is at most 1.5 times the plain version's: not a
    tolerance on their
    difference, since the gradient of a conv bias ahead of a train-mode
    BatchNorm, 0 in exact arithmetic, is rounding noise that two orders of
    rounding do not share (in bf16 the two read 4.5e-2 of the max-abs
    apart on an H100)."""
    from tartangan_torch.models import layers
    from tartangan_torch.models.attention import SelfAttention2d
    from tartangan_torch.models.losses import (
        bce_with_logits,
        r1_gradient_penalty,
    )
    from tartangan_torch.ops import batch_norm as BN
    from tartangan_torch.train.common import bce_labels

    b = 4
    gen = torch.Generator(device=cuda).manual_seed(0)
    real, fake = (torch.rand(b, 3, 512, 512, device=cuda, generator=gen)
                  * 2 - 1 for _ in range(2))

    def update(dt, use_kernel=True):
        _, _, d = _thin_models(cuda, dt)
        if dt == torch.float64:  # K1/K2 and BatchNorm's take f32 and bf16
            d.double()
            use_kernel = False
        for m in d.modules():
            if isinstance(m, layers.BatchNorm) or (
                    dt == torch.float64 and isinstance(m, SelfAttention2d)):
                m.use_kernel = use_kernel
        before = BN.batch_norm.launches
        with layers.update_batch_stats(d):
            gp, p_real = r1_gradient_penalty(
                d, real.to(dt).requires_grad_())
            loss = bce_with_logits(torch.cat([p_real, d(fake.to(dt))], 0),
                                   bce_labels(b, device=cuda))
        (loss + 5.0 * gp).backward()
        torch.cuda.synchronize()
        stats = [t for m in d.modules() if isinstance(m, layers.BatchNorm)
                 for t in (m.running_mean, m.running_var)]
        return ([p.grad.double() for p in d.parameters()],
                [t.double() for t in stats], BN.batch_norm.launches - before)

    ours = update(dtype)
    plain, exact = update(dtype, False), update(torch.float64)
    assert ours[2] > 0 and plain[2] == exact[2] == 0

    def error(run, i):
        scale = max(float(t.abs().max()) for t in exact[i])
        return max(float((a - e).abs().max()) for a, e
                   in zip(run[i], exact[i])) / scale
    for i, what in enumerate(("gradient", "running statistic")):
        print(f"largest {what} error / max-abs against float64: kernels "
              f"{error(ours, i):.3e}, plain {error(plain, i):.3e}")
        assert error(ours, i) <= 1.5 * error(plain, i)


@pytest.mark.cuda
def test_thin_step_batch_norm_launches(cuda):
    """One bfloat16 '512thin' step with R1 (``gan_update``) at B 4: every
    train-mode BatchNorm of G and D runs the kernels, forward and backward:
    G twice forward (the D update's no-grad forward and the G update) and
    once backward; D three times forward (reals with R1, fakes, the G
    update) and four times backward (R1's gradient and the loss on the
    reals, the fakes, the G update)."""
    from tartangan_torch.models.layers import BatchNorm
    from tartangan_torch.ops import batch_norm as BN
    from tartangan_torch.train.cnn import gan_update
    from tartangan_torch.train.common import make_adam
    from tartangan_torch.train.state import GANTrainState

    cfg, g, d = _thin_models(cuda)
    _, g_target, _ = _thin_models(cuda)
    state = GANTrainState(g=g, g_target=g_target.requires_grad_(False), d=d,
                          opt_g=make_adam(g.parameters(), 1e-4),
                          opt_d=make_adam(d.parameters(), 4e-4))
    n_g, n_d = (sum(type(m) is BatchNorm for m in net.modules())
                for net in (g, d))
    assert n_g > 0 and n_d > 0
    b = 4
    gen = torch.Generator(device=cuda).manual_seed(1)
    real = torch.rand(b, 3, 512, 512, device=cuda, generator=gen) * 2 - 1
    z_d, z_g = (torch.randn(s, device=cuda, generator=gen)
                for s in ((1, b, cfg.latent_dims), (b, cfg.latent_dims)))
    before = dict(BN.batch_norm.launches_by_dtype)
    metrics = gan_update(state, real, z_d, z_g, gp_weight=5.0,
                         ema_factor=1e-3)
    torch.cuda.synchronize()
    launches = (BN.batch_norm.launches_by_dtype[torch.bfloat16]
                - before.get(torch.bfloat16, 0))
    print(f"BatchNorm: {n_g} in G, {n_d} in D; {launches} launches a step")
    assert launches == 3 * n_g + 7 * n_d
    assert all(torch.isfinite(v) for v in metrics.values())
