"""The port's attention (``tartangan_torch/ops/attention.py``,
``models/attention.py``) against the JAX package on the same inputs.

Inputs come from numpy with a seed. Tolerances: float32 1e-5 (the two
sides differ only in summation order); bfloat16 outputs compare at 2e-2,
about two bf16 ulps near 1, since the two frameworks round the bf16 matmul
operands and outputs at slightly different points. Gradients compare after
dividing by their max-abs, as tests/test_attention.py does (a sum over Lq
or Lk terms grows with the length).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tartangan_tpu.models.attention import SelfAttention2d as JaxSelfAttention2d
from tartangan_tpu.models.attention import _attention as jax_attention
from tartangan_tpu.ops.pallas.attention import (
    _attn_bwd_impl,
    _fused_attention_bwd_xla,
    _fused_attention_fwd_impl,
)
from tartangan_torch.convert import from_flax
from tartangan_torch.models.attention import SelfAttention2d
from tartangan_torch.ops.attention import (
    attention,
    attention_bwd,
    attention_bwd_from_stats_plain,
    attention_bwd_plain,
    attention_lse_plain,
    attention_plain,
)

# (B, Lq, Lk, Ck, Cv): the '512thin' generator's layer at B = 1, and a
# ragged shape (neither length a multiple of a kernel tile)
SHAPES = [(1, 4096, 1024, 8, 32), (2, 200, 75, 5, 12)]
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _qkv(rng, shape):
    b, lq, lk, ck, cv = shape
    return (rng.standard_normal((b, lq, ck)).astype(np.float32),
            rng.standard_normal((b, lk, ck)).astype(np.float32),
            rng.standard_normal((b, lk, cv)).astype(np.float32))


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_kernel_interpret(rng, shape, dtype):
    """attention_plain against the Pallas kernel body run in interpret mode,
    as tests/test_attention.py runs it."""
    q, k, v = _qkv(rng, shape)
    jdt = getattr(jnp, dtype)
    ref = _fused_attention_fwd_impl(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                                    jnp.asarray(v, jdt), interpret=True)
    ours = attention_plain(*(_torch(x, dtype) for x in (q, k, v)))
    assert ours.dtype == getattr(torch, dtype)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(_np(ours), np.asarray(ref, np.float32),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_xla_attention(rng, shape, dtype):
    """attention_plain against the JAX module's plain path
    (``_attention(..., use_pallas=False)``)."""
    q, k, v = _qkv(rng, shape)
    jdt = getattr(jnp, dtype)
    ref = jax_attention(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                        jnp.asarray(v, jdt), use_pallas=False)
    ours = attention_plain(*(_torch(x, dtype) for x in (q, k, v)))
    np.testing.assert_allclose(_np(ours), np.asarray(ref, np.float32),
                               **TOL[dtype])


def test_wrapper_takes_plain_version_on_cpu(rng):
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, SHAPES[1]))
    before = attention.launches
    out = attention(q, k, v)
    assert attention.launches == before  # no kernel on the CPU
    torch.testing.assert_close(out, attention_plain(q, k, v), rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["rank", "batch", "ck", "lk", "dtype",
                                 "mixed_dtype", "empty"])
def test_wrapper_rejects_bad_inputs(bad):
    q, k, v = torch.zeros(2, 8, 4), torch.zeros(2, 6, 4), torch.zeros(2, 6, 3)
    if bad == "rank":
        q = q[0]
    elif bad == "batch":
        k, v = k[:1], v[:1]
    elif bad == "ck":
        k = torch.zeros(2, 6, 5)
    elif bad == "lk":
        v = torch.zeros(2, 7, 3)
    elif bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "mixed_dtype":
        v = v.bfloat16()
    elif bad == "empty":
        q = torch.zeros(2, 0, 4)
    with pytest.raises((ValueError, TypeError)):
        attention(q, k, v)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_self_attention_matches_jax(rng, use_kernel):
    """SelfAttention2d with gamma != 0 on weights carried over from flax."""
    c = 32
    x = rng.standard_normal((2, 16, 16, c)).astype(np.float32)
    mod = JaxSelfAttention2d(c, use_pallas=False)
    params = jax.device_get(
        mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    params["gamma"] = np.float32(0.7)
    ref = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))

    ours = SelfAttention2d(c, use_kernel=use_kernel)
    ours.load_state_dict(from_flax({"params": params}))
    with torch.no_grad():
        out = ours(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 1), ref,
                               rtol=1e-5, atol=1e-5)
    # the attention path reaches the output
    assert np.abs(ref - x).max() > 1e-2


def _scaled_close(ours, ref, tol):
    ref = np.asarray(ref, np.float32)
    scale = max(float(np.abs(ref).max()), 1e-12)
    np.testing.assert_allclose(_np(ours) / scale, ref / scale, **tol)


# the '512thin' generator's training shape at B = 1 (the Pallas backward
# needs Lq to be a multiple of its tile), and a ragged one for the XLA form
BWD_SHAPES = [(1, 4096, 1024, 8, 32), (2, 200, 75, 5, 12)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_bwd_plain_matches_jax(rng, shape, dtype):
    """attention_bwd_plain against ``_fused_attention_bwd_xla`` and, where
    the Pallas kernel takes the shape, ``_attn_bwd_impl`` in interpret
    mode (as tests/test_attention.py runs it)."""
    q, k, v = _qkv(rng, shape)
    do = rng.standard_normal(shape[:2] + (shape[4],)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    jargs = [jnp.asarray(x, jdt) for x in (q, k, v, do)]
    ours = attention_bwd_plain(*(_torch(x, dtype) for x in (q, k, v, do)))
    refs = [_fused_attention_bwd_xla(*jargs)]
    if shape[1] % 512 == 0:
        refs.append(_attn_bwd_impl(*jargs, interpret=True))
    for ref in refs:
        for a, b in zip(ours, ref):
            assert a.dtype == getattr(torch, dtype) and a.shape == b.shape
            _scaled_close(a, b, TOL[dtype])


@pytest.mark.parametrize("order", [1, 2])
def test_functions_match_autograd_through_plain(rng, order):
    """The two autograd Functions (forward, backward and the backward's
    vector-Jacobian product) give the gradients of autograd through
    ``attention_plain``, to second order, w.r.t. q, k and v."""
    shape = (2, 40, 24, 5, 6)

    def grads(fn):
        q, k, v = (torch.from_numpy(x).requires_grad_()
                   for x in _qkv(np.random.default_rng(1), shape))
        o = fn(q, k, v)
        w = torch.from_numpy(rng_w.standard_normal(o.shape).astype(np.float32))
        g = torch.autograd.grad((o * w).sum(), (q, k, v),
                                create_graph=order > 1)
        if order == 2:
            g = torch.autograd.grad(sum(x.square().sum() for x in g),
                                    (q, k, v))
        return g

    rng_w = np.random.default_rng(2)
    ours = grads(attention)
    rng_w = np.random.default_rng(2)
    ref = grads(attention_plain)
    for a, b in zip(ours, ref):
        _scaled_close(a.detach(), b.numpy(), dict(rtol=1e-5, atol=1e-5))


def test_bwd_wrapper_takes_plain_version_on_cpu(rng):
    """On the CPU ``attention_bwd`` runs K1's and K2's plain versions: the
    plain forward for (o, lse), then K2's math from them, bit for bit;
    which is the closed form within f32 rounding."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, SHAPES[1]))
    do = torch.randn(q.shape[0], q.shape[1], v.shape[2])
    before = (attention.launches, attention_bwd.launches)
    out = attention_bwd(q, k, v, do)
    assert (attention.launches, attention_bwd.launches) == before
    stats = (attention_plain(q, k, v), attention_lse_plain(q, k))
    for a, b, c in zip(out, attention_bwd_from_stats_plain(q, k, v, do, *stats),
                       attention_bwd_plain(q, k, v, do)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        _scaled_close(a, c.numpy(), TOL["float32"])
    with pytest.raises(ValueError):
        attention_bwd(q, k, v, do[:, :-1])


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_lse_matches_numpy_logsumexp(rng, shape):
    """The plain forward's lse (what K1 stores for K2): each row's
    log-sum-exp of q k^T, times log2(e), in f32."""
    q, k, _ = _qkv(rng, shape)
    logits = np.einsum("bqc,bkc->bqk", q.astype(np.float64),
                       k.astype(np.float64))
    m = logits.max(-1, keepdims=True)
    ref = (m[..., 0] + np.log(np.exp(logits - m).sum(-1))) / np.log(2.0)
    lse = attention_lse_plain(torch.from_numpy(q), torch.from_numpy(k))
    assert lse.dtype == torch.float32 and lse.shape == shape[:2]
    np.testing.assert_allclose(lse.numpy(), ref, **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_bwd_from_stats_plain_matches_jax(rng, shape, dtype):
    """K2's math in plain torch (p from the forward's lse, delta = do . o)
    on the plain forward's (o, lse) against ``attention_bwd_plain``,
    ``_fused_attention_bwd_xla`` and, where the Pallas kernel takes the
    shape, ``_attn_bwd_impl`` in interpret mode, on one set of numpy
    inputs. In bfloat16, o is rounded to bf16 before delta = do . o."""
    q, k, v = _qkv(rng, shape)
    do = rng.standard_normal(shape[:2] + (shape[4],)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    jargs = [jnp.asarray(x, jdt) for x in (q, k, v, do)]
    tq, tk, tv, tdo = (_torch(x, dtype) for x in (q, k, v, do))
    o, lse = attention_plain(tq, tk, tv), attention_lse_plain(tq, tk)
    ours = attention_bwd_from_stats_plain(tq, tk, tv, tdo, o, lse)
    refs = [attention_bwd_plain(tq, tk, tv, tdo),
            _fused_attention_bwd_xla(*jargs)]
    if shape[1] % 512 == 0:
        refs.append(_attn_bwd_impl(*jargs, interpret=True))
    for ref in refs:
        for a, b in zip(ours, ref):
            assert a.dtype == getattr(torch, dtype) and a.shape == b.shape
            b = b.float() if isinstance(b, torch.Tensor) else b
            _scaled_close(a, b, TOL[dtype])


def test_attention_function_saves_o_and_lse(rng):
    """Under autograd the forward saves (q, k, v, o, lse) for the backward,
    lse the plain forward's; outside it (grad off, as when serving) no
    Function runs."""
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _qkv(rng, SHAPES[1]))
    o = attention(q, k, v)
    saved = o.grad_fn.saved_tensors
    assert len(saved) == 5
    torch.testing.assert_close(saved[3], o, rtol=0, atol=0)
    torch.testing.assert_close(saved[4], attention_lse_plain(q, k),
                               rtol=0, atol=0)
    with torch.no_grad():
        assert attention(q, k, v).grad_fn is None
