"""The port's attention (``tartangan_torch/ops/attention.py``,
``models/attention.py``) against the JAX package on the same inputs.

Inputs come from numpy with a seed. Tolerances: float32 1e-5 (the two
sides differ only in summation order); bfloat16 outputs compare at 2e-2,
about two bf16 ulps near 1, since the two frameworks round the bf16 matmul
operands and outputs at slightly different points.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tartangan_tpu.models.attention import SelfAttention2d as JaxSelfAttention2d
from tartangan_tpu.models.attention import _attention as jax_attention
from tartangan_tpu.ops.pallas.attention import _fused_attention_fwd_impl
from tartangan_torch.convert import from_flax
from tartangan_torch.models.attention import SelfAttention2d
from tartangan_torch.ops.attention import attention, attention_plain

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
