"""The port's evaluation stack (``tartangan_torch/{models/inception,eval}``)
against the JAX package's, on the CPU.

The Inception network is held to the JAX package's template draws bit for
bit, to its committed forward fixture (``inception_port_expected.npz``,
the JAX Inception's pool and logits under the torchvision-schema fixture
weights) within that test's 2e-4, and block by block to the flax modules
on the same weights at a small size within 1e-5 of the max-abs. No JAX
Inception is compiled at 299x299. The resize and pools match the JAX ops
within 1e-6, the float32 Newton-Schulz FID the JAX one within 1e-4
relative and scipy within 1e-3, and the float64 host math (the fallback
FID, IS) the JAX functions within 1e-12.
"""
import torch_threads  # noqa: F401  (this process's share of the cores)
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_inception_weights import _input_image, synthetic_state_dict

import tartangan_tpu.eval.fid as jfid
import tartangan_tpu.eval.inception as jinc
import tartangan_tpu.models.inception as jm
import tartangan_tpu.ops.resize as jresize
from tartangan_torch.eval import fid, moments, port_weights
from tartangan_torch.eval.inception import (
    InceptionWrapper,
    accumulate_activations,
)
from tartangan_torch.models import inception as m
from tartangan_torch.ops import resize

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
EXPECTED = os.path.join(FIXTURES, "inception_port_expected.npz")
CALIBRATED = os.path.join(FIXTURES, "inception_calibrated.npz")


@pytest.fixture(scope="module")
def jax_template():
    return jm.init_inception()


@pytest.fixture(scope="module")
def fixture_state_dict(jax_template):
    """The JAX tests' crc32-keyed torchvision-schema weights."""
    return synthetic_state_dict(jax_template[1])


def _flat(variables):
    return flax.traverse_util.flatten_dict(variables, sep=".")


def _assert_model_equals_flax(model, variables):
    flat = _flat(variables)
    keys = m.torch_key_map(model)
    assert list(keys) == list(flat)
    state = model.state_dict()
    for flax_key, torch_key in keys.items():
        np.testing.assert_array_equal(
            m.to_flax_layout(state[torch_key].numpy()),
            np.asarray(flat[flax_key]), err_msg=flax_key)


def test_init_inception_draws_the_jax_template(jax_template):
    """Same leaves, same order, same bits: inception_calibrated.npz holds
    statistics calibrated for exactly these draws."""
    _assert_model_equals_flax(m.init_inception(0), jax_template[1])


def test_forward_reproduces_the_jax_fixture(fixture_state_dict):
    model = m.port_torch_state_dict(m.init_inception(), fixture_state_dict)
    x = torch.from_numpy(_input_image().transpose(0, 3, 1, 2))
    with torch.no_grad():
        pool, logits = model(x)
    expected = np.load(EXPECTED)
    np.testing.assert_allclose(pool.numpy(), expected["pool"],
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(logits.numpy(), expected["logits"],
                               rtol=2e-4, atol=2e-4)


# (flax block, port block, NHWC input shape)
BLOCKS = {
    "BasicConv2d": (lambda: jm.BasicConv2d(24, (1, 7), padding=(0, 3)),
                    lambda: m.BasicConv2d(16, 24, (1, 7), padding=(0, 3)),
                    (2, 9, 9, 16)),
    "InceptionA": (lambda: jm.InceptionA(32), lambda: m.InceptionA(192, 32),
                   (2, 17, 17, 192)),
    "InceptionB": (jm.InceptionB, lambda: m.InceptionB(288),
                   (2, 17, 17, 288)),
    "InceptionC": (lambda: jm.InceptionC(128), lambda: m.InceptionC(768, 128),
                   (2, 9, 9, 768)),
    "InceptionD": (jm.InceptionD, lambda: m.InceptionD(768),
                   (2, 17, 17, 768)),
    "InceptionE": (jm.InceptionE, lambda: m.InceptionE(1280),
                   (2, 8, 8, 1280)),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_flax(name):
    """Each block on the same transplanted weights (BatchNorm vectors
    drawn away from their (1, 0) init) and input, 1e-5 of the max-abs."""
    make_flax, make_port, shape = BLOCKS[name]
    rng = np.random.default_rng(3)
    x = rng.normal(0.0, 1.0, shape).astype(np.float32)
    block = make_flax()
    variables = jax.tree_util.tree_map(
        np.asarray, block.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    flat = {}
    for key, val in _flat(variables).items():
        leaf = key.split(".")[-1]
        if leaf in ("scale", "var"):
            val = rng.uniform(0.5, 1.5, val.shape)
        elif leaf in ("bias", "mean"):
            val = rng.normal(0.0, 0.1, val.shape)
        flat[key] = np.asarray(val, np.float32)
    variables = flax.traverse_util.unflatten_dict(flat, sep=".")
    ref = np.asarray(block.apply(variables, jnp.asarray(x)))

    port = m.load_flax_variables(make_port(), flat)
    _assert_model_equals_flax(port, variables)
    with torch.no_grad():
        out = port(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    out = out.numpy().transpose(0, 2, 3, 1)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


def test_load_weights_npz_matches_jax(tmp_path, jax_template,
                                      fixture_state_dict):
    """A full npz written by the JAX package's save_weights_npz, and the
    stats-only calibrated archive over the seed-0 template, load to the
    JAX load's values; an npz of other keys is refused."""
    _, template = jax_template
    full = tmp_path / "full.npz"
    jm.save_weights_npz(jm.port_torch_state_dict(template, fixture_state_dict),
                        str(full))
    _assert_model_equals_flax(m.load_weights_npz(m.init_inception(), full),
                              jm.load_weights_npz(template, str(full)))
    _assert_model_equals_flax(
        m.load_weights_npz(m.init_inception(), CALIBRATED),
        jm.load_weights_npz(template, CALIBRATED))

    bad = tmp_path / "bad.npz"
    np.savez(bad, foo=np.zeros(3))
    with pytest.raises(KeyError):
        m.load_weights_npz(m.init_inception(), bad)


def test_wrapper_takes_weights_by_argument_and_environment(
        tmp_path, monkeypatch, fixture_state_dict):
    npz = tmp_path / "weights.npz"
    m.save_weights_npz(
        m.port_torch_state_dict(m.init_inception(), fixture_state_dict), npz)
    img = torch.from_numpy(_input_image().transpose(0, 3, 1, 2))
    by_arg = InceptionWrapper(weights=str(npz), device="cpu")
    monkeypatch.setenv(m.WEIGHTS_ENV_VAR, str(npz))
    by_env = InceptionWrapper(device="cpu")
    assert by_arg.pretrained and by_env.pretrained
    pool_arg, probs_arg = by_arg(img)
    pool_env, _ = by_env(img)
    torch.testing.assert_close(pool_arg, pool_env, rtol=0, atol=0)
    assert torch.isfinite(pool_arg).all()
    np.testing.assert_allclose(float(probs_arg.sum()), 1.0, rtol=1e-4)


@pytest.mark.parametrize("case", ["resize16", "resize512", "max_pool",
                                  "avg_pool_3x3_s1"])
def test_resize_and_pools_match_jax(case):
    rng = np.random.default_rng(5)
    size = {"resize16": 16, "resize512": 512}.get(case, 35)
    x = rng.normal(0.0, 1.0, (2, size, size, 3)).astype(np.float32)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2))
    if case.startswith("resize"):
        ref = jresize.resize_bilinear(jnp.asarray(x), 299, 299, True)
        out = resize.resize_bilinear(xt, 299, 299, True)
    elif case == "max_pool":
        ref = jresize.max_pool(jnp.asarray(x), 3, 2)
        out = resize.max_pool(xt, 3, 2)
    else:
        ref = jm._avg_pool_3x3_s1(jnp.asarray(x))
        out = m._avg_pool_3x3_s1(xt)
    ref = np.asarray(ref)
    out = out.numpy().transpose(0, 2, 3, 1)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def _random_cov(rng, dim):
    a = rng.standard_normal((dim, dim)).astype(np.float32)
    return a @ a.T / dim + np.eye(dim, dtype=np.float32)


@pytest.mark.parametrize("dim", [16, 64])
def test_newton_schulz_and_frechet_match_jax_and_scipy(dim):
    from scipy import linalg
    rng = np.random.default_rng(dim)
    a = _random_cov(rng, dim)
    ours = fid.sqrt_newton_schulz(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(
        ours, np.asarray(jfid.sqrt_newton_schulz(jnp.asarray(a))),
        rtol=1e-4, atol=1e-4 * np.abs(ours).max())
    np.testing.assert_allclose(
        ours, np.real(linalg.sqrtm(a.astype(np.float64))),
        rtol=1e-3, atol=1e-3)

    mu1, mu2 = (rng.standard_normal(dim).astype(np.float32) for _ in "ab")
    s1, s2 = _random_cov(rng, dim), _random_cov(rng, dim)
    d = float(fid.frechet_distance(*map(torch.from_numpy, (mu1, s1, mu2, s2))))
    d_jax = float(jfid.frechet_distance(*map(jnp.asarray, (mu1, s1, mu2, s2))))
    assert abs(d - d_jax) <= 1e-4 * abs(d_jax)
    s1_64, s2_64 = s1.astype(np.float64), s2.astype(np.float64)
    d_scipy = (float(np.sum((mu1 - mu2).astype(np.float64) ** 2))
               + np.trace(s1_64) + np.trace(s2_64)
               - 2 * np.trace(np.real(linalg.sqrtm(s1_64 @ s2_64))))
    assert abs(d - d_scipy) <= 1e-3 * abs(d_scipy)


def test_host_fid_and_inception_score_match_jax():
    rng = np.random.default_rng(1)
    dim = 32
    mu1, mu2 = rng.normal(0, 1, dim), rng.normal(0, 1, dim)
    a = rng.normal(0, 1, (12, dim))  # rank 12 of 32: the eps retry fires
    s1, s2 = a.T @ a / 12, _random_cov(rng, dim).astype(np.float64)
    for args in ((mu1, s1, mu2, s2), (mu1, s2, mu2, s2 * 1.5)):
        ours = fid.numpy_frechet_distance(*args)
        ref = jfid.numpy_frechet_distance(*args)
        assert abs(ours - ref) <= 1e-12 * max(abs(ref), 1.0)
    probs = rng.random((100, 10))
    probs /= probs.sum(axis=1, keepdims=True)
    probs[:7] = np.eye(10)[:7]  # saturated rows: floored, no nan
    ours = fid.inception_score(probs, num_splits=5)
    ref = jfid.inception_score(probs, num_splits=5)
    np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=0)


@pytest.mark.parametrize("case", ["rank_deficient", "collapsed"])
def test_robust_frechet_falls_back(case):
    """rank_deficient: the JAX pipeline test's ill-conditioned rank-8
    covariances; the result is finite, nonnegative and the float64 form's
    within 1e-3, as the JAX one is held. collapsed: G's samples all alike
    (a zero covariance) make the float32 iteration divide 0 by 0, and the
    float64 form's value is returned."""
    rng = np.random.default_rng(0)
    a = rng.normal(0, 100.0, (8, 64))
    b = rng.normal(0, 0.01, (8, 64)) if case == "rank_deficient" \
        else np.zeros((8, 64))
    sigma1, sigma2 = a.T @ a / 8, b.T @ b / 8
    mu1, mu2 = rng.normal(0, 1, 64), rng.normal(0, 1, 64)
    value = fid.robust_frechet(mu1, sigma1, mu2, sigma2, device="cpu")
    ref = fid.numpy_frechet_distance(mu1, sigma1, mu2, sigma2)
    assert np.isfinite(value) and value >= 0
    np.testing.assert_allclose(value, ref, rtol=1e-3)
    if case == "collapsed":
        ns = float(fid.frechet_distance(*map(torch.from_numpy,
                                             (mu1, sigma1, mu2, sigma2))))
        assert not np.isfinite(ns)
        assert value == ref


class _TinyNet:
    """The JAX pipeline test's stand-in network (a fixed random projection
    to a 64-dim pool and 10 classes), on NHWC numpy."""

    def __init__(self):
        rng = np.random.default_rng(7)
        self.w = rng.standard_normal((3 * 8 * 8, 64)).astype(np.float32) / 8
        self.wc = rng.standard_normal((64, 10)).astype(np.float32)

    def __call__(self, images):
        x = np.asarray(images, np.float32)
        b, h, w, c = x.shape
        x = x.reshape(b, 8, h // 8, 8, w // 8, c).mean((2, 4))
        pool = np.tanh(x.reshape(b, -1) @ self.w)
        logits = pool @ self.wc
        e = np.exp(logits - logits.max(-1, keepdims=True))
        return pool, e / e.sum(-1, keepdims=True)


def test_accumulate_activations_matches_jax():
    """The same network outputs accumulated by both packages: the device
    float32 sums, then float64 moments on the host."""
    net = _TinyNet()

    def port_net(images):
        pool, probs = net(images.permute(0, 2, 3, 1).numpy())
        return torch.from_numpy(pool), torch.from_numpy(probs)

    batches = np.random.default_rng(2).uniform(
        -1, 1, (5, 8, 32, 32, 3)).astype(np.float32)

    def sampler(to):
        it = iter(batches)
        return lambda: to(next(it))

    probs, mu, sigma = accumulate_activations(
        sampler(lambda b: torch.from_numpy(b.transpose(0, 3, 1, 2))),
        port_net, 36)
    ref_probs, ref_mu, ref_sigma = jinc.accumulate_activations(
        sampler(jnp.asarray), net, 36)
    assert probs.shape == (40, 10) and sigma.shape == (64, 64)
    np.testing.assert_array_equal(probs, ref_probs)
    for ours, ref in ((mu, ref_mu), (sigma, ref_sigma)):
        assert np.abs(ours - ref).max() <= 1e-6 * np.abs(ref).max()


def test_port_weights_and_moments_clis(tmp_path, jax_template,
                                       fixture_state_dict):
    """port_weights: a torch.save'd torchvision-schema state_dict -> the npz,
    which the JAX package loads to its own port of the same state_dict.
    moments: a 16-image 16x16 archive through the real 299x299 Inception
    (those weights) on the CPU -> 2048-dim moments."""
    from tartangan_torch.data import synthetic
    _, template = jax_template
    pth = tmp_path / "inception.pth"
    torch.save({k: torch.from_numpy(v) for k, v in fixture_state_dict.items()},
               str(pth))
    npz = str(tmp_path / "inception.npz")
    port_weights.main([str(pth), npz])
    jax_loaded = jm.load_weights_npz(template, npz)
    jax_ported = jm.port_torch_state_dict(template, fixture_state_dict)
    for a, b in zip(jax.tree_util.tree_leaves(jax_loaded),
                    jax.tree_util.tree_leaves(jax_ported)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    data = str(tmp_path / "data.npz")
    synthetic.main([data, "--num", "16", "--size", "16"])
    out = str(tmp_path / "moments.npz")
    moments.main([data, out, "--batch-size", "8", "--inception-weights", npz,
                  "--quiet-logs", "--device", "cpu"])
    res = np.load(out)
    assert res["mu"].shape == (2048,) and res["sigma"].shape == (2048, 2048)
    assert np.isfinite(res["mu"]).all() and np.isfinite(res["sigma"]).all()
    np.testing.assert_allclose(res["sigma"], res["sigma"].T, rtol=0,
                               atol=1e-12)


def test_moments_cli_raises_without_a_card(tiny_archive, tmp_path,
                                           monkeypatch):
    """--device cuda with no card raises; it does not run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        moments.main([tiny_archive, str(tmp_path / "m.npz"),
                      "--device", "cuda"])
