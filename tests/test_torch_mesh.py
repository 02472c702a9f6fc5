"""The data mesh (``--num-devices``): one train step of every trainer
family on two gloo ranks equals the one-process step over the same global
batch, as ``tests/test_distributed_equivalence.py`` holds the JAX
package's 8-device mesh to its one device.

Every family (CNN, parity CNN, IQN, InfoGAN, scene, text, shared CNN)
runs through its trainer's CLI at config '8' ('16' for the parity blocks,
so G's tower routes to a parity block), B 16, one step with R1; so do the
fused G block (K4/K5's plain versions, whose channel sums are
all-reduced before K5's stage; config '16') and G's parity blocks with
K3's plain version (``FUSED_G``; config '32'). The
ranks are spawned once for the module; each runs every family and the
direct steps below, and rank 0 hands back the results.

Tolerances are the JAX test's (float32): metrics 1e-3, G's parameters
5e-4 after Adam's first step (it moves each weight by about +-lr =
1e-4 x sign(g), and a gradient near 0 may take the other sign in
another summation order), D's running statistics 1e-3. Those bound
Adam's step, not the gradient, so the gradients themselves (Adam's first
moments; its beta1 is 0) are held too, against the largest of the
tower's (``_close_grads``): D's, taken before any update, within
TOL_GRAD_D; G's within TOL_GRAD_G, as they follow D's first update, whose
+-lr steps on near-0 gradients may go either way; the text GAN's
embedding gradients (its SGD's) within TOL_GRAD_D. A gradient summed
over the wrong group, or scaled by the number of ranks, is off by
O(1). In float64 the CNN step's metrics, gradients and statistics agree
within 1e-10, with the optimizers set up for the mesh by the trainer. One
CNN step is held directly against the JAX step on its 8-device mesh,
from the same weights (``convert.py``) and the JAX step's own latents.
"""
import torch_threads  # noqa: F401  (this process's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_mesh_workers as W

from tartangan_torch.parallel import launch

FAMILIES = tuple(W.FAMILIES)
# float32 readings here (max |diff| over the tower's largest |gradient|):
# D up to 7.5e-7; G up to 4.3e-6, and 9.3e-4 at config '16', where D's
# first update reaches G's step
TOL_GRAD_D = 1e-5
TOL_GRAD_G = 5e-3


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree, np.float64)


def _close_grads(a, b, rtol, what):
    """Gradient trees ``a`` and ``b`` within ``rtol`` of ``a``'s largest
    |gradient|; a leaf's own scale is no measure where a BatchNorm follows
    a conv, whose bias then has a gradient of rounding noise."""
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys(), what
    scale = max(np.abs(v).max() for v in la.values())
    err = max(np.abs(la[k] - lb[k]).max() for k in la)
    assert err <= rtol * scale, f"{what}: {err} > {rtol} x {scale}"


def _close(a, b, atol, what):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys(), what
    for k in la:
        np.testing.assert_allclose(la[k], lb[k], rtol=0, atol=atol,
                                   err_msg=f"{what}{k}")


def _jax_case(rng):
    """The JAX CNN step on an 8-device mesh (config '8', B 16), its initial
    trees, batch and latents."""
    from tartangan_tpu.configs import GAN_CONFIGS
    from tartangan_tpu.models import factories as JF
    from tartangan_tpu.models.pluggan import Discriminator, Generator
    from tartangan_tpu.parallel.mesh import (
        data_sharding,
        make_mesh,
        replicated_sharding,
    )
    from tartangan_tpu.train.cnn import make_cnn_train_step
    from tartangan_tpu.train.common import make_adam
    from tartangan_tpu.train.state import GANTrainState
    cfg = GAN_CONFIGS["8"]
    g = Generator(cfg, input_factory=JF.g_input_factory("mlp", "relu"),
                  block_factory=JF.g_block_factory("bn", "relu"),
                  output_factory=JF.g_output_factory("bn", "relu"))
    d = Discriminator(cfg, block_factory=JF.d_block_factory("bn", "relu"),
                      output_factory=JF.d_output_factory("bn", "relu"))
    g_vars = jax.device_get(g.init(jax.random.PRNGKey(0),
                                   jnp.zeros((2, cfg.latent_dims)),
                                   train=True))
    d_vars = jax.device_get(d.init(jax.random.PRNGKey(1),
                                   jnp.zeros((2, 8, 8, 3)), train=True))
    opt_g, opt_d = make_adam(1e-4), make_adam(4e-4)
    state = GANTrainState(
        g_params=g_vars["params"], g_stats=g_vars["batch_stats"],
        target_g_params=g_vars["params"],
        d_params=d_vars["params"], d_stats=d_vars["batch_stats"],
        opt_g=opt_g.init(g_vars["params"]),
        opt_d=opt_d.init(d_vars["params"]))
    step = jax.jit(make_cnn_train_step(
        g, d, opt_g, opt_d, latent_dims=cfg.latent_dims, grad_penalty=5.0,
        ema_factor=1e-3, dtype=jnp.float32))
    batch = rng.integers(0, 256, (W.B, 8, 8, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(42)
    # the step's own latents: rng_zg, _, *d_keys = split(key, 4)
    rng_zg, _, *d_keys = jax.random.split(key, 4)
    z_d = np.asarray(jax.random.normal(d_keys[0],
                                       (W.B, cfg.latent_dims)))[None]
    z_g = np.asarray(jax.random.normal(rng_zg, (W.B, cfg.latent_dims)))
    mesh = make_mesh(8)
    new, metrics = step(jax.device_put(state, replicated_sharding(mesh)),
                        jax.device_put(batch, data_sharding(mesh)), key)
    new, metrics = jax.device_get((new, metrics))
    trees = {"g": g_vars, "d": d_vars,
             "g_target": {"params": g_vars["params"]}}
    return trees, batch, z_d, z_g, new, metrics


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(0)
    data = str(tmp / "d32.npz")
    np.savez(data, images=rng.integers(0, 256, (W.B, 32, 32, 3),
                                       dtype=np.uint8))
    docs = tmp / "docs.txt"
    docs.write_text("the quick brown fox jumps over the lazy dog .\n"
                    "a stitch in time saves nine .\n" * 10)
    batch64 = rng.integers(0, 256, (W.B, 8, 8, 3), dtype=np.uint8)
    z64 = rng.standard_normal((2, W.B, 32))
    trees, batch, z_d, z_g, jax_new, jax_metrics = _jax_case(rng)
    steps = [("8", torch.float64, batch64, z64[:1], z64[1]),
             ("8", torch.float32, batch, z_d, z_g, trees)]
    one = {"families": W.run_families(data, str(docs), str(tmp / "w1"),
                                      FAMILIES),
           "steps": [W.cnn_step(data, str(tmp / "w1" / "steps"), *a)
                     for a in steps]}
    two = launch(W.mesh_worker, 2, (data, str(docs), str(tmp / "w2"),
                                    FAMILIES, steps),
                 timeout=W.SPAWN_TIMEOUT)
    return one, two, (jax_new, jax_metrics)


@pytest.mark.parametrize("family", FAMILIES)
def test_family_step_matches_one_process(runs, family):
    one, two, _ = runs
    a, b = one["families"][family], two["families"][family]
    assert a["steps"] == b["steps"] == 1
    assert a["logs"].keys() == b["logs"].keys()
    for k in a["logs"]:
        assert np.isfinite(b["logs"][k])
        assert abs(a["logs"][k] - b["logs"][k]) < 1e-3, (k, a, b)
    _close(a["g"], b["g"], 5e-4, "G params")
    _close(a["d_stats"], b["d_stats"], 1e-3, "D stats")
    _close_grads(a["d_grad"], b["d_grad"], TOL_GRAD_D, f"{family} D grads")
    _close_grads(a["g_grad"], b["g_grad"], TOL_GRAD_G, f"{family} G grads")
    if family == "text":
        _close(a["emb"], b["emb"], 5e-4, "embedding")
        _close_grads(a["emb_grad"], b["emb_grad"], TOL_GRAD_D,
                     "embedding grads")


def test_float64_step_matches_one_process(runs):
    """float64: the losses, both towers' gradients and D's statistics
    within 1e-10 (the parameters are left out: Adam's first step is
    +-lr x sign(g), and a gradient of 1e-17 may flip its sign)."""
    one, two, _ = runs
    (m1, g1, d1, mg1, md1), (m2, g2, d2, mg2, md2) = \
        one["steps"][0], two["steps"][0]
    for k in m1:
        np.testing.assert_allclose(m2[k], m1[k], rtol=1e-10, err_msg=k)
    _close(mg1, mg2, 1e-10, "G grads")
    _close(md1, md2, 1e-10, "D grads")
    _close(d1["batch_stats"], d2["batch_stats"], 1e-10, "D stats")
    _close(g1["batch_stats"], g2["batch_stats"], 1e-10, "G stats")


def test_step_matches_jax_eight_device_mesh(runs):
    """The port on two ranks against the JAX step on its 8-device mesh,
    from the same weights and latents, at the JAX test's tolerances."""
    _, two, (jax_new, jax_metrics) = runs
    metrics, g, d, g_grad, d_grad = two["steps"][1]
    for k in ("g_loss", "d_loss", "gp"):
        assert abs(metrics[k] - float(jax_metrics[k])) < 1e-3, k
    _close(g["params"], jax.device_get(jax_new.g_params), 5e-4, "G params")
    _close(d["batch_stats"], jax.device_get(jax_new.d_stats), 1e-3,
           "D stats")
    _close_grads(jax.device_get(jax_new.opt_d[0].mu), d_grad, TOL_GRAD_D,
                 "jax D grads")
    _close_grads(jax.device_get(jax_new.opt_g[0].mu), g_grad, TOL_GRAD_G,
                 "jax G grads")


def test_collectives_differentiate(runs):
    """On two ranks (x = rank + 1, rank 0's values): ``broadcast`` from
    rank 1 gives 2 everywhere, and the gradient of the sum over ranks of
    b^2 reaches rank 1 only; ``data_sum`` gives s = 3, the gradient of
    the sum over ranks of s^3 is 2 * 3 s^2 on each rank, and its
    derivative 2 * 2 * 6 s."""
    c = runs[1]["collectives"]
    np.testing.assert_array_equal(c["b"], [2.0] * 3)
    np.testing.assert_array_equal(c["gb"], [0.0] * 3)
    np.testing.assert_array_equal(c["s"], [3.0] * 3)
    np.testing.assert_array_equal(c["gs"], [54.0] * 3)
    np.testing.assert_array_equal(c["ggs"], [72.0] * 3)


def test_world_size_rules(tmp_path):
    """``--num-devices`` above the visible cards is an error (none are
    visible here), as is a ``--tp`` that does not divide the world; on the
    CPU the default is ``--tp``; a trainer built for several devices
    outside a process group says how to start the ranks."""
    from tartangan_torch.parallel.mesh import resolve_world
    from tartangan_torch.train.cnn import CNNTrainer
    with pytest.raises(ValueError, match="visible CUDA"):
        resolve_world(2, 1, "cuda")
    with pytest.raises(ValueError, match="does not divide"):
        resolve_world(3, 2, "cpu")
    assert resolve_world(None, 1, "cpu") == 1
    assert resolve_world(None, 2, "cpu") == 2
    data = tmp_path / "d.npz"
    np.savez(data, images=np.zeros((4, 8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="start the ranks"):
        CNNTrainer.create_from_cli(W.trainer_argv(
            str(data), str(tmp_path), "x", ["--config", "8"], world=2))


def test_a_stuck_rank_fails_within_the_timeout():
    """``launch(..., timeout=T)``: with rank 1 hung, rank 0's collective
    times out (the process group's timeout) and the launch raises within
    seconds of T, the ranks killed, instead of waiting out the hang."""
    import time
    t0 = time.monotonic()
    with pytest.raises(Exception):
        launch(W.stuck_worker, 2, (600,), timeout=5)
    assert time.monotonic() - t0 < 60
