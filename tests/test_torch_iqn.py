"""The port's IQN head, discriminator, step and trainer
(``tartangan_torch/models/iqn.py``, ``models/blocks.py::
IQNDiscriminatorOutput``, ``train/iqn.py``) against the JAX package's.

The JAX head draws its taus from a key inside the step; the port takes
them as arguments. The head tests pass the JAX head an explicit key and
draw the same taus in the test with the same ``jax.random.uniform`` call.
The step test replaces ``jax.random.uniform`` in the JAX IQN module while
the JAX step is traced, so its real, fake and G passes (traced in that order) draw
``uniform(k_real)``, ``uniform(k_fake)`` and ``uniform(k_gen)`` from the
step's own keys, and hands the same taus to the port.

Tolerances (float32): the embeddings, loss and head 1e-5 relative and
absolute; the step as ``tests/test_torch_train.py`` states them (losses
and gp 1e-4 relative; Adam's moments 1e-4 of the gradient's max-abs;
parameters 2·lr per Adam step; statistics 1e-5 + lr; the EMA target
1e-5).
"""
import torch_threads  # noqa: F401  (this process's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import tartangan_tpu.ops.pallas.attention as pallas_attn
from tartangan_tpu.configs import GAN_CONFIGS as JAX_GAN_CONFIGS
from tartangan_tpu.models import blocks as jblocks
from tartangan_tpu.models import factories as JF
from tartangan_tpu.models import iqn as jiqn
from tartangan_tpu.models.pluggan import Generator as JaxGenerator
from tartangan_tpu.models.pluggan import IQNDiscriminator as JaxIQND
from tartangan_tpu.train.common import make_adam as jax_adam
from tartangan_tpu.train.iqn import make_iqn_train_step as jax_iqn_step
from tartangan_tpu.train.state import GANTrainState as JaxState
from tartangan_torch.convert import adam_to_flax, from_flax, to_flax
from tartangan_torch.models import factories as F
from tartangan_torch.models import iqn as tiqn
from tartangan_torch.models.blocks import IQNDiscriminatorOutput
from tartangan_torch.models.layers import update_batch_stats
from tartangan_torch.models.pluggan import Generator, IQNDiscriminator
from tartangan_torch.train.common import make_adam
from tartangan_torch.train.iqn import IQNTrainer, main, make_iqn_train_step
from tartangan_torch.train.state import GANTrainState

from test_torch_train import (
    B,
    CFG,
    EMA,
    JCFG,
    LR_D,
    LR_G,
    _argv,
    _scaled,
    _zip_leaves,
)

Q = 8  # the IQN's quantiles a sample
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return t.detach().numpy()


@pytest.mark.parametrize("name", ["cosine", "tiled", "weighted"])
def test_quantile_embeddings_match_jax(rng, name):
    jcls, tcls = {"cosine": (jiqn.CosineQuantileEmbedding,
                             tiqn.CosineQuantileEmbedding),
                  "tiled": (jiqn.QuantileEmbedding, tiqn.QuantileEmbedding),
                  "weighted": (jiqn.WeightedQuantileEmbedding,
                               tiqn.WeightedQuantileEmbedding)}[name]
    taus = rng.random((12, 1)).astype(np.float32)
    jmod = jcls(16)
    variables = jax.device_get(jmod.init(jax.random.PRNGKey(0),
                                         jnp.asarray(taus), train=True))
    want, new = jmod.apply(variables, jnp.asarray(taus), train=True,
                           mutable=["batch_stats"])
    mod = tcls(16)
    mod.load_state_dict(from_flax(variables))
    with update_batch_stats(mod):
        got = mod(torch.from_numpy(taus), torch.float32, train=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    for a, b in _zip_leaves(to_flax(mod).get("batch_stats", {}),
                            jax.device_get(new).get("batch_stats", {})):
        np.testing.assert_allclose(a, b, **TOL)


def test_iqn_loss_matches_jax(rng):
    preds = rng.standard_normal((Q * 5, 2)).astype(np.float32)
    target = rng.standard_normal((5, 2)).astype(np.float32) * 1.5
    taus = rng.random((Q * 5, 2)).astype(np.float32)
    want = jiqn.iqn_loss(jnp.asarray(preds), jnp.asarray(target),
                         jnp.asarray(taus))
    got = tiqn.iqn_loss(torch.from_numpy(preds), torch.from_numpy(target),
                        torch.from_numpy(taus))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), **TOL)
    # a (B,) target, and the target's gradient stopped
    t1 = torch.from_numpy(target[:, :1].copy()).requires_grad_()
    p1 = torch.from_numpy(preds[:, :1].copy()).requires_grad_()
    loss = tiqn.iqn_loss(p1, t1[:, 0], torch.from_numpy(taus[:, :1].copy()))
    loss.backward()
    assert t1.grad is None and p1.grad.abs().sum() > 0
    np.testing.assert_allclose(float(loss), float(jiqn.iqn_loss(
        jnp.asarray(preds[:, :1]), jnp.asarray(target[:, 0]),
        jnp.asarray(taus[:, :1]))), **TOL)


@pytest.mark.parametrize("with_targets", [True, False])
def test_iqn_head_matches_jax(rng, with_targets):
    x = rng.standard_normal((B, 4, 4, 16)).astype(np.float32)
    targets = np.ones((B, 1), np.float32)
    key = jax.random.PRNGKey(3)
    jhead = jblocks.IQNDiscriminatorOutput(16, 1)
    variables = jax.device_get(jhead.init(
        {"params": jax.random.PRNGKey(0), "iqn": key}, jnp.asarray(x),
        train=True, targets=jnp.asarray(targets)))
    kwargs = dict(targets=jnp.asarray(targets)) if with_targets else {}
    want, new = jhead.apply(variables, jnp.asarray(x), train=True, rng=key,
                            mutable=["batch_stats"], **kwargs)
    taus = np.asarray(jax.random.uniform(key, (B * Q, 1), jnp.float32))
    head = IQNDiscriminatorOutput(16, 1)
    head.load_state_dict(from_flax(variables))
    with update_batch_stats(head):
        got = head(torch.from_numpy(x).permute(0, 3, 1, 2), train=True,
                   targets=torch.from_numpy(targets) if with_targets
                   else None, taus=torch.from_numpy(taus))
    if with_targets:
        (got, got_loss), (want, want_loss) = got, want
        np.testing.assert_allclose(float(got_loss), float(want_loss), **TOL)
    assert got.shape == (B, 1)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    for a, b in _zip_leaves(to_flax(head)["batch_stats"],
                            jax.device_get(new)["batch_stats"]):
        np.testing.assert_allclose(a, b, **TOL)


def test_head_needs_taus_of_the_batch():
    head = IQNDiscriminatorOutput(8, 1)
    x = torch.zeros((2, 8, 4, 4))
    with pytest.raises(ValueError):
        head(x)
    with pytest.raises(ValueError):
        head(x, taus=torch.zeros((Q * 3, 1)))


# ------------------------------------------------------------- the step
def _jax_models():
    g = JaxGenerator(JCFG, input_factory=JF.g_input_factory("mlp", "relu"),
                     block_factory=JF.g_block_factory("bn", "relu"),
                     output_factory=JF.g_output_factory("bn", "relu"))
    d = JaxIQND(JCFG, block_factory=JF.d_block_factory("bn", "relu"),
                output_factory=JF.iqn_d_output_factory("bn", "relu"))
    return g, d


def _torch_models():
    g = Generator(CFG, input_factory=F.g_input_factory("mlp", "relu"),
                  block_factory=F.g_block_factory("bn", "relu"),
                  output_factory=F.g_output_factory("bn", "relu"))
    d = IQNDiscriminator(CFG, block_factory=F.d_block_factory("bn", "relu"),
                         output_factory=F.iqn_d_output_factory("bn", "relu"))
    return g, d


def _jax_state(rng):
    g, d = _jax_models()
    g_vars = jax.device_get(g.init(jax.random.PRNGKey(0),
                                   jnp.zeros((2, JCFG.latent_dims)),
                                   train=True))
    key = jax.random.PRNGKey(1)
    d_vars = jax.device_get(d.init(
        {"params": key, "iqn": key}, jnp.zeros((2, 16, 16, 3)), train=True,
        targets=jnp.ones((2, 1))))
    # attention on in both towers, so K1/K2 reach the losses
    g_vars["params"]["blocks_2"]["gamma"] = np.array(0.6, np.float32)
    d_vars["params"]["blocks_1"]["gamma"] = np.array(-0.7, np.float32)
    for v in (g_vars, d_vars):
        v["batch_stats"] = jax.tree_util.tree_map(
            lambda a: np.abs(a + 0.2 * rng.standard_normal(a.shape))
            .astype(np.float32), v["batch_stats"])
    opt_g, opt_d = jax_adam(LR_G), jax_adam(LR_D)
    state = JaxState(
        g_params=g_vars["params"], g_stats=g_vars["batch_stats"],
        target_g_params=g_vars["params"],
        d_params=d_vars["params"], d_stats=d_vars["batch_stats"],
        opt_g=opt_g.init(g_vars["params"]),
        opt_d=opt_d.init(d_vars["params"]))
    return g, d, opt_g, opt_d, state


def _torch_state(js):
    g, d = _torch_models()
    g_target, _ = _torch_models()
    g.load_state_dict(from_flax({"params": js.g_params,
                                 "batch_stats": js.g_stats}))
    d.load_state_dict(from_flax({"params": js.d_params,
                                 "batch_stats": js.d_stats}))
    g_target.load_state_dict(from_flax({"params": js.target_g_params}),
                             strict=False)
    return GANTrainState(g=g, g_target=g_target, d=d,
                         opt_g=make_adam(g.parameters(), LR_G),
                         opt_d=make_adam(d.parameters(), LR_D))


@pytest.mark.parametrize("grad_penalty", [5.0, 0.0])
def test_iqn_step_matches_jax(rng, monkeypatch, grad_penalty):
    monkeypatch.setattr(pallas_attn, "_INTERPRET", True)
    jg, jd, opt_g, opt_d, js = _jax_state(rng)
    key = jax.random.PRNGKey(5)
    # the JAX step's keys: rng_zg, k_gen, rng_zd, k_real, k_fake
    rng_zg, k_gen, rng_zd, k_real, k_fake = jax.random.split(key, 5)
    uniform = jax.random.uniform
    taus = [np.asarray(uniform(k, (B * Q, 1), jnp.float32))
            for k in (k_real, k_fake, k_gen)]
    drawn = iter(taus)

    class _Random:  # jax.random, its uniform replaced, for the IQN module
        @staticmethod
        def uniform(*args, **kwargs):
            return jnp.asarray(next(drawn))

        def __getattr__(self, name):
            return getattr(jax.random, name)

    class _Jax:
        random = _Random()

        def __getattr__(self, name):
            return getattr(jax, name)
    monkeypatch.setattr(jiqn, "jax", _Jax())
    jstep = jax_iqn_step(jg, jd, opt_g, opt_d, latent_dims=JCFG.latent_dims,
                         grad_penalty=grad_penalty, ema_factor=EMA,
                         dtype=jnp.float32)
    batch = rng.integers(0, 256, (B, 16, 16, 3), dtype=np.uint8)
    ts = _torch_state(js)
    new_js, jm = jax.jit(jstep)(js, jnp.asarray(batch), key)
    new_js = jax.device_get(new_js)
    assert next(drawn, None) is None  # three passes traced, in that order

    z_d = np.asarray(jax.random.normal(rng_zd, (B, JCFG.latent_dims)))[None]
    z_g = np.asarray(jax.random.normal(rng_zg, (B, JCFG.latent_dims)))
    step = make_iqn_train_step(grad_penalty=grad_penalty, ema_factor=EMA)
    tm = step(ts, torch.from_numpy(batch), torch.from_numpy(z_d.copy()),
              torch.from_numpy(z_g.copy()),
              torch.from_numpy(np.stack(taus[:2])[None]),
              torch.from_numpy(taus[2]))
    for name in ("d_loss", "g_loss", "gp"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    assert (float(tm["gp"]) > 0) == bool(grad_penalty)
    for mod, opt, jparams, jstats, jopt, lr in (
            (ts.g, ts.opt_g, new_js.g_params, new_js.g_stats, new_js.opt_g,
             LR_G),
            (ts.d, ts.opt_d, new_js.d_params, new_js.d_stats, new_js.opt_d,
             LR_D)):
        tree = to_flax(mod)
        for a, b in _zip_leaves(tree["params"], jparams):
            np.testing.assert_allclose(a, b, rtol=0, atol=2 * lr)
        for a, b in _zip_leaves(tree["batch_stats"], jstats):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 + lr)
        adam = adam_to_flax(mod, opt)
        jadam = serialization.to_state_dict(jopt)
        for moment in ("mu", "nu"):
            _scaled(adam["0"][moment], jadam["0"][moment], 1e-4)
    for a, b in _zip_leaves(to_flax(ts.g_target)["params"],
                            new_js.target_g_params):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------- the trainer
def _shapes(tree):
    return jax.tree_util.tree_map(np.shape, tree)


def test_iqn_entry_point_trains_and_checkpoints_in_jax_layout(tiny_archive,
                                                              tmp_path):
    """``python -m tartangan_torch.train.iqn ... --device cpu``: samples,
    and a checkpoint whose D and Adam trees are the JAX IQN trainer's (the
    JAX IQN discriminator's variables at config '16'); a resume reads it
    back."""
    main(_argv(tiny_archive, tmp_path / "out"))
    out = tmp_path / "out" / "testrun"
    assert (out / "samples" / "sample_3.png").exists()
    from tartangan_torch.utils import msgpack
    ckpt = out / "checkpoints" / "3"
    d_tree = msgpack.loads((ckpt / "d.msgpack").read_bytes())
    jd = JaxIQND(JAX_GAN_CONFIGS["16"],
                 block_factory=JF.d_block_factory("bn", "relu"),
                 output_factory=JF.iqn_d_output_factory("bn", "relu"))
    key = jax.random.PRNGKey(0)
    template = jax.device_get(jd.init(
        {"params": key, "iqn": key}, jnp.zeros((2, 16, 16, 3)), train=True,
        targets=jnp.ones((2, 1))))
    assert _shapes(d_tree) == _shapes(template)
    opt_d = msgpack.loads((ckpt / "opt_d.msgpack").read_bytes())
    assert _shapes(opt_d["0"]["mu"]) == _shapes(template["params"])

    trainer = IQNTrainer.create_from_cli(_argv(
        tiny_archive, tmp_path / "out", "--resume-training-latest",
        "--epochs", "0"))
    trainer.train()
    assert trainer.steps == 3
    for a, b in _zip_leaves(to_flax(trainer.state.d), d_tree):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("device_data", [False, True],
                         ids=["scan", "broadcast"])
def test_iqn_trainer_k_step_calls(tiny_archive, tmp_path, device_data):
    """``--steps-per-call 2`` (with ``--device-data``: the step gathers its
    batch on the device): the taus of both steps are drawn outside the
    call with the latents (``extra_draws``), uniform in [0, 1)."""
    trainer = IQNTrainer.create_from_cli(_argv(
        tiny_archive, tmp_path / "out", "--steps-per-call", "2",
        "--gen-freq", "100", *(["--device-data"] if device_data else [])))
    trainer.build_models()
    draws = trainer.chunk_draws(device_data=False)
    assert draws["taus_d"].shape == (2, 1, 2, Q * 8, 1)
    assert draws["taus_g"].shape == (2, Q * 8, 1)
    for taus in (draws["taus_d"], draws["taus_g"]):
        assert 0 <= float(taus.min()) and float(taus.max()) < 1
    trainer.train()
    assert trainer.steps == 2
    for key in ("g_loss", "d_loss", "gp"):
        vals = torch.cat(trainer.logs[key])
        assert vals.shape == (2,) and torch.isfinite(vals).all()
