"""The port's training step and trainer (``tartangan_torch/train``) against
the JAX package's, from the same state, batch and latents.

The JAX step runs its Pallas attention kernels (K1, K2 and the nested
second-order rule) in interpret mode, as ``tests/test_attention.py`` runs
them; the port runs the same two autograd Functions with the plain
versions inside (CPU tensors). Latents cannot come from matched random
streams, so the test draws the JAX step's own z from its key and hands them
to the port.

Tolerances (float32): losses and gp 1e-4 relative; gradients, compared as
Adam's first moment (β1 = 0, so mu is the gradient) after dividing by
the max-abs over the model's whole gradient, 1e-4; nu (1e-3 · g²)
likewise; the EMA target 1e-5. New parameters compare at 2·lr per Adam
step (2.84·lr for a second one): Adam's first step moves each weight by
about ±lr·sign(g), and a gradient near 0 (a conv bias before a train-mode
BatchNorm has one) may take the other sign in another summation order. Batch statistics compare at 1e-5 + lr: D's
last update comes from the G step's forward on the new D parameters, which
may differ by 2·lr where a gradient's sign flipped, and the running
statistics take 0.1 of the activations' shift.
"""
import torch_threads  # this process's share of the cores
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import tartangan_tpu.ops.pallas.attention as pallas_attn
from tartangan_tpu.configs import GAN_CONFIGS as JAX_GAN_CONFIGS
from tartangan_tpu.models import factories as JF
from tartangan_tpu.models.pluggan import Discriminator as JaxDiscriminator
from tartangan_tpu.models.pluggan import Generator as JaxGenerator
from tartangan_tpu.train.cnn import make_cnn_train_step as jax_train_step
from tartangan_tpu.train.common import make_adam as jax_adam
from tartangan_tpu.train.state import GANTrainState as JaxState
from tartangan_torch.configs import GAN_CONFIGS
from tartangan_torch.convert import adam_to_flax, from_flax, to_flax
from tartangan_torch.models import factories as F
from tartangan_torch.models.pluggan import Discriminator, Generator
from tartangan_torch.train.cnn import CNNTrainer, main, make_cnn_train_step
from tartangan_torch.train.common import make_adam
from tartangan_torch.train.state import GANTrainState

# the 16 px attention config of test_r1_double_grad_through_pallas_attention
JCFG = dataclasses.replace(JAX_GAN_CONFIGS["16"], blocks=(16, 8),
                           attention=(1,))
CFG = dataclasses.replace(GAN_CONFIGS["16"], blocks=(16, 8), attention=(1,))
LR_G, LR_D, EMA = 1e-4, 4e-4, 1e-3
B = 4


def _scaled(ours, ref, atol):
    """Two trees of one gradient, after dividing by the reference's max-abs
    over the whole tree (a conv bias before a train-mode BatchNorm has a
    gradient of 0 up to rounding, so a leaf's own max-abs is no scale)."""
    pairs = [(np.asarray(a, np.float64), np.asarray(b, np.float64))
             for a, b in _zip_leaves(ours, ref)]
    scale = max(float(np.abs(b).max()) for _, b in pairs)
    for a, b in pairs:
        np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=atol)


def _zip_leaves(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    return zip(la, lb)


def _jax_models():
    g = JaxGenerator(JCFG, input_factory=JF.g_input_factory("mlp", "relu"),
                     block_factory=JF.g_block_factory("bn", "relu"),
                     output_factory=JF.g_output_factory("bn", "relu"))
    d = JaxDiscriminator(JCFG, block_factory=JF.d_block_factory("bn", "relu"),
                         output_factory=JF.d_output_factory("bn", "relu"))
    return g, d


def _torch_models():
    g = Generator(CFG, input_factory=F.g_input_factory("mlp", "relu"),
                  block_factory=F.g_block_factory("bn", "relu"),
                  output_factory=F.g_output_factory("bn", "relu"))
    d = Discriminator(CFG, input_factory=F.d_input_factory(),
                      block_factory=F.d_block_factory("bn", "relu"),
                      output_factory=F.d_output_factory("bn", "relu"))
    return g, d


def _jax_state(rng):
    g, d = _jax_models()
    g_vars = jax.device_get(g.init(jax.random.PRNGKey(0),
                                   jnp.zeros((2, JCFG.latent_dims)), train=True))
    d_vars = jax.device_get(d.init(
        jax.random.PRNGKey(1), jnp.zeros((2, 16, 16, 3)), train=True))
    # attention on (gamma != 0) in both towers, so K1/K2 reach the losses;
    # batch stats away from their init values
    g_vars["params"]["blocks_2"]["gamma"] = np.array(0.6, np.float32)
    d_vars["params"]["blocks_1"]["gamma"] = np.array(-0.7, np.float32)
    for v in (g_vars, d_vars):
        v["batch_stats"] = jax.tree_util.tree_map(
            lambda a: np.abs(a + 0.2 * rng.standard_normal(a.shape))
            .astype(np.float32), v["batch_stats"])
    opt_g, opt_d = jax_adam(LR_G), jax_adam(LR_D)
    target = jax.tree_util.tree_map(
        lambda a: (a + 0.01 * rng.standard_normal(a.shape)).astype(np.float32),
        g_vars["params"])
    state = JaxState(
        g_params=g_vars["params"], g_stats=g_vars["batch_stats"],
        target_g_params=target,
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


@pytest.mark.parametrize("r1,iters_d", [("every_step", 1), ("no_r1", 1),
                                        ("no_r1", 2)])
@torch_threads.read_at_eight_threads
def test_train_step_matches_jax(rng, monkeypatch, r1, iters_d):
    """One step with R1, the lazy-R1 alternate without it
    (``r1_interval=2``'s ``no_r1``), and two D updates per G update."""
    monkeypatch.setattr(pallas_attn, "_INTERPRET", True)
    interval = 1 if r1 == "every_step" else 2
    jg, jd, opt_g, opt_d, js = _jax_state(rng)
    jstep = jax_train_step(jg, jd, opt_g, opt_d,
                           latent_dims=JCFG.latent_dims, grad_penalty=5.0,
                           ema_factor=EMA, dtype=jnp.float32,
                           iters_d=iters_d, r1_interval=interval)
    step = make_cnn_train_step(grad_penalty=5.0, ema_factor=EMA,
                               iters_d=iters_d, r1_interval=interval)
    if r1 == "no_r1":
        jstep, step = jstep.no_r1, step.no_r1
    batch = rng.integers(0, 256, (B, 16, 16, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(5)
    # the JAX step's own latents: rng_zg, k_g2, *d_keys = split(rng,
    # 2 + 2 * iters_d), D's z from d_keys[2 * it]
    rng_zg, _, *d_keys = jax.random.split(key, 2 + 2 * iters_d)
    z_d = np.stack([np.asarray(jax.random.normal(
        d_keys[2 * it], (B, JCFG.latent_dims))) for it in range(iters_d)])
    z_g = np.asarray(jax.random.normal(rng_zg, (B, JCFG.latent_dims)))

    ts = _torch_state(js)
    new_js, jm = jax.jit(jstep)(js, jnp.asarray(batch), key)
    new_js = jax.device_get(new_js)
    tm = step(ts, torch.from_numpy(batch), torch.from_numpy(z_d.copy()),
              torch.from_numpy(z_g.copy()))

    for name in ("d_loss", "g_loss", "gp"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    assert (float(tm["gp"]) > 0) == (r1 == "every_step")

    for mod, opt, jparams, jstats, jopt, lr in (
            (ts.g, ts.opt_g, new_js.g_params, new_js.g_stats, new_js.opt_g,
             LR_G),
            (ts.d, ts.opt_d, new_js.d_params, new_js.d_stats, new_js.opt_d,
             LR_D)):
        tree = to_flax(mod)
        steps = iters_d if mod is ts.d else 1
        # with b1 = 0 Adam's first update is +-lr and its second at most
        # lr * sqrt(1 + b2) < 1.42 lr; two runs may differ by twice the
        # sum where a gradient's sign flips
        move = lr * (1 + 1.42 * (steps - 1))
        for a, b in _zip_leaves(tree["params"], jparams):
            np.testing.assert_allclose(a, b, rtol=0, atol=2 * move)
        for a, b in _zip_leaves(tree["batch_stats"], jstats):
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-5 + lr)
        adam = adam_to_flax(mod, opt)
        jadam = serialization.to_state_dict(jopt)
        assert int(adam["0"]["count"]) == int(jadam["0"]["count"]) == steps
        for moment in ("mu", "nu"):
            _scaled(adam["0"][moment], jadam["0"][moment], 1e-4)
    for a, b in _zip_leaves(to_flax(ts.g_target)["params"],
                            new_js.target_g_params):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_float64_step_stays_float64(rng):
    """A float64 step (``chip_smoke.py``'s witness on the card) keeps
    BatchNorm, the losses and R1 in float64, and agrees with the float32
    step: losses 1e-4 relative, gradients 1e-4 of their max-abs. D's
    learning rate is 0, so both G steps see one D."""
    from tartangan_torch.models.attention import SelfAttention2d
    _, _, _, _, js = _jax_state(rng)
    batch = torch.from_numpy(rng.integers(0, 256, (B, 16, 16, 3),
                                          dtype=np.uint8))
    z_d = torch.from_numpy(rng.standard_normal((1, B, CFG.latent_dims)))
    z_g = torch.from_numpy(rng.standard_normal((B, CFG.latent_dims)))
    runs = []
    for dtype in (torch.float32, torch.float64):
        ts = _torch_state(js)
        for model in (ts.g, ts.g_target, ts.d):
            model.to(dtype)
            for m in model.modules():
                if isinstance(m, SelfAttention2d):
                    m.use_kernel = False  # K1/K2 take float32 and bfloat16
        for group in ts.opt_d.param_groups:
            group["lr"] = 0.0
        step = make_cnn_train_step(grad_penalty=5.0, ema_factor=EMA,
                                   dtype=dtype)
        metrics = step(ts, batch, z_d.to(dtype), z_g.to(dtype))
        assert all(v.dtype == dtype for v in metrics.values())
        grads = [ts.opt_g.state[p]["exp_avg"] for p in ts.g.parameters()] \
            + [ts.opt_d.state[p]["exp_avg"] for p in ts.d.parameters()]
        assert all(t.dtype == dtype for t in grads)
        runs.append((metrics, grads))
    (m32, g32), (m64, g64) = runs
    for name in m64:
        np.testing.assert_allclose(float(m32[name]), float(m64[name]),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    scale = max(float(t.abs().max()) for t in g64)
    for a, b in zip(g32, g64):
        np.testing.assert_allclose(a.double().numpy() / scale,
                                   b.numpy() / scale, rtol=0, atol=1e-4)


# ----------------------------------------------------------- the trainer
def _argv(archive, out, *extra):
    return [archive, "--config", "16", "--batch-size", "8", "--epochs", "1",
            "--output", str(out), "--gen-freq", "2", "--checkpoint-freq", "2",
            "--run-id", "testrun", "--dtype", "f32", "--quiet-logs",
            "--device", "cpu", *extra]


def test_entry_point_trains_samples_checkpoints_and_resumes(tiny_archive,
                                                            tmp_path):
    """``python -m tartangan_torch.train.cnn ... --device cpu`` end to end,
    as tests/test_train_cnn.py drives the JAX trainer."""
    main(_argv(tiny_archive, tmp_path / "out"))
    out = tmp_path / "out" / "testrun"
    assert (out / "config.args").exists()
    samples = sorted(p.name for p in (out / "samples").iterdir())
    assert "sample_3.png" in samples and "grid_sample_3.png" in samples
    ckpt = out / "checkpoints" / "3"
    for name in ("g", "g_target", "d", "opt_g", "opt_d"):
        assert (ckpt / f"{name}.msgpack").exists()
    assert json.loads((ckpt / "trainer.json").read_text())["steps"] == 3

    trainer = CNNTrainer.create_from_cli(_argv(
        tiny_archive, tmp_path / "out", "--resume-training-latest",
        "--epochs", "0"))
    trainer.train()
    assert trainer.steps == 3
    resumed = trainer.checkpoint_artifacts()
    from tartangan_torch.utils import msgpack
    for name in ("g", "d", "opt_g", "opt_d"):
        saved = msgpack.loads((ckpt / f"{name}.msgpack").read_bytes())
        for a, b in _zip_leaves(resumed[name], saved):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_trainer_losses_finite_and_stats_move(tiny_archive, tmp_path):
    trainer = CNNTrainer.create_from_cli(_argv(
        tiny_archive, tmp_path / "out", "--gen-freq", "100",
        "--r1-interval", "2"))
    trainer.train()
    assert trainer.steps == 3
    for key in ("g_loss", "d_loss", "gp"):
        vals = [float(v) for v in trainer.logs[key]]
        assert len(vals) == 3 and all(np.isfinite(vals))
    # lazy R1: the penalty is taken on steps 0 and 2 only
    assert [float(v) > 0 for v in trainer.logs["gp"]] == [True, False, True]
    # the train steps updated the running statistics from their init (0, 1)
    for model in (trainer.state.g, trainer.state.d):
        stats = model.state_dict()
        means = [v for k, v in stats.items() if k.endswith("running_mean")]
        assert means and all(m.abs().max() > 0 for m in means)
    # sampling (train-mode BatchNorm) leaves every buffer alone
    before = {k: v.clone() for k, v in trainer.state.g.state_dict().items()}
    imgs = trainer.sample_g(5)
    assert imgs.shape == (5, 16, 16, 3) and np.isfinite(imgs).all()
    for k, v in trainer.state.g.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)


@pytest.mark.parametrize("flag", [
    ["--num-devices", "2"], ["--tp", "2"], ["--remat", "--num-devices", "2"],
    ["--checkpoint-format", "orbax"]])
def test_unported_flags_raise(tiny_archive, tmp_path, flag):
    """Flags that were once unported and are ported now. ``--checkpoint-
    format orbax`` trains one step at config '8', saves the five artifacts
    as orbax directories and resumes from them: the resumed trainer's
    artifacts equal the saved ones bit for bit. The mesh's flags
    (``--num-devices 2``, ``--tp 2``, and ``--remat`` on two ranks) train
    one step of the global batch of 24 through the CLI's launcher, on two
    gloo ranks, with finite losses."""
    if flag[0] == "--checkpoint-format":
        argv = _argv(tiny_archive, tmp_path, "--config", "8",
                     "--batch-size", "24", *flag)
        trainer = CNNTrainer.create_from_cli(argv)
        trainer.train()
        ckpt = tmp_path / "testrun" / "checkpoints" / "1"
        assert trainer.steps == 1
        assert sorted(p.name for p in ckpt.iterdir()) == [
            "d.orbax", "g.orbax", "g_target.orbax", "opt_d.orbax",
            "opt_g.orbax", "trainer.json"]
        resumed = CNNTrainer.create_from_cli(
            argv + ["--resume-training-step", "1", "--epochs", "0"])
        resumed.train()
        saved = jax.tree_util.tree_leaves_with_path(
            trainer.checkpoint_artifacts())
        back = jax.tree_util.tree_leaves_with_path(
            resumed.checkpoint_artifacts())
        assert [k for k, _ in saved] == [k for k, _ in back]
        for (key, a), (_, b) in zip(saved, back):
            assert a.dtype == b.dtype and a.shape == b.shape, key
            assert a.tobytes() == b.tobytes(), key
        return
    logs = main(_argv(tiny_archive, tmp_path, "--batch-size", "24", *flag))
    for key in ("g_loss", "d_loss", "gp"):
        assert np.isfinite(logs[key]), (key, logs)
    assert (tmp_path / "testrun" / "checkpoints" / "1" / "g.msgpack").exists()
