"""One train step of the port with the parity blocks, ``FUSED_G`` and the
fused G blocks against ``make_cnn_train_step`` on the JAX package's parity
G/D with the same switches (K3 in interpret mode, the fused block on its
reference path), with R1 and without (``no_r1``), in the pattern of
``tests/test_torch_train.py``; and ``python -m tartangan_torch.train.cnn
... --parity-blocks on`` end to end on the CPU.

Config: blocks (80, 80, 16, 8) from a 2x2 base (32 px), so G has a plain
first block, a fused block (80 > 64), and two parity blocks; D two parity
blocks, chained, and two plain ones. Tolerances as in test_torch_train.py.
"""
import torch_threads  # noqa: F401  (this process's share of the cores)
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import tartangan_tpu.ops.pallas.parity_conv as jpc
import tartangan_tpu.ops.parity as jparity
from tartangan_tpu.configs import GAN_CONFIGS as JAX_GAN_CONFIGS
from tartangan_tpu.models import factories as JF
from tartangan_tpu.models.pluggan import Discriminator as JaxDiscriminator
from tartangan_tpu.models.pluggan import Generator as JaxGenerator
from tartangan_tpu.train.cnn import make_cnn_train_step as jax_train_step
from tartangan_tpu.train.common import make_adam as jax_adam
from tartangan_tpu.train.state import GANTrainState as JaxState
from tartangan_torch.configs import GAN_CONFIGS
from tartangan_torch.convert import adam_to_flax, from_flax, to_flax
from tartangan_torch.models import blocks
from tartangan_torch.models import factories as F
from tartangan_torch.models.pluggan import Discriminator, Generator
from tartangan_torch.ops import parity as parity
from tartangan_torch.train.cnn import CNNTrainer, main, make_cnn_train_step
from tartangan_torch.train.common import make_adam
from tartangan_torch.train.state import GANTrainState

JCFG = dataclasses.replace(JAX_GAN_CONFIGS["16"], blocks=(80, 80, 16, 8),
                           base_size=2)
CFG = dataclasses.replace(GAN_CONFIGS["16"], blocks=(80, 80, 16, 8),
                          base_size=2)
LR_G, LR_D, EMA = 1e-4, 4e-4, 1e-3
B, SIZE = 4, 32


def _zip_leaves(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    return zip(la, lb)


def _scaled(ours, ref, atol):
    pairs = [(np.asarray(a, np.float64), np.asarray(b, np.float64))
             for a, b in _zip_leaves(ours, ref)]
    scale = max(float(np.abs(b).max()) for _, b in pairs)
    for a, b in pairs:
        np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=atol)


def _jax_state(rng):
    g = JaxGenerator(JCFG, input_factory=JF.g_input_factory("mlp", "relu"),
                     block_factory=JF.g_block_factory(
                         "bn", "relu", parity=True, fused=True),
                     output_factory=JF.g_output_factory("bn", "relu"))
    d = JaxDiscriminator(JCFG, block_factory=JF.d_block_factory(
        "bn", "relu", parity=True),
        output_factory=JF.d_output_factory("bn", "relu"))
    g_vars = jax.device_get(g.init(jax.random.PRNGKey(0),
                                   jnp.zeros((2, JCFG.latent_dims)),
                                   train=True))
    d_vars = jax.device_get(d.init(jax.random.PRNGKey(1),
                                   jnp.zeros((2, SIZE, SIZE, 3)), train=True))
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
        target_g_params=target, d_params=d_vars["params"],
        d_stats=d_vars["batch_stats"], opt_g=opt_g.init(g_vars["params"]),
        opt_d=opt_d.init(d_vars["params"]))
    return g, d, opt_g, opt_d, state


def _torch_models():
    g = Generator(CFG, input_factory=F.g_input_factory("mlp", "relu"),
                  block_factory=F.g_block_factory("bn", "relu", parity=True,
                                                  fused=True),
                  output_factory=F.g_output_factory("bn", "relu"))
    d = Discriminator(CFG, input_factory=F.d_input_factory(),
                      block_factory=F.d_block_factory("bn", "relu",
                                                      parity=True),
                      output_factory=F.d_output_factory("bn", "relu"))
    return g, d


@pytest.mark.parametrize("r1", ["every_step", "no_r1"])
def test_parity_train_step_matches_jax(rng, monkeypatch, r1):
    monkeypatch.setattr(jpc, "_INTERPRET", True)
    monkeypatch.setattr(jparity, "FUSED_G", True)
    monkeypatch.setattr(parity, "FUSED_G", True)
    interval = 1 if r1 == "every_step" else 2
    jg, jd, opt_g, opt_d, js = _jax_state(rng)
    jstep = jax_train_step(jg, jd, opt_g, opt_d,
                           latent_dims=JCFG.latent_dims, grad_penalty=5.0,
                           ema_factor=EMA, dtype=jnp.float32,
                           r1_interval=interval)
    step = make_cnn_train_step(grad_penalty=5.0, ema_factor=EMA,
                               r1_interval=interval)
    if r1 == "no_r1":
        jstep, step = jstep.no_r1, step.no_r1
    batch = rng.integers(0, 256, (B, SIZE, SIZE, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(5)
    rng_zg, _, *d_keys = jax.random.split(key, 4)
    z_d = np.asarray(jax.random.normal(d_keys[0], (B, JCFG.latent_dims)))
    z_g = np.asarray(jax.random.normal(rng_zg, (B, JCFG.latent_dims)))

    g, d = _torch_models()
    g_target, _ = _torch_models()
    assert [type(b) for b in g.blocks] == [
        blocks.ResidualGeneratorBlock, blocks.FusedResidualGeneratorBlock,
        blocks.ParityResidualGeneratorBlock,
        blocks.ParityResidualGeneratorBlock]
    g.load_state_dict(from_flax({"params": js.g_params,
                                 "batch_stats": js.g_stats}))
    d.load_state_dict(from_flax({"params": js.d_params,
                                 "batch_stats": js.d_stats}))
    g_target.load_state_dict(from_flax({"params": js.target_g_params}),
                             strict=False)
    ts = GANTrainState(g=g, g_target=g_target, d=d,
                       opt_g=make_adam(g.parameters(), LR_G),
                       opt_d=make_adam(d.parameters(), LR_D))
    new_js, jm = jax.jit(jstep)(js, jnp.asarray(batch), key)
    new_js = jax.device_get(new_js)
    tm = step(ts, torch.from_numpy(batch), torch.from_numpy(z_d[None]),
              torch.from_numpy(z_g))

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
        for a, b in _zip_leaves(tree["params"], jparams):
            np.testing.assert_allclose(a, b, rtol=0, atol=2 * lr)
        # the fused block's running statistics and the folded BatchNorm's
        # moved as flax's did
        for a, b in _zip_leaves(tree["batch_stats"], jstats):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 + lr)
        adam = adam_to_flax(mod, opt)
        jadam = serialization.to_state_dict(jopt)
        for moment in ("mu", "nu"):
            _scaled(adam["0"][moment], jadam["0"][moment], 1e-4)
    for a, b in _zip_leaves(to_flax(ts.g_target)["params"],
                            new_js.target_g_params):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_entry_point_trains_with_parity_blocks(tiny_archive, tmp_path):
    """``python -m tartangan_torch.train.cnn DATA --config 16
    --parity-blocks on --device cpu`` trains, checkpoints in the JAX
    layout and resumes."""
    argv = [tiny_archive, "--config", "16", "--batch-size", "8", "--epochs",
            "1", "--output", str(tmp_path / "out"), "--gen-freq", "2",
            "--checkpoint-freq", "2", "--run-id", "prun", "--dtype", "f32",
            "--quiet-logs", "--device", "cpu", "--parity-blocks", "on"]
    main(argv)
    ckpt = tmp_path / "out" / "prun" / "checkpoints" / "3"
    for name in ("g", "g_target", "d", "opt_g", "opt_d"):
        assert (ckpt / f"{name}.msgpack").exists()
    assert json.loads((ckpt / "trainer.json").read_text())["steps"] == 3
    trainer = CNNTrainer.create_from_cli(argv + ["--resume-training-latest",
                                                 "--epochs", "0"])
    trainer.train()
    assert trainer.steps == 3
    g, d = trainer.state.g, trainer.state.d
    assert isinstance(g.blocks[1], blocks.ParityResidualGeneratorBlock)
    assert isinstance(g.output_block, blocks.ParityGeneratorOutput)
    assert isinstance(d.input_block, blocks.ParityDiscriminatorInput)
    # the parity blocks' running statistics moved from their init
    stats = g.blocks[1].NormAct_1.BatchNorm_0.running_mean
    assert float(stats.abs().max()) > 0
    # the checkpoint is the plain tree: a plain-block G loads it
    from tartangan_torch.utils import msgpack
    tree = msgpack.loads((ckpt / "g.msgpack").read_bytes())
    plain = Generator(GAN_CONFIGS["16"],
                      input_factory=F.g_input_factory("mlp", "relu"),
                      block_factory=F.g_block_factory("bn", "relu"),
                      output_factory=F.g_output_factory("bn", "relu"))
    plain.load_state_dict(from_flax(tree))
    z = torch.randn(4, GAN_CONFIGS["16"].latent_dims)
    with torch.no_grad():
        torch.testing.assert_close(plain(z), g(z), rtol=1e-4, atol=1e-4)
