"""``--steps-per-call K`` (``tartangan_torch/train/multi.py``) and
``--activation selu`` against the JAX package.

The K-step call runs eagerly on the CPU (its plain version; on the card it
is replayed from CUDA graphs, ``tests/test_torch_kernels_cuda.py``). It is
held against ``chunk_train_step(..., "scan")`` of the JAX package, whose
Pallas attention runs in interpret mode as in ``tests/test_torch_train.py``;
each inner step's latents are the JAX step's own, computed from its key
chain. Tolerances as there: losses 1e-4 relative, parameters within twice
the most Adam can move them in the steps taken (a gradient near 0 may take
the other sign in another summation order).

A K-step call fed the same draws as K single steps computes the same ops
in the same order on the CPU, so those compare bit for bit.
"""
import torch_threads  # noqa: F401  (this process's share of the cores)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tartangan_tpu.ops.pallas.attention as pallas_attn
from tartangan_torch.configs import GAN_CONFIGS
from tartangan_torch.convert import adam_to_flax, to_flax
from tartangan_torch.data import device as D
from tartangan_torch.train.cnn import CNNTrainer, make_cnn_train_step
from tartangan_torch.train.common import selu_reinit
from tartangan_torch.train.components.base import TrainerComponent
from tartangan_torch.train.multi import (
    chunk_train_step,
    stack_batches,
    state_tensors,
)
from tartangan_tpu.configs import GAN_CONFIGS as JAX_GAN_CONFIGS
from tartangan_tpu.models import factories as JF
from tartangan_tpu.models.pluggan import Discriminator as JaxDiscriminator
from tartangan_tpu.models.pluggan import Generator as JaxGenerator
from tartangan_tpu.train.cnn import make_cnn_train_step as jax_train_step
from tartangan_tpu.train.common import selu_reinit as jax_selu_reinit
from tartangan_tpu.train.multi import chunk_train_step as jax_chunk
from test_torch_train import (
    B,
    EMA,
    JCFG,
    LR_D,
    LR_G,
    _jax_state,
    _torch_state,
    _zip_leaves,
)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tests run in several worker processes at once; torch's CPU ops
    at these small sizes gain nothing from more threads and, with every
    worker's threads spinning on the same cores, slow down many times."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ----------------------------------------------- the chunk's mechanics
def test_chunk_broadcast_runs_k_steps():
    def step(state, batch, z):
        state["s"] += batch
        return {"s": state["s"] - batch, "z": z}

    multi = chunk_train_step(step, 4, "broadcast")
    state = {"s": torch.tensor(0)}
    metrics = multi(state, torch.tensor(10), z=torch.arange(4.0))
    assert int(state["s"]) == 40
    assert metrics["s"].tolist() == [0, 10, 20, 30]
    assert metrics["z"].tolist() == [0.0, 1.0, 2.0, 3.0]


def test_chunk_scan_slices_leading_axis():
    def step(state, batch):
        state["s"] += batch.sum()
        return {"b": batch.sum()}

    multi = chunk_train_step(step, 3, "scan")
    state = {"s": torch.tensor(0)}
    metrics = multi(state, torch.tensor([[1, 1], [2, 2], [3, 3]]))
    assert int(state["s"]) == 12
    assert metrics["b"].tolist() == [2, 4, 6]


def test_chunk_alternates_on_global_step():
    """Lazy R1 with N = 3 and K = 2: the primary step runs exactly where
    (step0 + i) % 3 == 0, across call boundaries."""
    ran = []
    multi = chunk_train_step(
        lambda s, b: ran.append("r1") or {"x": torch.tensor(1)}, 2, "scan",
        alt_step_fn=lambda s, b: ran.append("no") or {"x": torch.tensor(0)},
        alt_interval=3)
    for step0 in (0, 2, 4):
        multi(None, torch.zeros(2, 1), step0)
    assert ran == ["r1", "no", "no", "r1", "no", "no"]
    assert multi.pattern(6) == (True, False)
    assert chunk_train_step(lambda s, b: {}, 2, "scan").pattern(5) == \
        (True, True)


def test_chunk_validates_args():
    step = lambda s, b: {}
    with pytest.raises(ValueError):
        chunk_train_step(step, 0, "broadcast")
    with pytest.raises(ValueError):
        chunk_train_step(step, 2, "nope")


def test_stack_batches_groups_and_drops_remainder():
    batches = [np.full((2, 3), i, np.uint8) for i in range(7)]
    stacks = list(stack_batches(iter(batches), 3))
    assert len(stacks) == 2
    assert stacks[0].shape == (3, 2, 3)
    assert stacks[1][0, 0, 0] == 3


def test_component_every_chunk_aware():
    class C(TrainerComponent):
        pass

    class FakeTrainer:
        steps_per_call = 4

    c = C(args=None)
    c.trainer = FakeTrainer()
    assert [s for s in range(0, 32, 4) if c.every(10, s)] == [0, 8, 20, 28]
    c.trainer.steps_per_call = 1
    assert [s for s in range(0, 8) if c.every(3, s)] == [0, 3, 6]


# --------------------------------------------- against the JAX scan
def test_scan_call_matches_jax_chunk(rng, monkeypatch):
    """One K = 2 'scan' call from the state of ``test_torch_train``,
    R1 every step, against ``chunk_train_step(jstep, 2, "scan")``."""
    monkeypatch.setattr(pallas_attn, "_INTERPRET", True)
    k = 2
    jg, jd, opt_g, opt_d, js = _jax_state(rng)
    jstep = jax_train_step(jg, jd, opt_g, opt_d,
                           latent_dims=JCFG.latent_dims, grad_penalty=5.0,
                           ema_factor=EMA, dtype=jnp.float32)
    batches = rng.integers(0, 256, (k, B, 16, 16, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(5)
    # the scan's key chain: key, sub = split(key) for each inner step; the
    # step's z from sub as test_torch_train draws them
    z_d, z_g, chain = [], [], key
    for _ in range(k):
        chain, sub = jax.random.split(chain)
        rng_zg, _, d_key, _ = jax.random.split(sub, 4)
        z_d.append(np.asarray(jax.random.normal(d_key,
                                                (1, B, JCFG.latent_dims))))
        z_g.append(np.asarray(jax.random.normal(rng_zg,
                                                (B, JCFG.latent_dims))))
    ts = _torch_state(js)
    new_js, jm = jax.jit(jax_chunk(jstep, k, "scan"))(
        js, jnp.asarray(batches), key)
    new_js = jax.device_get(new_js)
    multi = chunk_train_step(
        make_cnn_train_step(grad_penalty=5.0, ema_factor=EMA), k, "scan")
    tm = multi(ts, torch.from_numpy(batches),
               z_d=torch.from_numpy(np.stack(z_d)),
               z_g=torch.from_numpy(np.stack(z_g)))

    for name in ("d_loss", "g_loss", "gp"):
        assert tm[name].shape == (k,)
        np.testing.assert_allclose(tm[name].numpy(), np.asarray(jm[name]),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    for mod, opt, jparams, jopt, lr in (
            (ts.g, ts.opt_g, new_js.g_params, new_js.opt_g, LR_G),
            (ts.d, ts.opt_d, new_js.d_params, new_js.opt_d, LR_D)):
        move = lr * (1 + 1.42 * (k - 1))
        for a, b in _zip_leaves(to_flax(mod)["params"], jparams):
            np.testing.assert_allclose(a, b, rtol=0, atol=2 * move)
        assert int(adam_to_flax(mod, opt)["0"]["count"]) == k
        assert int(jopt[0].count) == k
    for a, b in _zip_leaves(to_flax(ts.g_target)["params"],
                            new_js.target_g_params):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


# ------------------------------------- the call against single steps
def _trainer(archive, out, *extra):
    t = CNNTrainer.create_from_cli([
        archive, "--config", "16", "--batch-size", "4", "--epochs", "1",
        "--output", str(out), "--gen-freq", "100", "--checkpoint-freq",
        "100", "--run-id", "r", "--dtype", "f32", "--quiet-logs",
        "--device", "cpu", "--r1-interval", "2", "--steps-per-call", "3",
        *extra])
    t.build_models()
    return t


def _snapshot(trainer):
    return [t.clone() for t in state_tensors(trainer.state)]


@pytest.mark.parametrize("device_data", [False, True],
                         ids=["scan", "broadcast"])
def test_k_step_calls_equal_single_steps(tiny_archive, tmp_path, rng,
                                         device_data):
    """Two K = 3 calls (steps 0-2 and 3-5) with lazy R1 every 2 steps
    against 6 single steps fed the same draws: equal to the bit, and R1
    (gp > 0) exactly on steps 0, 2 and 4."""
    k, b, latent = 3, 4, GAN_CONFIGS["16"].latent_dims
    chunked = _trainer(tiny_archive, tmp_path / "a")
    single = _trainer(tiny_archive, tmp_path / "b")
    for x, y in zip(_snapshot(chunked), _snapshot(single)):
        assert torch.equal(x, y)
    archive = torch.from_numpy(rng.integers(0, 256, (10, 20, 18, 3),
                                            dtype=np.uint8))
    for t in (chunked, single):
        t._archive, t._crop = archive, 16
    call = chunked.make_chunk_call(device_data)
    gen = torch.Generator().manual_seed(3)
    got, want = [], []
    for step0 in (0, 3):
        draws = {"z_d": torch.randn((k, 1, b, latent), generator=gen),
                 "z_g": torch.randn((k, b, latent), generator=gen)}
        if device_data:
            draws.update(zip(("idx", "ys", "xs"),
                             D.draw(10, 20, 18, 16, b, gen, k)))
            inputs = archive
        else:
            inputs = torch.from_numpy(
                rng.integers(0, 256, (k, b, 16, 16, 3), dtype=np.uint8))
        got.append(call(chunked.state, inputs, step0, **draws))
        for i in range(k):
            if device_data:
                batch = D.gather_crop(archive, draws["idx"][i],
                                      draws["ys"][i], draws["xs"][i], 16)
            else:
                batch = inputs[i]
            fn = single._train_step if (step0 + i) % 2 == 0 \
                else single._train_step_alt
            want.append(fn(single.state, batch, draws["z_d"][i],
                           draws["z_g"][i]))
    for name in ("g_loss", "d_loss", "gp"):
        a = torch.cat([m[name] for m in got])
        w = torch.stack([m[name] for m in want])
        assert torch.equal(a, w), name
    gp = torch.cat([m["gp"] for m in got])
    assert (gp > 0).tolist() == [True, False, True, False, True, False]
    for x, y in zip(_snapshot(chunked), _snapshot(single)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("device_data", [True, False])
def test_trainer_steps_per_call_end_to_end(tiny_archive, tmp_path,
                                           device_data):
    """24 images at B 8 are 3 batches, 2 an epoch at K = 2 (the last
    dropped); stacked (K,) metrics, one entry a call; the checkpoint and
    the samples on call boundaries."""
    trainer = CNNTrainer.create_from_cli([
        tiny_archive, "--config", "8", "--batch-size", "8", "--epochs", "2",
        "--output", str(tmp_path / "out"), "--gen-freq", "2",
        "--checkpoint-freq", "4", "--run-id", "spc", "--dtype", "f32",
        "--quiet-logs", "--device", "cpu", "--steps-per-call", "2",
        *(["--device-data"] if device_data else [])])
    trainer.train()
    assert trainer.steps == 4
    for key in ("g_loss", "d_loss", "gp"):
        chunks = trainer.logs[key]
        assert len(chunks) == 2 and all(c.shape == (2,) for c in chunks)
        assert torch.isfinite(torch.cat(chunks)).all()
    assert (tmp_path / "out" / "spc" / "checkpoints" / "4").exists()
    assert any((tmp_path / "out" / "spc" / "samples").iterdir())


def test_steps_per_call_deterministic(tiny_archive, tmp_path):
    def run(run_id):
        trainer = CNNTrainer.create_from_cli([
            tiny_archive, "--config", "8", "--batch-size", "8", "--epochs",
            "1", "--output", str(tmp_path / run_id), "--gen-freq", "100",
            "--checkpoint-freq", "100", "--run-id", run_id, "--dtype",
            "f32", "--quiet-logs", "--device", "cpu", "--steps-per-call",
            "2", "--device-data", "--seed", "5"])
        trainer.train()
        return torch.cat(trainer.logs["g_loss"])
    assert torch.equal(run("a"), run("b"))


def test_lazy_r1_cadence_across_calls(tiny_archive, tmp_path):
    """--r1-interval 2 --steps-per-call 3 through ``train()``: 24 images
    at B 4 are two calls an epoch, and R1 runs on steps 0, 2 and 4."""
    trainer = CNNTrainer.create_from_cli([
        tiny_archive, "--config", "8", "--batch-size", "4", "--epochs", "1",
        "--output", str(tmp_path), "--gen-freq", "100", "--checkpoint-freq",
        "100", "--run-id", "r", "--dtype", "f32", "--quiet-logs",
        "--device", "cpu", "--steps-per-call", "3", "--r1-interval", "2",
        "--device-data"])
    trainer.train()
    gp = torch.cat(trainer.logs["gp"])
    assert trainer.steps == 6
    assert (gp > 0).tolist() == [True, False, True, False, True, False]


def test_zero_steps_raises(tiny_archive, tmp_path):
    trainer = CNNTrainer.create_from_cli([
        tiny_archive, "--config", "8", "--batch-size", "8", "--output",
        str(tmp_path), "--run-id", "z", "--device", "cpu", "--quiet-logs",
        "--steps-per-call", "4"])
    with pytest.raises(ValueError, match="steps-per-call"):
        trainer.train()


def test_chunk_cadence_warning(tiny_archive, tmp_path, capsys):
    trainer = CNNTrainer.create_from_cli([
        tiny_archive, "--config", "8", "--batch-size", "8", "--output",
        str(tmp_path), "--run-id", "w", "--device", "cpu", "--gen-freq",
        "3", "--checkpoint-freq", "4", "--steps-per-call", "2"])
    trainer._warn_chunk_cadence(2)
    out = capsys.readouterr().out
    assert "--gen-freq=3 is not a multiple of --steps-per-call=2" in out
    assert "--checkpoint-freq" not in out and "--log-iters" not in out


def test_resume_continues_k_step_calls(tiny_archive, tmp_path):
    """A K = 2 --device-data run resumed from its checkpoint at step 2:
    the Adam state loads before the first call (before any capture on the
    card) and the calls go on from it, to step 4 and Adam count 4."""
    def argv(*extra):
        return [tiny_archive, "--config", "8", "--batch-size", "8",
                "--output", str(tmp_path), "--gen-freq", "100",
                "--checkpoint-freq", "100", "--run-id", "res", "--dtype",
                "f32", "--quiet-logs", "--device", "cpu", "--steps-per-call",
                "2", "--device-data", *extra]
    first = CNNTrainer.create_from_cli(argv("--epochs", "1"))
    first.train()
    assert first.steps == 2
    saved = adam_to_flax(first.state.g, first.state.opt_g)
    resumed = CNNTrainer.create_from_cli(argv("--epochs", "2",
                                              "--resume-training-latest"))
    loaded = []
    train_batch = resumed.train_batch

    def spy(batch):
        if not loaded:
            loaded.append(adam_to_flax(resumed.state.g, resumed.state.opt_g))
        return train_batch(batch)
    resumed.train_batch = spy
    resumed.train()
    for a, b in _zip_leaves(loaded[0], saved):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert resumed.steps == 4 and len(resumed.logs["g_loss"]) == 1
    assert torch.isfinite(resumed.logs["g_loss"][0]).all()
    opt = resumed.state.opt_g
    assert {float(s["step"]) for s in opt.state.values()} == {4.0}


# ---------------------------------------------------- --activation selu
def _jax_selu_params(cfg):
    g = JaxGenerator(cfg, input_factory=JF.g_input_factory("mlp", "selu"),
                     block_factory=JF.g_block_factory("bn", "selu"),
                     output_factory=JF.g_output_factory("bn", "selu"))
    d = JaxDiscriminator(cfg, block_factory=JF.d_block_factory("bn", "selu"),
                         output_factory=JF.d_output_factory("bn", "selu"))
    size = cfg.max_size
    gp = g.init(jax.random.PRNGKey(0), jnp.zeros((2, cfg.latent_dims)),
                train=True)["params"]
    dp = d.init(jax.random.PRNGKey(1), jnp.zeros((2, size, size, 3)),
                train=True)["params"]
    return [jax.device_get(jax_selu_reinit(jax.random.PRNGKey(2), p))
            for p in (gp, dp)]


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield "/".join(prefix + (key,)), np.asarray(value)


def test_selu_reinit_matches_jax(tiny_archive, tmp_path):
    """The same leaves zeroed as the JAX function (every leaf of 1 or
    fewer dimensions), and the std of each other leaf of 2048 values or
    more within 5 % of 1/sqrt(fan_in) in flax's layout (a 2.5 % standard
    error at most), at 4x the '16' widths (blocks 64, 32)."""
    cfg = dataclasses.replace(JAX_GAN_CONFIGS["16"]).scale_model(4.0)
    jax_trees = _jax_selu_params(cfg)
    t = CNNTrainer.create_from_cli([
        tiny_archive, "--config", "16", "--model-scale", "4",
        "--activation", "selu", "--output", str(tmp_path), "--run-id", "s",
        "--device", "cpu"])
    t.build_models()
    for module, jtree in zip((t.state.g, t.state.d), jax_trees):
        ours = dict(_leaves(to_flax(module)["params"]))
        ref = dict(_leaves(jtree))
        assert sorted(ours) == sorted(ref)
        zeroed = {k for k, v in ours.items() if not v.any()}
        assert zeroed == {k for k, v in ref.items() if not v.any()}
        assert zeroed == {k for k, v in ours.items() if v.ndim <= 1}
        wide = [(n, v) for n, v in ours.items()
                if v.ndim >= 2 and v.size >= 2048]
        assert len(wide) >= 4
        for name, leaf in wide:
            want = (leaf.size // leaf.shape[-1]) ** -0.5
            assert abs(leaf.std() / want - 1) < 0.05, name
    # the EMA target is copied after the re-initialization
    for a, b in zip(t.state.g.parameters(), t.state.g_target.parameters()):
        assert torch.equal(a, b)


def test_selu_reinit_keeps_buffers():
    from tartangan_torch.models.layers import BatchNorm
    bn = BatchNorm(3)
    bn.running_var.fill_(2.0)
    selu_reinit(bn, torch.Generator().manual_seed(0))
    assert not bn.weight.any() and not bn.bias.any()
    assert torch.equal(bn.running_var, torch.full((3,), 2.0))


def test_selu_trains_one_call(tiny_archive, tmp_path):
    trainer = CNNTrainer.create_from_cli([
        tiny_archive, "--config", "16", "--batch-size", "8", "--epochs",
        "1", "--output", str(tmp_path), "--run-id", "selu", "--dtype",
        "f32", "--quiet-logs", "--device", "cpu", "--activation", "selu",
        "--gen-freq", "100", "--steps-per-call", "3", "--device-data"])
    trainer.train()
    assert trainer.steps == 3
    for key in ("g_loss", "d_loss", "gp"):
        assert torch.isfinite(trainer.logs[key][0]).all()
