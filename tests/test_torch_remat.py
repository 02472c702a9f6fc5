"""``--remat`` / ``--remat-policy`` in the port (``tartangan_torch/ops/
remat.py``, the factories' ``remat=`` and the blocks' ``tagged`` sites)
against the port without remat and against the JAX package's rematted
blocks (``tests/test_remat_policy.py`` holds the JAX side to itself).

Tolerances: a rematted block's forward and gradients equal the port's
without remat to the bit (the recomputation runs the same ops in the same
order, or takes the forward's own values back); against the JAX block on
the same weights the loss and output 1e-5 relative and absolute, the
gradients (input's and parameters') 1e-5 of their max-abs (float32: the
loss sums 512 squares). A float64 train
step with R1 through rematted blocks: losses, gp, D's and G's gradients
and every running statistic equal to the bit to the step without remat.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tartangan_tpu.models import factories as JF
from tartangan_torch.configs import GAN_CONFIGS
from tartangan_torch.convert import from_flax
from tartangan_torch.models import factories as F
from tartangan_torch.models.attention import SelfAttention2d
from tartangan_torch.models.layers import update_batch_stats
from tartangan_torch.models.pluggan import Discriminator, Generator
from tartangan_torch.ops import parity as P
from tartangan_torch.ops import parity_conv
from tartangan_torch.ops.init import init_module_
from tartangan_torch.train.cnn import CNNTrainer, make_cnn_train_step
from tartangan_torch.train.common import make_adam
from tartangan_torch.train.state import GANTrainState

from test_torch_train import _argv

POLICIES = ["full", "convs", "dots"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _blocks(side, parity, remat, policy):
    """(JAX block, port block) of one kind, as tests/test_remat_policy.py
    builds them: G 8 -> 4 upsampling, D 4 -> 8, neither first."""
    if side == "g":
        jblk = JF.g_block_factory("bn", "relu", remat=remat, parity=parity,
                                  remat_policy_name=policy)(
            8, 4, first_block=False, upsample=True, dtype=jnp.float32)
        blk = F.g_block_factory("bn", "relu", parity=parity, remat=remat,
                                remat_policy_name=policy)(
            8, 4, first_block=False, upsample=True)
    else:
        jblk = JF.d_block_factory("bn", "relu", remat=remat, parity=parity,
                                  remat_policy_name=policy)(
            4, 8, first_block=False, dtype=jnp.float32)
        blk = F.d_block_factory("bn", "relu", parity=parity, remat=remat,
                                remat_policy_name=policy)(
            4, 8, first_block=False)
    return jblk, blk


def _port_loss_grads(blk, x):
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous() \
        .requires_grad_()
    with update_batch_stats(blk):
        out = blk(xt, True)
    loss = out.square().sum()
    loss.backward()
    return (loss.detach(), out.detach(), xt.grad,
            [p.grad for p in blk.parameters()],
            [b.clone() for b in blk.buffers()])


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("parity", [False, True])
@pytest.mark.parametrize("side", ["g", "d"])
def test_rematted_block_matches_port_and_jax(rng, policy, parity, side):
    cin = 8 if side == "g" else 4
    x = rng.standard_normal((2, 8, 8, cin)).astype(np.float32)
    jblk, blk = _blocks(side, parity, True, policy)
    _, plain = _blocks(side, parity, False, policy)
    assert blk.remat_policy == policy and plain.remat_policy is None
    variables = jax.device_get(jblk.init(jax.random.PRNGKey(0),
                                         jnp.asarray(x), True))
    for m in (blk, plain):
        m.load_state_dict(from_flax(variables))
    got = _port_loss_grads(blk, x)
    base = _port_loss_grads(plain, x)
    for a, b in zip(got[:3] + tuple(got[3]) + tuple(got[4]),
                    base[:3] + tuple(base[3]) + tuple(base[4])):
        assert torch.equal(a, b)

    def loss(params, xx):
        out, _ = jblk.apply({**variables, "params": params}, xx, True,
                            mutable=["batch_stats"])
        return jnp.sum(out ** 2), out
    (jloss, jout), (jgp, jgx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"],
                                            jnp.asarray(x))
    np.testing.assert_allclose(float(got[0]), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(got[1].permute(0, 2, 3, 1).numpy(),
                               np.asarray(jout), **TOL)
    grads = from_flax({"params": jax.device_get(jgp)})
    pairs = [(got[2].permute(0, 2, 3, 1).numpy(), np.asarray(jgx))]
    pairs += [(g.numpy(), grads[name].numpy())
              for (name, _), g in zip(blk.named_parameters(), got[3])]
    scale = max(float(np.abs(b).max()) for _, b in pairs)
    for a, b in pairs:
        np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=1e-5)


CFG = dataclasses.replace(GAN_CONFIGS["16"], blocks=(16, 8, 8),
                          attention=(1,))


def _state(parity, remat, policy):
    gen = torch.Generator().manual_seed(0)
    g = Generator(CFG, F.g_input_factory("mlp", "relu"),
                  F.g_block_factory("bn", "relu", parity=parity, remat=remat,
                                    remat_policy_name=policy),
                  F.g_output_factory("bn", "relu"))
    d = Discriminator(CFG, F.d_input_factory(),
                      F.d_block_factory("bn", "relu", parity=parity,
                                        remat=remat,
                                        remat_policy_name=policy),
                      F.d_output_factory("bn", "relu"))
    g_target = Generator(CFG, F.g_input_factory("mlp", "relu"),
                         F.g_block_factory("bn", "relu", parity=parity),
                         F.g_output_factory("bn", "relu"))
    models = [init_module_(m, gen).double() for m in (g, d, g_target)]
    for model in models:
        for m in model.modules():
            if isinstance(m, SelfAttention2d):
                m.gamma.data.fill_(0.5)
                m.use_kernel = False  # K1/K2 take float32 and bfloat16
    g, d, g_target = models
    return GANTrainState(g=g, g_target=g_target, d=d,
                         opt_g=make_adam(g.parameters(), 1e-4),
                         opt_d=make_adam(d.parameters(), 4e-4))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("parity", [False, True])
def test_r1_step_with_remat_equals_step_without(rng, policy, parity):
    """One float64 train step with R1 every step: the inner gradient of R1
    recomputes D's rematted blocks inside ``update_batch_stats`` and the
    outer backward recomputes them again; BatchNorm's running statistics
    must take one update (as JAX's functional remat does), and gp and the
    gradients must be those of the step without remat."""
    batch = torch.from_numpy(rng.integers(0, 256, (4, 32, 32, 3),
                                          dtype=np.uint8))
    z_d = torch.from_numpy(rng.standard_normal((1, 4, CFG.latent_dims)))
    z_g = torch.from_numpy(rng.standard_normal((4, CFG.latent_dims)))
    step = make_cnn_train_step(grad_penalty=5.0, ema_factor=1e-3,
                               dtype=torch.float64)
    runs = []
    for remat in (False, True):
        state = _state(parity, remat, policy)
        metrics = step(state, batch, z_d, z_g)
        grads = [state.opt_g.state[p]["exp_avg"] for p in state.g.parameters()]
        grads += [state.opt_d.state[p]["exp_avg"]
                  for p in state.d.parameters()]
        buffers = list(state.g.buffers()) + list(state.d.buffers())
        runs.append((metrics, grads, buffers))
    (m0, g0, b0), (m1, g1, b1) = runs
    assert float(m0["gp"]) > 0
    for name in m0:
        assert torch.equal(m0[name], m1[name]), name
    for a, b in zip(g0 + b0, g1 + b1):
        assert torch.equal(a, b)


class _CountConvs(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _backward_convs(side, policy, monkeypatch):
    """Convolutions (and the merged-tap parity conv's plain launches, K3's
    stand-in on the CPU) that a backward through one rematted block of
    each kind runs, beyond those without remat."""
    monkeypatch.setattr(P, "FUSED_G", True)
    launches = []
    plain_k3 = parity_conv.fused_parity_conv_plain
    monkeypatch.setattr(parity_conv, "fused_parity_conv_plain",
                        lambda *a, **k: launches.append(1) or plain_k3(*a,
                                                                       **k))
    counts = []
    for remat in (False, True):
        torch.manual_seed(0)
        blocks = [_blocks(side, parity, remat, policy)[1]
                  for parity in (False, True)]
        cin = 8 if side == "g" else 4
        x = torch.randn(2, cin, 8, 8)
        outs = []
        for blk in blocks:
            with update_batch_stats(blk):
                outs.append(blk(x, True).square().sum())
        del launches[:]
        mode = _CountConvs()
        with mode:
            sum(outs).backward()
        counts.append((mode.n, len(launches)))
    (c0, k0), (c1, k1) = counts
    assert k0 == 0
    return c1 - c0, k1


@pytest.mark.parametrize("side", ["g", "d"])
def test_convs_recomputes_no_tagged_conv(side, monkeypatch):
    """Under ``convs`` the backward recomputes none of the tagged convs
    (K3's launches included, under ``ops.parity.FUSED_G``); under ``full``
    it recomputes every one: 2 a block, for a plain and a parity block."""
    assert _backward_convs(side, "convs", monkeypatch) == (0, 0)
    # in G the parity block's two convs are K3's, whose plain version on
    # the CPU runs one convolution each
    want = (4, 2) if side == "g" else (4, 0)
    assert _backward_convs(side, "full", monkeypatch) == want


def test_remat_flag_trains_and_bad_policy_raises(tiny_archive, tmp_path):
    trainer = CNNTrainer.create_from_cli(_argv(
        tiny_archive, tmp_path / "out", "--remat", "--remat-policy", "convs",
        "--parity-blocks", "on", "--gen-freq", "100"))
    trainer.train()
    assert trainer.steps == 3
    rematted = [m for model in (trainer.state.g, trainer.state.d)
                for m in model.modules()
                if getattr(m, "remat_policy", None) == "convs"]
    assert len(rematted) == 4  # G's two blocks, D's two
    assert all(np.isfinite(float(v)) for v in trainer.logs["gp"])
    with pytest.raises(ValueError):
        F.g_block_factory("bn", "relu", remat=True, remat_policy_name="nope")
    with pytest.raises(ValueError):
        F.d_block_factory("bn", "relu", remat=True, remat_policy_name="nope")
    with pytest.raises(SystemExit):
        CNNTrainer.create_from_cli(_argv(tiny_archive, tmp_path, "--remat",
                                         "--remat-policy", "nope"))
