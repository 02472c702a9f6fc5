"""The port's shared-filter family (``tartangan_torch/models/shared.py``,
``train/shared/{cnn,iqn}.py``) against the JAX package's, on the same
weights (through ``convert.py``), inputs and draws.

The JAX attention runs its Pallas kernels in interpret mode, as
``tests/test_attention.py`` runs them, in the forward tests, and its plain
reference (``attn_use_pallas=False``, the same math) under R1 and in the
steps, where the interpreted second-order kernel would take most of the
file's time; the port's attention runs its plain versions (CPU tensors).

Tolerances. float32: outputs, batch statistics and the bank's gradient
1e-5 relative to the reference's max-abs (the bank's gradient sums every
block's slice of it, in another order); the steps as
``tests/test_torch_train.py`` states them (losses and gp 1e-4 relative;
Adam's moments 1e-4 of the gradient's max-abs; parameters 2 lr; statistics
1e-5 + lr; the EMA target 1e-5). bfloat16: G's images, D's logits and D's
R1 penalty within TOL_BF16 of the JAX models applied op by op (each layer
rounds to bfloat16, 2^-8 relative, and the two round sums taken in other
orders, carried through BatchNorm'd blocks); the bank's gradient under R1
no farther from the port's float64 gradient than STEP_FACTOR times the
JAX package's bfloat16 one, in norm (as ``tests/test_torch_bf16.py`` holds
its step: a sum of many bfloat16-rounded products through the second
derivative, in which a few products round the other way).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import tartangan_tpu.ops.pallas.attention as pallas_attn
from tartangan_tpu.models import iqn as jiqn
from tartangan_tpu.models import shared as JS
from tartangan_tpu.train.cnn import make_cnn_train_step as jax_cnn_step
from tartangan_tpu.train.common import make_adam as jax_adam
from tartangan_tpu.train.iqn import make_iqn_train_step as jax_iqn_step
from tartangan_tpu.train.shared.cnn import SharedCNNTrainer as JaxSharedCNN
from tartangan_tpu.train.shared.iqn import SharedIQNTrainer as JaxSharedIQN
from tartangan_tpu.train.state import GANTrainState as JaxState
from tartangan_torch.convert import _to_tree, adam_to_flax, from_flax, to_flax
from tartangan_torch.models import shared as TS
from tartangan_torch.models.attention import SelfAttention2d
from tartangan_torch.models.layers import update_batch_stats
from tartangan_torch.models.losses import r1_gradient_penalty
from tartangan_torch.train.cnn import make_cnn_train_step
from tartangan_torch.train.common import make_adam
from tartangan_torch.train.iqn import make_iqn_train_step
from tartangan_torch.train.shared import cnn as shared_cnn
from tartangan_torch.train.shared import iqn as shared_iqn
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

Q = 8  # the IQN head's quantiles a sample
TOL_BF16 = 3e-2
STEP_FACTOR = 3


def _close(ours, ref, tol=1e-5):
    """Within ``tol`` of the reference's max-abs."""
    ours = np.asarray(ours, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(ours / scale, ref / scale, rtol=0, atol=tol)


def _np(t):
    return t.detach().float().numpy()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _perturb(variables, rng):
    """Batch statistics and BatchNorm affines away from their init, and
    every attention gamma nonzero, so each reaches the outputs."""
    def walk(tree, path=()):
        for key, value in tree.items():
            if isinstance(value, dict):
                walk(value, path + (key,))
            elif key in ("scale", "bias", "mean", "var", "gamma"):
                shift = 0.3 * rng.standard_normal(np.shape(value))
                new = np.asarray(value) + shift
                if key in ("var", "scale"):
                    new = np.abs(new) + 0.2
                tree[key] = new.astype(np.float32)
    walk(variables)
    return variables


# ------------------------------------------------------------- the blocks
@pytest.mark.parametrize("kind,cin,cout,apply_norm", [
    ("conv", 8, 16, True), ("conv", 16, 8, False),
    ("g", 8, 16, False), ("g", 16, 16, True),
    ("d", 16, 8, True), ("d", 8, 8, False)])
def test_shared_block_matches_jax(rng, kind, cin, cout, apply_norm):
    """Each block's output, batch statistics and the bank's gradient."""
    jcls, tcls = {"conv": (JS.SharedConvBlock, TS.SharedConvBlock),
                  "g": (JS.SharedResidualGeneratorBlock,
                        TS.SharedResidualGeneratorBlock),
                  "d": (JS.SharedResidualDiscriminatorBlock,
                        TS.SharedResidualDiscriminatorBlock)}[kind]
    bank = (0.2 * rng.standard_normal((3, 3, 20, 16))).astype(np.float32)
    x = rng.standard_normal((B, 8, 8, cin)).astype(np.float32)
    jmod = jcls(cin, cout, apply_norm=apply_norm)
    variables = jax.device_get(jmod.init(jax.random.PRNGKey(0), x, bank))
    variables = _perturb(variables, rng)
    if kind == "conv":
        variables["params"]["bias"] = rng.standard_normal(cout).astype(
            np.float32)
    out_shape = jmod.apply(variables, x, bank, mutable=["batch_stats"])[0]
    w_out = rng.standard_normal(out_shape.shape).astype(np.float32)

    def jloss(bank):
        out, new = jmod.apply(variables, jnp.asarray(x), bank,
                              mutable=["batch_stats"])
        return jnp.sum(out * w_out), (out, new)
    (_, (want, new)), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(bank))

    mod = tcls(cin, cout, apply_norm=apply_norm)
    mod.load_state_dict(from_flax(variables))
    tbank = torch.from_numpy(bank.transpose(3, 2, 0, 1).copy())
    tbank.requires_grad_()
    with update_batch_stats(mod):
        got = mod(_nchw(x), tbank)
    (got * _nchw(w_out)).sum().backward()
    _close(_np(got.permute(0, 2, 3, 1)), want)
    _close(_np(tbank.grad.permute(2, 3, 1, 0)), jgrad)
    for a, b in _zip_leaves(to_flax(mod).get("batch_stats", {}),
                            jax.device_get(new).get("batch_stats", {})):
        _close(a, b)


def test_xavier_bank_init():
    """The bank's init: uniform within the JAX package's bound
    (sqrt(2) sqrt(6 / (9 in + 9 out)))."""
    g = TS.SharedGenerator(CFG)
    bank = g.shared_filters.detach()
    assert bank.shape == (16, 100, 3, 3)
    bound = np.sqrt(2.0) * np.sqrt(6.0 / (9 * 100 + 9 * 16))
    assert float(bank.abs().max()) <= bound
    assert float(bank.abs().max()) > 0.9 * bound
    jbank = JS.xavier_uniform_relu_gain(jax.random.PRNGKey(0),
                                        (3, 3, 100, 16))
    assert abs(float(jnp.abs(jbank).max()) - bound) < 0.05 * bound


# ------------------------------------------------------------- the models
def _models(name):
    return {"g": (JS.SharedGenerator, TS.SharedGenerator),
            "d": (JS.SharedDiscriminator, TS.SharedDiscriminator),
            "iqn": (JS.SharedIQNDiscriminator,
                    TS.SharedIQNDiscriminator)}[name]


def _init(name, rng):
    jcls, _ = _models(name)
    key = jax.random.PRNGKey(1)
    x = (jnp.zeros((2, JCFG.latent_dims)) if name == "g"
         else jnp.zeros((2, 16, 16, 3)))
    kwargs = dict(targets=jnp.ones((2, 1))) if name == "iqn" else {}
    variables = jax.device_get(jcls(JCFG).init(
        {"params": key, "iqn": key}, x, **kwargs))
    return _perturb(variables, rng)


@pytest.mark.parametrize("name", ["g", "d", "iqn"])
def test_shared_model_matches_jax(rng, monkeypatch, name):
    """G, D and IQN-D forwards (train mode) in float32: output, batch
    statistics, and a checkpoint tree of the JAX layout both ways."""
    monkeypatch.setattr(pallas_attn, "_INTERPRET", True)
    jcls, tcls = _models(name)
    variables = _init(name, rng)
    if name == "g":
        x = rng.standard_normal((B, JCFG.latent_dims)).astype(np.float32)
        tx = torch.from_numpy(x)
    else:
        x = rng.standard_normal((B, 16, 16, 3)).astype(np.float32)
        tx = _nchw(x)
    kwargs, tkwargs = {}, {}
    if name == "iqn":
        key = jax.random.PRNGKey(4)
        taus = np.asarray(jax.random.uniform(key, (B * Q, 1), jnp.float32))
        kwargs = dict(targets=jnp.ones((B, 1)), rng=key)
        tkwargs = dict(targets=torch.ones((B, 1)),
                       taus=torch.from_numpy(taus))
    want, new = jcls(JCFG).apply(variables, jnp.asarray(x),
                                 mutable=["batch_stats"], **kwargs)
    mod = tcls(CFG)
    mod.load_state_dict(from_flax(variables))
    with update_batch_stats(mod):
        got = mod(tx, **tkwargs)
    if name == "iqn":
        (got, got_loss), (want, want_loss) = got, want
        np.testing.assert_allclose(float(got_loss), float(want_loss),
                                   rtol=1e-5)
    if name == "g":
        got = got.permute(0, 2, 3, 1)
    _close(_np(got), want)
    tree = to_flax(mod)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(variables)
    for a, b in _zip_leaves(tree["batch_stats"],
                            jax.device_get(new)["batch_stats"]):
        _close(a, b)


def _port_r1(variables, x, dtype):
    """The port's D with R1 in ``dtype``: (logits, penalty, the gradient
    of logits.sum() + 5 penalty as a flax tree)."""
    mod = TS.SharedDiscriminator(CFG, dtype=dtype)
    mod.load_state_dict(from_flax(variables))
    if dtype == torch.float64:
        mod.double()
        for m in mod.modules():  # the wrappers take float32 and bfloat16
            if isinstance(m, SelfAttention2d):
                m.use_kernel = False
    real = _nchw(x).to(dtype).requires_grad_()
    gp, out = r1_gradient_penalty(mod, real)
    (out.double().sum() + 5.0 * gp).backward()
    grads = _to_tree((k, p.grad) for k, p in mod.named_parameters())
    return out, gp, grads["params"]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_shared_d_with_r1_matches_jax(rng, dtype):
    """D with R1: the logits' sum plus 5 times the penalty (the sum over
    pixels of the squared input gradient, mean over the batch), and its
    gradient with respect to every parameter; the bank's gradient collects
    every block's slice, to second order. float32 against the JAX model.
    bfloat16: logits and penalty against the JAX model compiled with
    ``xla_allow_excess_precision`` off (so that it rounds where flax's
    casts say, ``tests/test_torch_bf16.py``), and the bank's gradient no
    farther from the port's float64 one than STEP_FACTOR times the JAX
    package's bfloat16 gradient, in norm."""
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    variables = _init("d", rng)
    x = rng.standard_normal((B, 16, 16, 3)).astype(np.float32)
    jmod = JS.SharedDiscriminator(JCFG, dtype=jdt, attn_use_pallas=False)

    def jtotal(params):
        def logit_sum(xx):
            out, _ = jmod.apply({"params": params,
                                 "batch_stats": variables["batch_stats"]},
                                xx, mutable=["batch_stats"])
            return jnp.sum(out.astype(jnp.float32)), out
        gx, out = jax.grad(logit_sum, has_aux=True)(
            jnp.asarray(x).astype(jdt))
        gp = jnp.mean(jnp.sum(jnp.square(gx.astype(jnp.float32)).reshape(
            B, -1), axis=1))
        return jnp.sum(out.astype(jnp.float32)) + 5.0 * gp, (out, gp)
    fn = jax.jit(jax.value_and_grad(jtotal, has_aux=True)).lower(
        variables["params"]).compile(
        compiler_options={"xla_allow_excess_precision": False})
    (_, (want, want_gp)), jgrads = jax.device_get(fn(variables["params"]))

    if dtype == "f32":
        out, gp, grads = _port_r1(variables, x, torch.float32)
        _close(_np(out), want)
        np.testing.assert_allclose(float(gp), float(want_gp), rtol=1e-5)
        _scaled(grads, jgrads, 1e-5)
        _close(grads["shared_filters"], jgrads["shared_filters"])
        return
    out, gp, grads = _port_r1(variables, x, torch.bfloat16)
    _close(_np(out), np.asarray(want, np.float32), TOL_BF16)
    np.testing.assert_allclose(float(gp), float(want_gp), rtol=TOL_BF16)
    _, _, ref = _port_r1(variables, x, torch.float64)
    ref = np.asarray(ref["shared_filters"], np.float64)

    def dist(bank):
        return float(np.linalg.norm(np.asarray(bank, np.float64) - ref)
                     / np.linalg.norm(ref))
    ours, theirs = dist(grads["shared_filters"]), dist(
        jgrads["shared_filters"])
    assert 0 < theirs and ours <= STEP_FACTOR * theirs, (ours, theirs)


@pytest.mark.parametrize("name", ["g", "d"])
def test_shared_model_bf16_matches_jax(rng, monkeypatch, name):
    """bfloat16 forwards: float32 parameters cast at use, as flax's."""
    monkeypatch.setattr(pallas_attn, "_INTERPRET", True)
    jcls, tcls = _models(name)
    variables = _init(name, rng)
    if name == "g":
        x = rng.standard_normal((B, JCFG.latent_dims)).astype(np.float32)
        tx = torch.from_numpy(x)
    else:
        x = rng.standard_normal((B, 16, 16, 3)).astype(np.float32)
        tx = _nchw(x)
    want, _ = jcls(JCFG, dtype=jnp.bfloat16).apply(
        variables, jnp.asarray(x), mutable=["batch_stats"])
    mod = tcls(CFG, dtype=torch.bfloat16)
    mod.load_state_dict(from_flax(variables))
    got = mod(tx)
    assert got.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in mod.parameters())
    if name == "g":
        got = got.permute(0, 2, 3, 1)
    _close(_np(got), np.asarray(want, np.float32), TOL_BF16)


# --------------------------------------------------------------- the steps
def _state(rng, iqn):
    jg = JS.SharedGenerator(JCFG, attn_use_pallas=False)
    jd = (JS.SharedIQNDiscriminator if iqn else JS.SharedDiscriminator)(
        JCFG, attn_use_pallas=False)
    g_vars, d_vars = _init("g", rng), _init("iqn" if iqn else "d", rng)
    opt_g, opt_d = jax_adam(LR_G), jax_adam(LR_D)
    js = JaxState(
        g_params=g_vars["params"], g_stats=g_vars["batch_stats"],
        target_g_params=g_vars["params"],
        d_params=d_vars["params"], d_stats=d_vars["batch_stats"],
        opt_g=opt_g.init(g_vars["params"]),
        opt_d=opt_d.init(d_vars["params"]))
    g = TS.SharedGenerator(CFG)
    g_target = TS.SharedGenerator(CFG)
    d = (TS.SharedIQNDiscriminator if iqn else TS.SharedDiscriminator)(CFG)
    g.load_state_dict(from_flax(g_vars))
    g_target.load_state_dict(from_flax({"params": g_vars["params"]}),
                             strict=False)
    d.load_state_dict(from_flax(d_vars))
    ts = GANTrainState(g=g, g_target=g_target, d=d,
                       opt_g=make_adam(g.parameters(), LR_G),
                       opt_d=make_adam(d.parameters(), LR_D))
    return jg, jd, opt_g, opt_d, js, ts


def _hold_step(tm, jm, ts, new_js):
    for name in ("d_loss", "g_loss", "gp"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    assert float(tm["gp"]) > 0
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


def test_shared_cnn_step_matches_jax(rng, monkeypatch):
    """One CNN step (BCE, R1, Adam, EMA) on the shared models: losses, gp,
    gradients, running statistics, Adam's state."""
    monkeypatch.setattr(pallas_attn, "_INTERPRET", True)
    jg, jd, opt_g, opt_d, js, ts = _state(rng, iqn=False)
    jstep = jax_cnn_step(jg, jd, opt_g, opt_d, latent_dims=JCFG.latent_dims,
                         grad_penalty=5.0, ema_factor=EMA,
                         dtype=jnp.float32)
    batch = rng.integers(0, 256, (B, 16, 16, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(5)
    rng_zg, _, d_key, _ = jax.random.split(key, 4)
    z_d = np.asarray(jax.random.normal(d_key, (B, JCFG.latent_dims)))[None]
    z_g = np.asarray(jax.random.normal(rng_zg, (B, JCFG.latent_dims)))
    new_js, jm = jax.jit(jstep)(js, jnp.asarray(batch), key)
    step = make_cnn_train_step(grad_penalty=5.0, ema_factor=EMA)
    tm = step(ts, torch.from_numpy(batch), torch.from_numpy(z_d.copy()),
              torch.from_numpy(z_g.copy()))
    _hold_step(tm, jm, ts, jax.device_get(new_js))


def test_shared_iqn_step_matches_jax(rng, monkeypatch):
    """One IQN step on the shared models, the JAX head's taus drawn from
    the step's own keys and handed to the port (as
    ``tests/test_torch_iqn.py`` does)."""
    monkeypatch.setattr(pallas_attn, "_INTERPRET", True)
    jg, jd, opt_g, opt_d, js, ts = _state(rng, iqn=True)
    key = jax.random.PRNGKey(5)
    rng_zg, k_gen, rng_zd, k_real, k_fake = jax.random.split(key, 5)
    taus = [np.asarray(jax.random.uniform(k, (B * Q, 1), jnp.float32))
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
                         grad_penalty=5.0, ema_factor=EMA, dtype=jnp.float32)
    batch = rng.integers(0, 256, (B, 16, 16, 3), dtype=np.uint8)
    new_js, jm = jax.jit(jstep)(js, jnp.asarray(batch), key)
    assert next(drawn, None) is None
    z_d = np.asarray(jax.random.normal(rng_zd, (B, JCFG.latent_dims)))[None]
    z_g = np.asarray(jax.random.normal(rng_zg, (B, JCFG.latent_dims)))
    step = make_iqn_train_step(grad_penalty=5.0, ema_factor=EMA)
    tm = step(ts, torch.from_numpy(batch), torch.from_numpy(z_d.copy()),
              torch.from_numpy(z_g.copy()),
              torch.from_numpy(np.stack(taus[:2])[None]),
              torch.from_numpy(taus[2]))
    _hold_step(tm, jm, ts, jax.device_get(new_js))


# ------------------------------------------------------------ the trainers
@pytest.mark.parametrize("name", ["cnn", "iqn"])
def test_shared_entry_point_checkpoints_both_ways(tiny_archive, tmp_path,
                                                   name):
    """``python -m tartangan_torch.train.shared.{cnn,iqn} ... --device
    cpu`` trains 3 steps and writes a checkpoint that the JAX trainer's
    templates restore and its loader takes; the port resumes from a
    checkpoint the JAX trainer wrote, leaf for leaf."""
    port_mod, jcls = {"cnn": (shared_cnn, JaxSharedCNN),
                      "iqn": (shared_iqn, JaxSharedIQN)}[name]
    out = tmp_path / "out"
    port_mod.main(_argv(tiny_archive, out))
    ckpt = out / "testrun" / "checkpoints" / "3"
    assert (out / "testrun" / "samples" / "sample_3.png").exists()

    jargv = _argv(tiny_archive, out, "--run-id", "jax")
    jargv.remove("--device"), jargv.remove("cpu")
    jt = jcls.create_from_cli(jargv)
    jt.build_models()
    templates = jax.device_get(jt.checkpoint_artifacts())
    restored = {n: serialization.from_bytes(
        t, (ckpt / f"{n}.msgpack").read_bytes())
        for n, t in templates.items()}
    jt.load_checkpoint_artifacts(restored)
    assert int(jt.state.opt_d[0].count) == 3
    assert np.shape(restored["g"]["params"]["shared_filters"]) == (
        3, 3, 100, 64)

    # the JAX trainer's own (fresh) state as a step-5 checkpoint
    jckpt = out / "jax" / "checkpoints" / "5"
    jckpt.mkdir(parents=True)
    for n, tree in templates.items():
        (jckpt / f"{n}.msgpack").write_bytes(serialization.to_bytes(tree))
    (jckpt / "trainer.json").write_text(json.dumps({"epoch": 2, "steps": 5}))
    trainer = port_mod.__dict__[f"Shared{name.upper()}Trainer"] \
        .create_from_cli(_argv(tiny_archive, out, "--run-id", "jax",
                               "--resume-training-latest", "--epochs", "0"))
    trainer.train()
    assert trainer.steps == 5
    mine = trainer.checkpoint_artifacts()
    for n, tree in templates.items():
        for a, b in _zip_leaves(mine[n], serialization.to_state_dict(tree)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_shared_family_ignores_parity_and_remat(tiny_archive, tmp_path):
    """As the JAX builders, the family takes --parity-blocks, --remat and
    --g-base and builds the same shared models."""
    trainer = shared_cnn.SharedCNNTrainer.create_from_cli(_argv(
        tiny_archive, tmp_path / "out", "--parity-blocks", "on", "--remat",
        "--g-base", "tiledz"))
    trainer.build_models()
    assert isinstance(trainer.state.g, TS.SharedGenerator)
    assert isinstance(trainer.state.d, TS.SharedDiscriminator)
    assert trainer.state.g.layers[0] == "GeneratorInputMLP_0"


@pytest.mark.parametrize("name", ["cnn", "iqn"])
def test_shared_entry_points_need_cuda_by_default(tiny_archive, tmp_path,
                                                  name):
    """Without ``--device cpu`` the trainers ask for the card, and raise
    where there is none (this machine)."""
    argv = _argv(tiny_archive, tmp_path / "out")
    argv.remove("--device"), argv.remove("cpu")
    cls = {"cnn": shared_cnn.SharedCNNTrainer,
           "iqn": shared_iqn.SharedIQNTrainer}[name]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cls.create_from_cli(argv)
