"""The port's InfoGAN trainer (``tartangan_torch/train/info.py``), its
two-headed discriminator and sampler, against the JAX package's.

The JAX step draws its latent codes from its key; the test draws the
same z with the JAX package's ``sample_info_z`` from the step's own keys
and hands them to the port. Tolerances (float32) as
``tests/test_torch_train.py`` states them: losses, code losses and gp
1e-4 relative; Adam's moments 1e-4 of the gradient's max-abs; parameters
2·lr per Adam step; statistics 1e-5 + lr; the EMA target 1e-5. The
discriminator on the same weights: 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import tartangan_tpu.ops.pallas.attention as pallas_attn
from tartangan_tpu.models import factories as JF
from tartangan_tpu.models.pluggan import Discriminator as JaxDiscriminator
from tartangan_tpu.models.pluggan import Generator as JaxGenerator
from tartangan_tpu.train.common import make_adam as jax_adam
from tartangan_tpu.train.info import make_info_train_step as jax_info_step
from tartangan_tpu.train.info import sample_info_z as jax_sample_info_z
from tartangan_tpu.train.state import GANTrainState as JaxState
from tartangan_torch.convert import adam_to_flax, from_flax, to_flax
from tartangan_torch.models import factories as F
from tartangan_torch.models.pluggan import Discriminator, Generator
from tartangan_torch.train.common import make_adam
from tartangan_torch.train.info import (
    InfoTrainer,
    main,
    make_info_train_step,
    sample_info_z,
)
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

CAT, CONT, INFO_W = 3, 2, 0.7


@pytest.mark.parametrize("lead,cat", [((5,), 4), ((2, 3, 6), 10), ((7,), 0)])
def test_sample_info_z_structure(lead, cat):
    """The first ``cat`` dimensions a one-hot, the rest N(0, 1) draws."""
    gen = torch.Generator().manual_seed(0)
    z = sample_info_z(gen, lead, 32, cat)
    assert z.shape == lead + (32,) and z.dtype == torch.float32
    if cat:
        code = z[..., :cat]
        assert torch.all((code == 0) | (code == 1))
        assert torch.all(code.sum(-1) == 1)
    rest = z[..., cat:]
    assert not torch.all((rest == 0) | (rest == 1))
    # the same generator state gives the same draw
    again = sample_info_z(torch.Generator().manual_seed(0), lead, 32, cat)
    assert torch.equal(z, again)


def _jax_models():
    g = JaxGenerator(JCFG, input_factory=JF.g_input_factory("mlp", "relu"),
                     block_factory=JF.g_block_factory("bn", "relu"),
                     output_factory=JF.g_output_factory("bn", "relu"))
    d = JaxDiscriminator(
        JCFG, block_factory=JF.d_block_factory("bn", "relu"),
        output_factory=JF.info_d_output_factory("bn", "relu", CAT + CONT))
    return g, d


def _torch_models():
    g = Generator(CFG, input_factory=F.g_input_factory("mlp", "relu"),
                  block_factory=F.g_block_factory("bn", "relu"),
                  output_factory=F.g_output_factory("bn", "relu"))
    d = Discriminator(
        CFG, input_factory=F.d_input_factory(),
        block_factory=F.d_block_factory("bn", "relu"),
        output_factory=F.info_d_output_factory("bn", "relu", CAT + CONT))
    return g, d


def _jax_state(rng):
    g, d = _jax_models()
    g_vars = jax.device_get(g.init(jax.random.PRNGKey(0),
                                   jnp.zeros((2, JCFG.latent_dims)),
                                   train=True))
    d_vars = jax.device_get(d.init(jax.random.PRNGKey(1),
                                   jnp.zeros((2, 16, 16, 3)), train=True))
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


def test_info_step_matches_jax(rng, monkeypatch):
    monkeypatch.setattr(pallas_attn, "_INTERPRET", True)
    jg, jd, opt_g, opt_d, js = _jax_state(rng)
    jstep = jax_info_step(jg, jd, opt_g, opt_d, latent_dims=JCFG.latent_dims,
                          cat_dims=CAT, cont_dims=CONT, info_w=INFO_W,
                          grad_penalty=5.0, ema_factor=EMA,
                          dtype=jnp.float32)
    batch = rng.integers(0, 256, (B, 16, 16, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(5)
    # the JAX step's own codes: rng_zg, *d_keys = split(rng, 1 + iters_d)
    rng_zg, k_d = jax.random.split(key, 2)
    z_d = np.asarray(jax_sample_info_z(k_d, B, JCFG.latent_dims, CAT))[None]
    z_g = np.asarray(jax_sample_info_z(rng_zg, B, JCFG.latent_dims, CAT))
    ts = _torch_state(js)
    new_js, jm = jax.jit(jstep)(js, jnp.asarray(batch), key)
    new_js = jax.device_get(new_js)
    step = make_info_train_step(cat_dims=CAT, cont_dims=CONT, info_w=INFO_W,
                                grad_penalty=5.0, ema_factor=EMA)
    tm = step(ts, torch.from_numpy(batch), torch.from_numpy(z_d.copy()),
              torch.from_numpy(z_g.copy()))
    assert set(tm) == set(jm)
    for name in jm:
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    assert float(tm["d_code_loss"]) > 0 and float(tm["gp"]) > 0
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


def test_info_discriminator_round_trips_through_convert(rng, monkeypatch):
    """A JAX InfoGAN D's variables -> the port (every key, strict) -> back
    to the same tree; both give the same logits and codes on one batch,
    and a port-made tree loads into the JAX module."""
    monkeypatch.setattr(pallas_attn, "_INTERPRET", True)
    _, jd = _jax_models()
    jvars = jax.device_get(jd.init(jax.random.PRNGKey(2),
                                   jnp.zeros((2, 16, 16, 3)), train=True))
    jvars["params"]["blocks_1"]["gamma"] = np.array(0.4, np.float32)
    _, d = _torch_models()
    d.load_state_dict(from_flax(jvars))
    back = to_flax(d)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jvars)
    for a, b in _zip_leaves(back, jvars):
        np.testing.assert_array_equal(a, b)
    x = rng.standard_normal((B, 16, 16, 3)).astype(np.float32)
    (logits, codes), _ = jd.apply(back, jnp.asarray(x), train=True,
                                  mutable=["batch_stats"])
    got_logits, got_codes = d(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got_codes.shape == (B, CAT + CONT)
    np.testing.assert_allclose(got_logits.detach().numpy(),
                               np.asarray(logits), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_codes.detach().numpy(),
                               np.asarray(codes), rtol=1e-5, atol=1e-5)


def test_info_entry_point_trains_samples_and_resumes(tiny_archive, tmp_path):
    """``python -m tartangan_torch.train.info ... --device cpu``: the
    losses and code losses finite, the sampler's two grids beside the
    image sampler's panels, a checkpoint that resumes."""
    flags = ("--info-cat-dims", "4", "--info-cont-dims", "3")
    main(_argv(tiny_archive, tmp_path / "out", *flags))
    out = tmp_path / "out" / "testrun"
    names = {p.name for p in (out / "samples").iterdir()}
    for name in ("sample_3.png", "grid_sample_3.png",
                 "info_cat_sample_3.png", "info_cont_sample_3.png"):
        assert name in names
    trainer = InfoTrainer.create_from_cli(_argv(
        tiny_archive, tmp_path / "out", *flags, "--resume-training-latest",
        "--epochs", "2", "--gen-freq", "100"))
    trainer.train()
    assert trainer.steps == 6
    for key in ("g_loss", "g_code_loss", "d_loss", "d_code_loss", "gp"):
        vals = [float(v) for v in trainer.logs[key]]
        assert len(vals) == 3 and np.all(np.isfinite(vals))
    assert all(v > 0 for v in trainer.logs["d_code_loss"])


@pytest.mark.parametrize("head", ["pool sum", "pool avg", "pool conv",
                                  "gaussian"])
def test_other_heads_match_jax(rng, head):
    """The heads beside InfoGAN's (``DiscriminatorPoolOnlyOutput`` with
    each pooling, ``GaussianParametersOutput``) against the JAX blocks on
    the same weights, train-mode BatchNorm: 1e-5."""
    from tartangan_tpu.models import blocks as jblocks
    from tartangan_torch.models import blocks as tblocks
    if head == "gaussian":
        x = rng.standard_normal((3, 12)).astype(np.float32)
        jmod, mod = (jblocks.GaussianParametersOutput(12, 5),
                     tblocks.GaussianParametersOutput(12, 5))
        xt = torch.from_numpy(x)
    else:
        pool = head.split()[1]
        x = rng.standard_normal((2, 8, 8, 6)).astype(np.float32)
        jmod = jblocks.DiscriminatorPoolOnlyOutput(6, 4, pool=pool)
        mod = tblocks.DiscriminatorPoolOnlyOutput(6, 4, pool=pool)
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    variables = jax.device_get(jmod.init(jax.random.PRNGKey(0),
                                         jnp.asarray(x)))
    want, _ = jmod.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    mod.load_state_dict(from_flax(variables))
    got = mod(xt)
    if head == "pool conv":  # the feature map, NCHW here
        got = got.permute(0, 2, 3, 1)
    for a, b in zip(got if head == "gaussian" else [got],
                    want if head == "gaussian" else [want]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-5, atol=1e-5)
