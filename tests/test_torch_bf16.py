"""``--dtype bf16``: the port's bfloat16 compute against the JAX package's,
from the same numpy-seeded inputs and transplanted weights (parameters
float32 in both, flax's ``dtype`` / ``param_dtype`` split).

- K3, K4 and K5's plain bfloat16 versions (which the CUDA kernels are held
  to on the card) against the JAX kernels in interpret mode in bfloat16:
  within one bfloat16 ulp of the reference's max-abs, the unit in the last
  place of the largest value (the float32 sums before each rounding are
  taken in another order, so a value may land one ulp away);
- G and D forwards in bfloat16 on the parity path (``FUSED_G``, a fused
  block, the parity D chain and the attention) against the JAX models in
  bfloat16, applied op by op (not jitted, so each op rounds as flax's casts
  say; see the step below) (``TOL_FORWARD``);
- one bfloat16 train step with the parity blocks, ``FUSED_G`` and a fused
  block against the JAX package's bfloat16 step, in the pattern of
  ``test_torch_parity_train.py``: the port's distance from the port's
  float64 step is at most 3 times the JAX step's (gradients as Adam's
  first moment, per tower, max and norm; losses likewise, or 1e-3 of them);
  new parameters agree to 2 lr (and float32 rounding); BatchNorm's
  statistics, Adam's moments and the EMA target stay float32. The JAX
  step is compiled with XLA's ``xla_allow_excess_precision`` off, so that
  it rounds to bfloat16 where flax's casts say: with it on (XLA's default)
  the jitted step skips roundings, and lands nearer float64 than bfloat16
  does (D's gradient 0.135 of its norm from float64 on this draw, against
  0.463 with the option off and 0.467 for the port, which rounds at every
  cast);
- R1's second derivative of one bfloat16 conv on the CPU against float64
  (the oneDNN fault that ``utils/precision.py::apply_in_dtype`` avoids);
- ``python -m tartangan_torch.train.cnn ... --dtype bf16 --device cpu``
  trains, samples, checkpoints in float32 and resumes.
"""
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
from tartangan_tpu.ops.pallas import gblock as JG
from tartangan_tpu.train.cnn import make_cnn_train_step as jax_train_step
from tartangan_tpu.train.common import make_adam as jax_adam
from tartangan_tpu.train.state import GANTrainState as JaxState
from tartangan_torch.configs import GAN_CONFIGS
from tartangan_torch.convert import adam_to_flax, from_flax, to_flax
from tartangan_torch.models import blocks
from tartangan_torch.models import factories as F
from tartangan_torch.models.attention import SelfAttention2d
from tartangan_torch.models.pluggan import Discriminator, Generator
from tartangan_torch.ops import gblock as G
from tartangan_torch.ops import parity
from tartangan_torch.ops import parity_conv as PC
from tartangan_torch.ops.parity import depth_to_space
from tartangan_torch.train.cnn import CNNTrainer, main, make_cnn_train_step
from tartangan_torch.train.common import make_adam
from tartangan_torch.train.state import GANTrainState

BF = torch.bfloat16
# G blocks: a plain first block, a fused block (80 > 64), two parity blocks
# with the attention between them; D: parity blocks, chained, then plain
JCFG = dataclasses.replace(JAX_GAN_CONFIGS["16"], blocks=(80, 80, 16, 8),
                           base_size=2, attention=(2,))
CFG = dataclasses.replace(GAN_CONFIGS["16"], blocks=(80, 80, 16, 8),
                          base_size=2, attention=(2,))
LR_G, LR_D, EMA = 1e-4, 4e-4, 1e-3
B, SIZE = 4, 32
# G's images and D's logits, port against JAX, both bfloat16: each block
# rounds to bfloat16 (2^-8 relative) at every layer, and the fused block
# rounds where the TPU kernel does in the port but where the reference form
# does in JAX on the CPU, so the two differ by a few roundings carried
# through BatchNorm'd blocks; over the output's max-abs (about four ulps of
# an image's max-abs of 1; measured 2.3e-2 for G in train mode, 4.3e-3 or
# less for G in eval mode and D)
TOL_FORWARD = 3e-2
# the port's bfloat16 step's distance from float64 over the JAX one's
STEP_FACTOR = 3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf(a):
    """A float32 numpy array as a bfloat16 tensor (round to nearest even,
    as ``jnp.asarray(a, jnp.bfloat16)`` rounds it)."""
    return _t(np.asarray(a, np.float32)).to(BF)


def _np(t):
    return np.asarray(t.float().detach().numpy(), np.float64) \
        if torch.is_tensor(t) else np.asarray(t, np.float64)


def _oihw(w):
    return _t(np.asarray(w).transpose(3, 2, 0, 1))


def _within_one_ulp(out, ref):
    """|out - ref| <= one bfloat16 ulp of the reference's max-abs."""
    out, ref = _np(out), _np(ref)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    err = np.abs(out - ref).max()
    assert err <= ulp, (err, ulp)


def _zip_leaves(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    return zip(la, lb)


# --------------------------------------------- (a) the kernels' plain forms
@pytest.mark.parametrize("mode", ["up", "full"])
@pytest.mark.parametrize("shape", [(2, 6, 6, 8, 5), (2, 5, 9, 3, 4)])
def test_k3_bf16_plain_matches_jax_interpret(rng, monkeypatch, mode, shape):
    monkeypatch.setattr(jpc, "_INTERPRET", True)
    b, h, w, cin, cout = shape
    ci = cin if mode == "up" else 4 * cin
    x = rng.standard_normal((b, h, w, ci)).astype(np.float32)
    wt = (0.1 * rng.standard_normal((3, 3, cin, cout))).astype(np.float32)
    bias = rng.standard_normal((cout,)).astype(np.float32)
    ref = jpc.fused_parity_conv(jnp.asarray(x, jnp.bfloat16), jnp.asarray(wt),
                                jnp.asarray(bias), cout, mode)
    assert ref.dtype == jnp.bfloat16
    out = PC.merged_tap_conv(_bf(x), _oihw(wt), cout, mode, bias=_t(bias))
    assert out.dtype == BF
    _within_one_ulp(out, ref.astype(jnp.float32))


@pytest.mark.parametrize("cin,cout", [(12, 8), (8, 8)])
def test_k4_k5_bf16_plain_match_jax_interpret(rng, cin, cout):
    """y1p (bfloat16), the float32 statistics from the rounded y1p, and the
    output, projected and identity shortcuts; K5 fed JAX's y1p and
    statistics."""
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    p = {"w1": 0.1 * r(3, 3, cin, cout), "b1": r(cout),
         "w2": 0.1 * r(3, 3, cout, cout), "b2": r(cout),
         "s1": 1 + 0.2 * r(cin), "o1": 0.2 * r(cin),
         "s2": 1 + 0.2 * r(cout), "o2": 0.2 * r(cout)}
    if cin == cout:
        p["wp"], p["bp"] = np.eye(cin, dtype=np.float32), np.zeros(
            cout, np.float32)
    else:
        p["wp"], p["bp"] = 0.1 * r(cin, cout), r(cout)
    x = r(3, 6, 6, cin)
    out_ref, y1_ref, stats_ref = JG._fused_gblock_fwd_impl(
        jnp.asarray(x, jnp.bfloat16),
        {k: jnp.asarray(v) for k, v in p.items()}, interpret=True)
    assert y1_ref.dtype == out_ref.dtype == jnp.bfloat16
    q = {k: _oihw(v) if k in ("w1", "w2") else _t(v) for k, v in p.items()}
    if cin == cout:
        q["wp"] = q["bp"] = None
    xt = _bf(x)
    m1, v1 = G._moments(xt)
    for a, r_ in zip((m1, v1), stats_ref[:2]):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(r_), rtol=1e-5,
                                   atol=1e-6)
    y1p, sums = G.gblock_a(xt, m1, v1, q["s1"], q["o1"], q["w1"], q["b1"])
    assert y1p.dtype == BF and sums.dtype == torch.float32
    _within_one_ulp(y1p, y1_ref.astype(jnp.float32))
    n = 4 * 3 * 6 * 6
    s4 = sums.reshape(2, 4, cout).sum(1)
    m2, v2 = s4[0] / n, s4[1] / n - (s4[0] / n).square()
    # statistics of bfloat16 values: a value one ulp away moves them by
    # less than 2^-8 of one term over n
    for a, r_ in zip((m2, v2), stats_ref[2:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(r_), rtol=1e-3,
                                   atol=1e-4)
    jy1 = _t(np.asarray(y1_ref.astype(jnp.float32))).to(BF)
    jm2, jv2 = (_t(np.asarray(s)) for s in stats_ref[2:])
    out_p = G.gblock_b(jy1, xt, jm2, jv2, q["s2"], q["o2"], q["w2"], q["b2"],
                       q["wp"], q["bp"])
    assert out_p.dtype == BF
    out = depth_to_space(out_p.permute(0, 3, 1, 2), cout).permute(0, 2, 3, 1)
    _within_one_ulp(out, out_ref.astype(jnp.float32))


def test_cpu_bf16_conv_second_derivative():
    """R1's second derivative of a bfloat16 conv on the CPU (the weight
    gradient of the squared input gradient) against float64: within 1e-2
    of its norm (bfloat16 rounds at 2^-9 relative, over 16 x 9 products a
    sum). oneDNN's bfloat16 convolution with a kernel spanning the padded
    input, which autograd runs for this derivative, was measured 76 % off;
    the port's ``Conv`` on the CPU runs in float32 on the rounded operands
    (``utils/precision.py::apply_in_dtype``)."""
    from tartangan_torch.models.layers import Conv
    gen = torch.Generator().manual_seed(0)
    x0 = torch.randn(8, 16, 16, 16, generator=gen, dtype=torch.float64)
    wo = 0.1 * torch.randn(16, generator=gen, dtype=torch.float64)
    conv = Conv(16, 16, 3)
    grads = {}
    for dtype in (torch.float64, BF):
        conv.zero_grad()
        x = x0.to(dtype).requires_grad_()
        wide = torch.promote_types(dtype, torch.float32)
        y = conv.double()(x) if dtype == torch.float64 else conv.float()(x)
        s = (y.to(wide) * wo.to(wide)[None, :, None, None]).sum()
        (gx,) = torch.autograd.grad(s, x, create_graph=True)
        gx.to(wide).square().sum().backward()
        assert conv.weight.grad.dtype == wide
        grads[dtype] = conv.weight.grad.double()
    exact = grads[torch.float64]
    assert ((grads[BF] - exact).norm() / exact.norm()).item() <= 1e-2


# ----------------------------------------------------- (b) G and D forwards
def _jax_models(dtype):
    g = JaxGenerator(JCFG, input_factory=JF.g_input_factory("mlp", "relu"),
                     block_factory=JF.g_block_factory(
                         "bn", "relu", parity=True, fused=True),
                     output_factory=JF.g_output_factory("bn", "relu"),
                     dtype=dtype)
    d = JaxDiscriminator(JCFG, block_factory=JF.d_block_factory(
        "bn", "relu", parity=True),
        output_factory=JF.d_output_factory("bn", "relu"), dtype=dtype)
    return g, d


def _torch_models(dtype):
    g = Generator(CFG, input_factory=F.g_input_factory("mlp", "relu"),
                  block_factory=F.g_block_factory("bn", "relu", parity=True,
                                                  fused=True),
                  output_factory=F.g_output_factory("bn", "relu"),
                  dtype=dtype)
    d = Discriminator(CFG, input_factory=F.d_input_factory(),
                      block_factory=F.d_block_factory("bn", "relu",
                                                      parity=True),
                      output_factory=F.d_output_factory("bn", "relu"),
                      dtype=dtype)
    return g, d


def _variables(rng):
    g, d = _jax_models(jnp.float32)
    g_vars = jax.device_get(g.init(jax.random.PRNGKey(0),
                                   jnp.zeros((2, JCFG.latent_dims)),
                                   train=True))
    d_vars = jax.device_get(d.init(jax.random.PRNGKey(1),
                                   jnp.zeros((2, SIZE, SIZE, 3)), train=True))
    # attention on in both towers; running statistics off their init
    g_vars["params"]["blocks_3"]["gamma"] = np.array(0.6, np.float32)
    d_vars["params"]["blocks_2"]["gamma"] = np.array(-0.7, np.float32)
    for v in (g_vars, d_vars):
        v["batch_stats"] = jax.tree_util.tree_map(
            lambda a: np.abs(a + 0.2 * rng.standard_normal(a.shape))
            .astype(np.float32), v["batch_stats"])
    return g_vars, d_vars


def _loaded(g_vars, d_vars, dtype):
    g, d = _torch_models(dtype)
    g.load_state_dict(from_flax(g_vars))
    d.load_state_dict(from_flax(d_vars))
    return g, d


@pytest.mark.parametrize("train", [True, False])
def test_generator_and_discriminator_bf16_match_jax(rng, monkeypatch, train):
    """Train-mode (batch statistics) and eval-mode (running statistics, the
    fused block on its reference form) forwards, images in [-1, 1] and
    logits, each over its max-abs."""
    monkeypatch.setattr(jpc, "_INTERPRET", True)
    monkeypatch.setattr(jparity, "FUSED_G", True)
    monkeypatch.setattr(parity, "FUSED_G", True)
    g_vars, d_vars = _variables(rng)
    jg, jd = _jax_models(jnp.bfloat16)
    g, d = _loaded(g_vars, d_vars, BF)
    assert [type(b) for b in g.blocks] == [
        blocks.ResidualGeneratorBlock, blocks.FusedResidualGeneratorBlock,
        blocks.ParityResidualGeneratorBlock, type(g.blocks[3]),
        blocks.ParityResidualGeneratorBlock]
    z = rng.standard_normal((B, JCFG.latent_dims)).astype(np.float32)
    img_ref = jg.apply(g_vars, jnp.asarray(z), train=train,
                       mutable=["batch_stats"])[0]
    assert img_ref.dtype == jnp.bfloat16
    with torch.no_grad():
        img = g(_t(z), train=train)
    assert img.dtype == BF
    img_ref = np.asarray(img_ref.astype(jnp.float32)).transpose(0, 3, 1, 2)
    err = np.abs(_np(img) - img_ref).max() / np.abs(img_ref).max()
    assert err <= TOL_FORWARD, err
    # D on the same bfloat16 images (JAX's), cast by D itself
    logits_ref = jd.apply(d_vars, jnp.asarray(img_ref.transpose(0, 2, 3, 1)),
                          train=train, mutable=["batch_stats"])[0]
    with torch.no_grad():
        logits = d(_t(img_ref.astype(np.float32)), train=train)
    assert logits.dtype == BF and logits_ref.dtype == jnp.bfloat16
    ref = np.asarray(logits_ref.astype(jnp.float32))
    err = np.abs(_np(logits) - ref).max() / np.abs(ref).max()
    assert err <= TOL_FORWARD, err


# ------------------------------------------------------- (c) one train step
def _jax_state(rng):
    g_vars, d_vars = _variables(rng)
    opt_g, opt_d = jax_adam(LR_G), jax_adam(LR_D)
    target = jax.tree_util.tree_map(
        lambda a: (a + 0.01 * rng.standard_normal(a.shape)).astype(np.float32),
        g_vars["params"])
    return opt_g, opt_d, JaxState(
        g_params=g_vars["params"], g_stats=g_vars["batch_stats"],
        target_g_params=target, d_params=d_vars["params"],
        d_stats=d_vars["batch_stats"], opt_g=opt_g.init(g_vars["params"]),
        opt_d=opt_d.init(d_vars["params"]))


def _torch_state(js, dtype):
    g, d = _loaded({"params": js.g_params, "batch_stats": js.g_stats},
                   {"params": js.d_params, "batch_stats": js.d_stats}, dtype)
    g_target, _ = _torch_models(dtype)
    g_target.load_state_dict(from_flax({"params": js.target_g_params}),
                             strict=False)
    return GANTrainState(g=g, g_target=g_target, d=d,
                         opt_g=make_adam(g.parameters(), LR_G),
                         opt_d=make_adam(d.parameters(), LR_D))


def _distance(grads, exact):
    """{"max", "norm"} of one gradient tree against the float64 one: the
    max abs error over the float64 max-abs, and the norm of the difference
    over the float64 norm."""
    pairs = [(np.asarray(a, np.float64), np.asarray(b, np.float64))
             for a, b in _zip_leaves(grads, exact)]
    scale = max(np.abs(b).max() for _, b in pairs)
    diff2 = sum(np.square(a - b).sum() for a, b in pairs)
    norm2 = sum(np.square(b).sum() for _, b in pairs)
    return {"max": max(np.abs(a - b).max() for a, b in pairs) / scale,
            "norm": float(np.sqrt(diff2 / norm2))}


def test_bf16_parity_train_step_matches_jax(rng, monkeypatch):
    monkeypatch.setattr(jpc, "_INTERPRET", True)
    monkeypatch.setattr(jparity, "FUSED_G", True)
    monkeypatch.setattr(parity, "FUSED_G", True)
    opt_g, opt_d, js = _jax_state(rng)
    jg, jd = _jax_models(jnp.bfloat16)
    jstep = jax_train_step(jg, jd, opt_g, opt_d,
                           latent_dims=JCFG.latent_dims, grad_penalty=5.0,
                           ema_factor=EMA, dtype=jnp.bfloat16)
    batch = rng.integers(0, 256, (B, SIZE, SIZE, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(5)
    rng_zg, _, *d_keys = jax.random.split(key, 4)
    z_d = np.asarray(jax.random.normal(d_keys[0], (B, JCFG.latent_dims)))
    z_g = np.asarray(jax.random.normal(rng_zg, (B, JCFG.latent_dims)))
    new_js, jm = jax.jit(jstep).lower(js, jnp.asarray(batch), key).compile(
        compiler_options={"xla_allow_excess_precision": False})(
        js, jnp.asarray(batch), key)
    new_js = jax.device_get(new_js)

    runs = {}
    for dtype in (BF, torch.float64):
        ts = _torch_state(js, dtype)
        if dtype == torch.float64:
            # the plain forms in float64: the kernels take float32 and
            # bfloat16 only (the plain attention's softmax stays float32)
            monkeypatch.setattr(parity, "FUSED_G", False)
            for model in (ts.g, ts.g_target, ts.d):
                model.double()
            for m in list(ts.g.modules()) + list(ts.d.modules()):
                if isinstance(m, (blocks.FusedResidualGeneratorBlock,
                                  SelfAttention2d)):
                    m.use_kernel = False
        step = make_cnn_train_step(grad_penalty=5.0, ema_factor=EMA,
                                   dtype=dtype)
        metrics = step(ts, _t(batch), _t(z_d[None]), _t(z_g))
        runs[dtype] = ts, {k: float(v) for k, v in metrics.items()}
    ts, tm = runs[BF]
    exact, m64 = runs[torch.float64]

    jadam = {"g": serialization.to_state_dict(new_js.opt_g)["0"]["mu"],
             "d": serialization.to_state_dict(new_js.opt_d)["0"]["mu"]}
    for tag, mod, opt, mod64, opt64 in (
            ("g", ts.g, ts.opt_g, exact.g, exact.opt_g),
            ("d", ts.d, ts.opt_d, exact.d, exact.opt_d)):
        mu = adam_to_flax(mod, opt)["0"]["mu"]
        mu64 = adam_to_flax(mod64, opt64)["0"]["mu"]
        ours, theirs = _distance(mu, mu64), _distance(jadam[tag], mu64)
        for k in ours:
            assert ours[k] <= STEP_FACTOR * theirs[k], (tag, k, ours, theirs)
    for name in ("d_loss", "g_loss", "gp"):
        assert abs(tm[name] - m64[name]) <= \
            STEP_FACTOR * abs(float(jm[name]) - m64[name]) + 1e-3 * abs(
                m64[name]), (name, tm[name], float(jm[name]), m64[name])

    for mod, opt, jparams, lr in ((ts.g, ts.opt_g, new_js.g_params, LR_G),
                                  (ts.d, ts.opt_d, new_js.d_params, LR_D)):
        # Adam's first step moves a weight by about +-lr; where a gradient's
        # sign differs between the two bfloat16 steps, by 2 lr, plus the
        # float32 rounding of the weight
        tree = to_flax(mod)
        for a, b in _zip_leaves(tree["params"], jparams):
            np.testing.assert_allclose(a, b, rtol=0, atol=2 * lr + 1e-6)
        # parameters, statistics and Adam's moments stay float32
        assert {t.dtype for t in list(mod.parameters())
                + list(mod.buffers())} == {torch.float32}
        assert {v.dtype for st in opt.state.values() for v in st.values()
                if v.dim()} == {torch.float32}
    assert {p.dtype for p in ts.g_target.parameters()} == {torch.float32}
    for a, b in _zip_leaves(to_flax(ts.g_target)["params"],
                            new_js.target_g_params):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ (d) the CLI
def test_entry_point_trains_in_bf16(tiny_archive, tmp_path):
    """``--dtype bf16 --device cpu`` with the parity blocks: trains,
    samples, writes a float32 checkpoint in the JAX layout and resumes
    from it."""
    argv = [tiny_archive, "--config", "16", "--batch-size", "8", "--epochs",
            "1", "--output", str(tmp_path / "out"), "--gen-freq", "2",
            "--checkpoint-freq", "2", "--run-id", "brun", "--dtype", "bf16",
            "--quiet-logs", "--device", "cpu", "--parity-blocks", "on"]
    main(argv)
    out = tmp_path / "out" / "brun"
    samples = sorted(p.name for p in (out / "samples").iterdir())
    assert "sample_3.png" in samples and "grid_sample_3.png" in samples
    ckpt = out / "checkpoints" / "3"
    assert json.loads((ckpt / "trainer.json").read_text())["steps"] == 3
    from tartangan_torch.utils import msgpack
    saved = {}
    for name in ("g", "g_target", "d", "opt_g", "opt_d"):
        saved[name] = msgpack.loads((ckpt / f"{name}.msgpack").read_bytes())
        leaves = jax.tree_util.tree_leaves(saved[name])
        assert {np.asarray(a).dtype for a in leaves
                if np.asarray(a).dtype.kind == "f"} == {np.dtype("float32")}
    trainer = CNNTrainer.create_from_cli(argv + ["--resume-training-latest",
                                                 "--epochs", "0"])
    trainer.train()
    assert trainer.steps == 3 and trainer.dtype == BF
    assert trainer.state.g.dtype == trainer.state.d.dtype == BF
    resumed = trainer.checkpoint_artifacts()
    for name in ("g", "d", "opt_g", "opt_d"):
        for a, b in _zip_leaves(resumed[name], saved[name]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    imgs = trainer.sample_g(3)
    assert imgs.dtype == np.float32 and np.isfinite(imgs).all()
