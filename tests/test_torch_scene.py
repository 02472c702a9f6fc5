"""The port's scene family (``tartangan_torch/ops/grid_sample.py``,
``models/scene.py``, ``train/scene.py``) against the JAX package's, on the
same weights (through ``convert.py``), inputs and patch noise.

The JAX structure block draws its patch noise from a "scene" key inside
the model; the port takes it as an argument. These tests replace
``jax.random.normal`` in the JAX scene module with draws made beforehand,
handed out in the order the JAX code traces its generator applies (the D
step's fakes, then the G step), and give the port the same draws.

Tolerances (float32): ``affine_grid``, ``grid_sample``, the structure
block and the patch 1e-6 absolute (coordinates and bilinear weights of
order 1); the generators' outputs and batch statistics 1e-4 of the
reference's max-abs (the canvas of placed masks is mostly exact zeros, and
BatchNorm over it divides by a small batch deviation, magnifying the
float32 rounding of the convs: measured up to 4.4e-5 on these draws); the
step as ``tests/test_torch_train.py`` states it.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import tartangan_tpu.models.scene as jscene
import tartangan_tpu.ops.pallas.attention as pallas_attn
from tartangan_tpu.configs import GANConfig as JaxGANConfig
from tartangan_tpu.models import factories as JF
from tartangan_tpu.models.pluggan import Discriminator as JaxDiscriminator
from tartangan_tpu.ops import grid_sample as jgs
from tartangan_tpu.train.cnn import make_cnn_train_step as jax_cnn_step
from tartangan_tpu.train.common import make_adam as jax_adam
from tartangan_tpu.train.scene import SceneTrainer as JaxSceneTrainer
from tartangan_tpu.train.state import GANTrainState as JaxState
from tartangan_torch.configs import GANConfig
from tartangan_torch.convert import from_flax, to_flax
from tartangan_torch.models import factories as F
from tartangan_torch.models import scene as TS
from tartangan_torch.models.layers import update_batch_stats
from tartangan_torch.models.pluggan import Discriminator
from tartangan_torch.ops import grid_sample as tgs
from tartangan_torch.train.cnn import make_cnn_train_step
from tartangan_torch.train.common import make_adam
from tartangan_torch.train.scene import SceneTrainer, main
from tartangan_torch.train.state import GANTrainState

from test_torch_shared import _hold_step, _perturb
from test_torch_train import B, EMA, LR_D, LR_G, _argv, _zip_leaves

# G from a 4x4 scene of 4 patches: blocks[0:] up to 16x16, attention after
# the first of them
KW = dict(base_size=4, latent_dims=16, data_dims=3, blocks=(8, 8),
          num_blocks_per_scale=1, attention=(0,))
SCENE = dict(scene_size=4, patch_size=3, num_patches=4)
TOL_G = 1e-4


def _close(ours, ref, tol=TOL_G):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(ours / scale, ref / scale, rtol=0, atol=tol)


def _np(t):
    return t.detach().float().numpy()


@pytest.fixture
def fed_noise(monkeypatch):
    """Patch noises handed to the JAX scene module in order: fill the list
    with (ps, ps) arrays before the JAX apply is traced (an empty list
    draws as JAX does, for the inits)."""
    queue = []

    class _Random:
        @staticmethod
        def normal(*args, **kwargs):
            if not queue:
                return jax.random.normal(*args, **kwargs)
            return jnp.asarray(queue.pop(0))

        def __getattr__(self, name):
            return getattr(jax.random, name)

    class _Jax:
        random = _Random()

        def __getattr__(self, name):
            return getattr(jax, name)
    monkeypatch.setattr(jscene, "jax", _Jax())
    return queue


# ---------------------------------------------------------- grid sampling
SIZES = [(5, 7), (1, 4), (3, 1)]


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("hw", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_affine_grid_matches_jax(rng, align_corners, hw):
    """The JAX base grid, an axis of length 1 included (-1 there, where
    ATen's ``F.affine_grid`` gives 0)."""
    theta = (1.5 * rng.standard_normal((3, 2, 3))).astype(np.float32)
    want = jgs.affine_grid(jnp.asarray(theta), (3, *hw), align_corners)
    got = tgs.affine_grid(torch.from_numpy(theta), (3, *hw), align_corners)
    assert got.shape == (3, *hw, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("hw", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_grid_sample_matches_jax(rng, align_corners, hw):
    """Bilinear samples with zero padding, NHWC, at coordinates inside and
    well outside [-1, 1], from inputs of every size above."""
    x = rng.standard_normal((3, *hw, 2)).astype(np.float32)
    grid = (1.6 * rng.uniform(-1, 1, (3, 6, 5, 2))).astype(np.float32)
    assert np.abs(grid).max() > 1.2
    want = jgs.grid_sample(jnp.asarray(x), jnp.asarray(grid), align_corners)
    got = tgs.grid_sample(torch.from_numpy(x), torch.from_numpy(grid),
                          align_corners)
    assert got.shape == (3, 6, 5, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


# ------------------------------------------------------------- the blocks
@pytest.mark.parametrize("refine", [False, True])
@pytest.mark.parametrize("noise", [False, True])
def test_structure_block_matches_jax(rng, fed_noise, refine, noise):
    """P masks placed on the scene canvas, (B, P, S, S) against JAX's
    (B, S, S, P); ``patch_transforms`` away from their identity init."""
    jm = jscene.SceneStructureBlock(16, num_patches=4, patch_size=3,
                                    scene_size=8, refine_patches=refine,
                                    patch_noise=noise)
    key = jax.random.PRNGKey(0)
    draw = rng.standard_normal((3, 3)).astype(np.float32)
    variables = jax.device_get(jm.init({"params": key, "scene": key},
                                       jnp.zeros((2, 16))))
    variables["params"]["patch_transforms"]["kernel"] = (
        0.3 * rng.standard_normal((16, 24))).astype(np.float32)
    z = rng.standard_normal((B, 16)).astype(np.float32)
    fed_noise[:] = [draw]
    want = jm.apply(variables, jnp.asarray(z), rngs={"scene": key})
    tm = TS.SceneStructureBlock(16, num_patches=4, patch_size=3,
                                scene_size=8, refine_patches=refine,
                                patch_noise=noise)
    tm.load_state_dict(from_flax(variables))
    got = tm(torch.from_numpy(z), noise=torch.from_numpy(draw)
             if noise else None)
    np.testing.assert_allclose(_np(got.permute(0, 2, 3, 1)),
                               np.asarray(want), rtol=0, atol=1e-6)
    if noise:
        with pytest.raises(ValueError):
            tm(torch.from_numpy(z))


def test_structure_block_init():
    """Zero weights and a bias of identity x 2 for every patch."""
    tm = TS.SceneStructureBlock(16, num_patches=3)
    tm.patch_transforms.init_parameters_(torch.Generator().manual_seed(0))
    assert not tm.patch_transforms.weight.detach().any()
    np.testing.assert_array_equal(tm.patch_transforms.bias.detach().numpy(),
                                  np.tile([2, 0, 0, 0, 2, 0], 3))


def test_scene_patch_matches_jax(rng):
    """The tanh patch times its alpha and the alpha, placed on the
    canvas."""
    jm = jscene.ScenePatch(16, 4, 3)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                       jnp.zeros((2, 16)), (8, 8)))
    variables = jax.tree_util.tree_map(
        lambda a: (a + 0.3 * rng.standard_normal(a.shape)).astype(
            np.float32), variables)
    z = rng.standard_normal((B, 16)).astype(np.float32)
    want_y, want_m = jm.apply(variables, jnp.asarray(z), (8, 8))
    tm = TS.ScenePatch(16, 4, 3)
    tm.load_state_dict(from_flax(variables))
    got_y, got_m = tm(torch.from_numpy(z), (8, 8))
    for got, want in ((got_y, want_y), (got_m, want_m)):
        np.testing.assert_allclose(_np(got.permute(0, 2, 3, 1)),
                                   np.asarray(want), rtol=0, atol=1e-6)


# ------------------------------------------------------------- the models
def test_scene_generator_matches_jax(rng):
    """The iterative painter (no trainer uses it): the tanh canvas and the
    final z, in train mode, with every weight and statistic perturbed."""
    cfg = dict(base_size=4, latent_dims=16, data_dims=3, blocks=(8,),
               num_blocks_per_scale=1)
    jm = jscene.SceneGenerator(JaxGANConfig(**cfg), patch_size=4)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                       jnp.zeros((2, 16))))
    variables = jax.tree_util.tree_map(
        lambda a: (a + 0.3 * rng.standard_normal(a.shape)).astype(
            np.float32), variables)
    variables["batch_stats"] = jax.tree_util.tree_map(
        np.abs, variables["batch_stats"])
    z = rng.standard_normal((B, 16)).astype(np.float32)
    (want_z, want), new = jm.apply(variables, jnp.asarray(z),
                                   return_z_final=True,
                                   mutable=["batch_stats"])
    tm = TS.SceneGenerator(GANConfig(**cfg), patch_size=4)
    tm.load_state_dict(from_flax(variables))
    with update_batch_stats(tm):
        got_z, got = tm(torch.from_numpy(z), return_z_final=True)
    assert got.shape == (B, 3, 8, 8)
    _close(_np(got.permute(0, 2, 3, 1)), want)
    _close(_np(got_z), want_z)
    for a, b in _zip_leaves(to_flax(tm)["batch_stats"],
                            jax.device_get(new)["batch_stats"]):
        _close(a, b)


def _structured(rng, noise=True):
    jm = jscene.StructuredSceneGenerator(JaxGANConfig(**KW), **SCENE,
                                         patch_noise=noise)
    key = jax.random.PRNGKey(0)
    variables = jax.device_get(jm.init({"params": key, "scene": key},
                                       jnp.zeros((2, 16))))
    variables = _perturb(variables, rng)
    variables["params"]["structure_generator"]["patch_transforms"][
        "kernel"] = (0.3 * rng.standard_normal((16, 24))).astype(np.float32)
    tm = TS.StructuredSceneGenerator(GANConfig(**KW), **SCENE,
                                     patch_noise=noise)
    tm.load_state_dict(from_flax(variables))
    return jm, variables, tm


def test_structured_scene_generator_matches_jax(rng, monkeypatch, fed_noise):
    """The scene trainer's G: the structure masks through the residual
    blocks of ``blocks[scene_i:]`` (attention counted within them) to
    full size, in train mode with the same noise: images, statistics and
    the tree of the JAX layout."""
    monkeypatch.setattr(pallas_attn, "_INTERPRET", True)
    jm, variables, tm = _structured(rng)
    z = rng.standard_normal((B, 16)).astype(np.float32)
    draw = rng.standard_normal((3, 3)).astype(np.float32)
    fed_noise[:] = [draw]
    want, new = jm.apply(variables, jnp.asarray(z), mutable=["batch_stats"],
                         rngs={"scene": jax.random.PRNGKey(1)})
    with update_batch_stats(tm):
        got = tm(torch.from_numpy(z), noise=torch.from_numpy(draw))
    assert got.shape == (B, 3, 16, 16)
    assert tm.layers == ["structure_generator", "ResidualGeneratorBlock_0",
                         "SelfAttention2d_0", "ResidualGeneratorBlock_1",
                         "GeneratorOutput_0"]
    _close(_np(got.permute(0, 2, 3, 1)), want)
    tree = to_flax(tm)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(variables)
    for a, b in _zip_leaves(tree["batch_stats"],
                            jax.device_get(new)["batch_stats"]):
        _close(a, b)


def test_scene_step_matches_jax(rng, fed_noise):
    """One scene step with --patch-noise: the JAX CNN step threading a
    "scene" key into both G applies, the port's taking ``noise_d`` and
    ``noise_g``; losses, gp, gradients, statistics, Adam, EMA."""
    jg, variables, g = _structured(rng)
    # D's attention through the JAX package's plain reference (the same
    # math; R1's second order through the interpreted kernel would take
    # most of this file's time), G's through its kernel, interpreted
    jd = JaxDiscriminator(JaxGANConfig(**KW),
                          block_factory=JF.d_block_factory("bn", "relu"),
                          output_factory=JF.d_output_factory("bn", "relu"),
                          attn_use_pallas=False)
    d_vars = _perturb(jax.device_get(jd.init(
        jax.random.PRNGKey(2), jnp.zeros((2, 16, 16, 3)))), rng)
    opt_g, opt_d = jax_adam(LR_G), jax_adam(LR_D)
    js = JaxState(g_params=variables["params"],
                  g_stats=variables["batch_stats"],
                  target_g_params=variables["params"],
                  d_params=d_vars["params"], d_stats=d_vars["batch_stats"],
                  opt_g=opt_g.init(variables["params"]),
                  opt_d=opt_d.init(d_vars["params"]))
    g_target = TS.StructuredSceneGenerator(GANConfig(**KW), **SCENE)
    g_target.load_state_dict(from_flax({"params": variables["params"]}),
                             strict=False)
    d = Discriminator(GANConfig(**KW), input_factory=F.d_input_factory(),
                      block_factory=F.d_block_factory("bn", "relu"),
                      output_factory=F.d_output_factory("bn", "relu"))
    d.load_state_dict(from_flax(d_vars))
    ts = GANTrainState(g=g, g_target=g_target, d=d,
                       opt_g=make_adam(g.parameters(), LR_G),
                       opt_d=make_adam(d.parameters(), LR_D))

    draws = [rng.standard_normal((3, 3)).astype(np.float32)
             for _ in range(2)]
    fed_noise[:] = list(draws)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas_attn, "_INTERPRET", True)
        jstep = jax_cnn_step(jg, jd, opt_g, opt_d, latent_dims=16,
                             grad_penalty=5.0, ema_factor=EMA,
                             dtype=jnp.float32, g_rng_name="scene")
        batch = rng.integers(0, 256, (B, 16, 16, 3), dtype=np.uint8)
        key = jax.random.PRNGKey(5)
        rng_zg, _, d_key, _ = jax.random.split(key, 4)
        new_js, jm = jax.jit(jstep)(js, jnp.asarray(batch), key)
    assert not fed_noise  # the D step's G apply, then the G step's
    z_d = np.asarray(jax.random.normal(d_key, (B, 16)))[None]
    z_g = np.asarray(jax.random.normal(rng_zg, (B, 16)))
    step = make_cnn_train_step(grad_penalty=5.0, ema_factor=EMA)
    tm = step(ts, torch.from_numpy(batch), torch.from_numpy(z_d.copy()),
              torch.from_numpy(z_g.copy()),
              noise_d=torch.from_numpy(draws[0])[None],
              noise_g=torch.from_numpy(draws[1]))
    _hold_step(tm, jm, ts, jax.device_get(new_js))


# ------------------------------------------------------------ the trainer
def _scene_argv(archive, out, *extra):
    return _argv(archive, out, "--scene-size", "8", "--num-patches", "4",
                 "--patch-noise", *extra)


def test_scene_entry_point_checkpoints_both_ways(tiny_archive, tmp_path):
    """``python -m tartangan_torch.train.scene ... --patch-noise --device
    cpu`` trains 3 steps and writes a checkpoint that the JAX scene
    trainer's templates restore and its loader takes; the port resumes
    from a checkpoint the JAX trainer wrote, leaf for leaf."""
    out = tmp_path / "out"
    main(_scene_argv(tiny_archive, out))
    ckpt = out / "testrun" / "checkpoints" / "3"
    assert (out / "testrun" / "samples" / "sample_3.png").exists()

    jargv = _scene_argv(tiny_archive, out, "--run-id", "jax")
    jargv.remove("--device"), jargv.remove("cpu")
    jt = JaxSceneTrainer.create_from_cli(jargv)
    jt.build_models()
    templates = jax.device_get(jt.checkpoint_artifacts())
    restored = {n: serialization.from_bytes(
        t, (ckpt / f"{n}.msgpack").read_bytes())
        for n, t in templates.items()}
    jt.load_checkpoint_artifacts(restored)
    assert int(jt.state.opt_g[0].count) == 3
    assert np.shape(restored["g"]["params"]["structure_generator"][
        "patch_transforms"]["kernel"]) == (100, 24)

    jckpt = out / "jax" / "checkpoints" / "5"
    jckpt.mkdir(parents=True)
    for n, tree in templates.items():
        (jckpt / f"{n}.msgpack").write_bytes(serialization.to_bytes(tree))
    (jckpt / "trainer.json").write_text(json.dumps({"epoch": 2, "steps": 5}))
    trainer = SceneTrainer.create_from_cli(_scene_argv(
        tiny_archive, out, "--run-id", "jax", "--resume-training-latest",
        "--epochs", "0"))
    trainer.train()
    assert trainer.steps == 5
    mine = trainer.checkpoint_artifacts()
    for n, tree in templates.items():
        for a, b in _zip_leaves(mine[n], serialization.to_state_dict(tree)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_scene_two_step_call_equals_eager(tiny_archive, tmp_path):
    """``--steps-per-call 2`` (with ``--device-data``): one call of two
    steps on the draws of ``chunk_draws`` (latents, rows, crops and the
    patch noise of both steps) equals the two steps run one by one on the
    same draws, bit for bit; the step makes one D update a step whatever
    --iters-d says, as the JAX scene trainer's."""
    def trainer(*extra):
        t = SceneTrainer.create_from_cli(_scene_argv(
            tiny_archive, tmp_path / "out", "--steps-per-call", "2",
            "--device-data", "--iters-d", "2", *extra))
        t.build_models()
        t.dataset = t.prepare_dataset()
        t._setup_device_data()
        return t
    chunked, eager = trainer(), trainer()
    draws = chunked.chunk_draws(True)
    assert draws["noise_d"].shape == (2, 2, 3, 3)
    assert draws["noise_g"].shape == (2, 3, 3)
    metrics = chunked.make_chunk_call(True)(chunked.state, chunked._archive,
                                            0, **draws)
    assert metrics["g_loss"].shape == (2,)
    from tartangan_torch.data.device import wrap_step_with_device_data
    step = wrap_step_with_device_data(eager._train_step, eager._crop)
    for i in range(2):
        m = step(eager.state, eager._archive,
                 **{n: d[i] for n, d in draws.items()})
        for k in m:
            assert torch.equal(m[k], metrics[k][i]), k
    for a, b in zip(chunked.state.d.state_dict().values(),
                    eager.state.d.state_dict().values()):
        assert torch.equal(a, b)
    for a, b in zip(chunked.state.g.state_dict().values(),
                    eager.state.g.state_dict().values()):
        assert torch.equal(a, b)
    p = next(chunked.state.d.parameters())
    assert int(chunked.state.opt_d.state[p]["step"]) == 2


def test_scene_sampler_draws_noise(tiny_archive, tmp_path):
    """The sampler's G applies draw their own noise (``generate``), and
    leave the running statistics alone."""
    t = SceneTrainer.create_from_cli(_scene_argv(tiny_archive,
                                                 tmp_path / "out"))
    t.build_models()
    before = {k: v.clone() for k, v in t.state.g.state_dict().items()}
    imgs = t.sample_g(3)
    assert imgs.shape == (3, 16, 16, 3) and np.isfinite(imgs).all()
    for k, v in t.state.g.state_dict().items():
        assert torch.equal(v, before[k])


def test_scene_entry_point_needs_cuda_by_default(tiny_archive, tmp_path):
    argv = _scene_argv(tiny_archive, tmp_path / "out")
    argv.remove("--device"), argv.remove("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        SceneTrainer.create_from_cli(argv)
