"""The port's post-training apps (``tartangan_torch.explore``) against the
JAX package's on one run directory written by hand: render_tour,
continuous_interp (plain and ``--tile``), find_image with Adam, SGD,
L-BFGS and ``--vgg``, and info_encode.

The run directories hold ``config.args`` and ``checkpoints/1/{g,g_target,
d}.msgpack`` from seeded flax models (no JAX training run: its compile
costs too much here). Both apps get the same latents by patching
``sample_z``: the JAX app draws from an unseeded generator.
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import serialization
from PIL import Image

from tartangan_tpu.configs import GAN_CONFIGS
from tartangan_tpu.models import factories as JF
from tartangan_tpu.models.pluggan import Discriminator as JaxDiscriminator
from tartangan_tpu.models.pluggan import Generator as JaxGenerator


def _perturbed(variables, rng, scale=0.05):
    return jax.tree_util.tree_map(
        lambda a: (a + scale * rng.standard_normal(a.shape)).astype(
            np.float32), jax.device_get(variables))


def write_run(root, config, info=None, seed=0):
    """A run directory as the JAX trainers lay it out: G with nonzero
    attention gamma, a distinct EMA target, and D (the InfoGAN D with
    ``info=(cat, cont)``)."""
    rng = np.random.default_rng(seed)
    cfg = GAN_CONFIGS[config]
    g = JaxGenerator(cfg, input_factory=JF.g_input_factory("mlp", "relu"),
                     block_factory=JF.g_block_factory("bn", "relu"),
                     output_factory=JF.g_output_factory("bn", "relu"))
    gv = g.init(jax.random.PRNGKey(seed), jnp.zeros((1, cfg.latent_dims)))
    params = _perturbed(gv["params"], rng)
    for name, sub in params.items():
        if "gamma" in sub:
            sub["gamma"] = np.array(0.9, np.float32)
    stats = _perturbed(gv["batch_stats"], rng, 0.0)
    if info:
        d_out = JF.info_d_output_factory("bn", "relu", sum(info))
    else:
        d_out = JF.d_output_factory("bn", "relu")
    d = JaxDiscriminator(cfg, block_factory=JF.d_block_factory("bn", "relu"),
                         output_factory=d_out)
    dv = d.init(jax.random.PRNGKey(seed + 1),
                jnp.zeros((1, cfg.max_size, cfg.max_size, cfg.data_dims)))
    ckpt = root / "checkpoints" / "1"
    ckpt.mkdir(parents=True)
    args = ["data.npz", "--config", config]
    if info:
        args += ["--info-cat-dims", str(info[0]),
                 "--info-cont-dims", str(info[1])]
    (root / "config.args").write_text("\n".join(args))
    (ckpt / "g.msgpack").write_bytes(serialization.to_bytes(
        {"params": params, "batch_stats": stats}))
    (ckpt / "g_target.msgpack").write_bytes(serialization.to_bytes(
        {"params": jax.tree_util.tree_map(lambda a: a * 1.02, params)}))
    (ckpt / "d.msgpack").write_bytes(serialization.to_bytes(
        {"params": _perturbed(dv["params"], rng),
         "batch_stats": jax.device_get(dv["batch_stats"])}))
    return str(root)


@pytest.fixture(scope="module")
def run16(tmp_path_factory):
    return write_run(tmp_path_factory.mktemp("run16"), "16")


@pytest.fixture(scope="module")
def run128(tmp_path_factory):
    return write_run(tmp_path_factory.mktemp("run128"), "test128")


def _apps(jax_mod, torch_mod, cls, run, tmp_path, extra, z):
    """The JAX app and the port's on one run directory and flags, drawing
    ``z``, with outputs under ``tmp_path / 'j'`` and ``tmp_path / 't'``."""
    jax_cls, torch_cls = getattr(jax_mod, cls), getattr(torch_mod, cls)
    jax_app = jax_cls(jax_cls.parse_cli_args(
        [run, str(tmp_path / "j" / "o")] + extra))
    torch_app = torch_cls(torch_cls.parse_cli_args(
        [run, str(tmp_path / "t" / "o")] + extra + ["--device", "cpu"]))
    jax_app.sample_z = lambda n, rng=None: jnp.asarray(z[:n])
    torch_app.sample_z = lambda n, rng=None: z[:n]
    return jax_app, torch_app


def _png(path):
    return np.asarray(Image.open(path), np.int16)


def _latents(n, dims, seed=1, bound=1.0):
    rng = np.random.default_rng(seed)
    return np.clip(rng.standard_normal((n, dims)), -bound, bound).astype(
        np.float32)


def test_render_tour(run16, tmp_path):
    import tartangan_torch.explore.render_tour as T
    import tartangan_tpu.explore.render_tour as J
    z = _latents(3, 100)
    jax_app, torch_app = _apps(
        J, T, "RenderTour", run16, tmp_path,
        ["--num-points", "3", "--seg-frames", "2"], z)
    jax_app.run()
    torch_app.run()
    frames = sorted(os.listdir(tmp_path / "t"))
    assert frames == sorted(os.listdir(tmp_path / "j")) and len(frames) == 6
    for f in frames:
        a, b = _png(tmp_path / "t" / f), _png(tmp_path / "j" / f)
        assert a.shape == b.shape == (20, 20, 3)  # one image, padded
        assert np.abs(a - b).max() <= 1, f


@pytest.mark.parametrize("tile", [False, True])
def test_continuous_interp(run16, tmp_path, tile):
    import tartangan_torch.explore.continuous_interp as T
    import tartangan_tpu.explore.continuous_interp as J
    extra = ["--output-size", "24", "--num-points", "6"] + \
        (["--tile"] if tile else [])
    z = _latents(9, 100, seed=2, bound=3.0)
    jax_app, torch_app = _apps(J, T, "ContinuousInterp", run16, tmp_path,
                               extra, z)
    grid = "unmirrored_tiled_grid" if tile else "sample_latent_grid"
    jax_app.load_generator()
    torch_app.load_generator()
    np.testing.assert_allclose(getattr(torch_app, grid)(6, 6),
                               getattr(jax_app, grid)(6, 6), atol=1e-6)
    jax_app.run()
    torch_app.run()
    a = _png(tmp_path / "t" / "o_combined.png")
    b = _png(tmp_path / "j" / "o_combined.png")
    assert a.shape == b.shape == (28, 28, 3)  # padded
    assert np.abs(a - b).max() <= 1


def _target(tmp_path, size, seed=3):
    path = tmp_path / "target.png"
    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 256, (size, size, 3),
                                 dtype=np.uint8)).save(path)
    return str(path)


def _find(run, tmp_path, z, extra):
    import tartangan_torch.explore.find_image as T
    import tartangan_tpu.explore.find_image as J
    target = _target(tmp_path, GAN_CONFIGS[
        open(os.path.join(run, "config.args")).read().split()[2]].max_size)
    return _apps(J, T, "FindImage", run, tmp_path,
                 [target, "--num-samples", str(len(z)), "--save-freq", "1"]
                 + extra, z)


def _record_updates(monkeypatch):
    """The z after each update inside the JAX app's jitted step, by a
    callback around ``optax.apply_updates``."""
    import optax
    zs = []
    apply_updates = optax.apply_updates

    def recording(params, updates):
        out = apply_updates(params, updates)
        jax.debug.callback(lambda v: zs.append(np.asarray(v)), out)
        return out
    monkeypatch.setattr(optax, "apply_updates", recording)
    return zs


@pytest.mark.parametrize("optimizer,lr", [("adam", "0.5"), ("sgd", "1e-5")])
def test_find_image(run128, tmp_path, monkeypatch, optimizer, lr):
    """Three steps from the same z (|z| <= 1, so no clip fires): the
    losses within 1e-4 relative and the final z within 1e-4."""
    z = _latents(2, 64)
    jax_app, torch_app = _find(run128, tmp_path, z, [
        "--max-steps", "3", "--optimizer", optimizer, "--lr", lr])
    jax_zs = _record_updates(monkeypatch)
    jax_app.run()
    torch_app.load_generator()
    final = torch_app.find(torch_app.read_target()).numpy()
    np.testing.assert_allclose(torch_app.loss_history, jax_app.loss_history,
                               rtol=1e-4)
    assert torch_app.loss_history[-1] < torch_app.loss_history[0]
    assert len(jax_zs) == 3 and np.abs(final).max() < 3.0
    np.testing.assert_allclose(final, jax_zs[-1], atol=1e-4)
    a = _png(tmp_path / "t" / "o_2.png")
    b = _png(tmp_path / "j" / "o_2.png")
    assert np.abs(a - b).max() <= 1


def test_find_image_lbfgs(run16, tmp_path):
    """L-BFGS: three steps against optax.lbfgs through the JAX app, and the
    reference's own property (``tests/test_explore_export.py``) on a
    G-made target: L-BFGS ends below its first loss and no worse than 2x
    Adam after 6 steps."""
    z = _latents(2, 100)
    jax_app, torch_app = _find(run16, tmp_path, z, [
        "--max-steps", "3", "--optimizer", "lbfgs", "--lr", "0.1"])
    jax_app.run()
    torch_app.load_generator()
    torch_app.find(torch_app.read_target())
    np.testing.assert_allclose(torch_app.loss_history, jax_app.loss_history,
                               rtol=1e-3)
    assert all(n >= 1 for n in torch_app.linesearch_steps)

    import torch
    with torch.no_grad():
        g_img = torch_app.g(torch.as_tensor(_latents(1, 100, seed=5)),
                            train=False)
    target = np.clip(g_img[0].permute(1, 2, 0).numpy(), -1, 1)
    losses = {}
    for name, lr in (("lbfgs", 0.1), ("adam", 0.5)):
        torch_app.args.optimizer, torch_app.args.lr = name, lr
        torch_app.args.max_steps, torch_app.args.save_freq = 6, 100
        torch_app.find(target, z=z)
        losses[name] = torch_app.loss_history
        assert np.all(np.isfinite(losses[name]))
    assert losses["lbfgs"][-1] < losses["lbfgs"][0]
    assert losses["lbfgs"][-1] <= 2.0 * losses["adam"][-1]


def test_find_image_perceptual(run16, tmp_path, monkeypatch):
    """--vgg with a tiny stand-in for Inception on both sides (a
    ``Mixed_5b`` submodule with the same weights): the loss after one step
    within 1e-4 of JAX's."""
    import flax.linen as fnn
    import torch
    from torch import nn

    from tartangan_torch.models import inception as tinc
    from tartangan_tpu.models import inception as minc

    class _TinyBackbone(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            x = fnn.avg_pool(x, (16, 16), (16, 16))
            return fnn.Conv(4, (3, 3), name="Mixed_5b")(x)

    model = _TinyBackbone()
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 299, 299, 3)))
    kernel = np.asarray(variables["params"]["Mixed_5b"]["kernel"])
    bias = np.asarray(variables["params"]["Mixed_5b"]["bias"])

    class _TorchTiny(nn.Module):
        def __init__(self):
            super().__init__()
            self.Mixed_5b = nn.Conv2d(3, 4, 3, padding=1)
            with torch.no_grad():
                self.Mixed_5b.weight.copy_(
                    torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
                self.Mixed_5b.bias.copy_(torch.from_numpy(bias))

        def forward(self, x):
            return self.Mixed_5b(torch.nn.functional.avg_pool2d(x, 16))

    monkeypatch.setattr(minc, "init_inception",
                        lambda dtype=jnp.float32, seed=0: (model, variables))
    monkeypatch.setattr(minc, "resolve_pretrained",
                        lambda v, w=None: (v, False))
    monkeypatch.setattr(tinc, "init_inception", lambda seed=0: _TorchTiny())
    monkeypatch.setattr(tinc, "resolve_pretrained",
                        lambda m, w=None: (m, False))
    z = _latents(2, 100)
    jax_app, torch_app = _find(run16, tmp_path, z, [
        "--max-steps", "2", "--vgg", "--perceptual-layers", "Mixed_5b"])
    jax_app.run()
    torch_app.run()
    np.testing.assert_allclose(torch_app.loss_history, jax_app.loss_history,
                               rtol=1e-4)
    assert os.path.exists(tmp_path / "t" / "o_0.png")


def test_info_encode(tmp_path):
    """The codes pickle equals JAX's within 1e-5, and --recon renders."""
    import tartangan_torch.explore.info_encode as T
    import tartangan_tpu.explore.info_encode as J
    run = write_run(tmp_path / "run", "16", info=(4, 2))
    rng = np.random.default_rng(0)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for i in range(5):
        Image.fromarray(rng.integers(0, 256, (16, 16, 3),
                                     dtype=np.uint8)).save(
            img_dir / f"t{i}.png")
    argv = [str(img_dir / "*.png"), "--batch-size", "2", "--recon"]
    jax_app = J.InfoGANEncodeImage(J.InfoGANEncodeImage.parse_cli_args(
        [run, str(tmp_path / "j" / "c")] + argv))
    torch_app = T.InfoGANEncodeImage(T.InfoGANEncodeImage.parse_cli_args(
        [run, str(tmp_path / "t" / "c")] + argv + ["--device", "cpu"]))
    jax_app.run()
    torch_app.run()
    with open(tmp_path / "j" / "c_codes.pkl", "rb") as f:
        ref = pickle.load(f)
    with open(tmp_path / "t" / "c_codes.pkl", "rb") as f:
        ours = pickle.load(f)
    assert ours["id"] == ref["id"] and len(ours["id"]) == 5
    assert ours["features"][0].shape == (6,)
    np.testing.assert_allclose(np.stack(ours["features"]),
                               np.stack(ref["features"]), atol=1e-5)
    for i in range(3):
        a = _png(tmp_path / "t" / f"c_{i}.png")
        b = _png(tmp_path / "j" / f"c_{i}.png")
        assert a.shape == b.shape and np.abs(a - b).max() <= 1
