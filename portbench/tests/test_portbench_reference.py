"""The reference against the port at a tiny size on the CPU, in float32."""
import numpy as np
import pytest
import torch

from portbench import check, reference, run
from portbench.synthetic import make_tartans


def _tartan_image(rng, size):
    """A copy of the port's ``data/synthetic.py`` ``tartan_image``."""
    n_colors = rng.integers(2, 6)
    palette = rng.integers(0, 256, size=(n_colors, 3)).astype(np.float32)
    n_stripes = rng.integers(3, 9)
    colors = palette[rng.integers(0, n_colors, size=n_stripes)]
    widths = rng.integers(2, 13, size=n_stripes)
    colors = np.concatenate([colors, colors[::-1]], axis=0)
    widths = np.concatenate([widths, widths[::-1]], axis=0)
    stripe_of = np.repeat(np.arange(len(widths)), widths)
    warp = colors[stripe_of[np.arange(size) % len(stripe_of)]]
    weft = warp.copy()
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    over = ((yy + xx) // 2) % 2
    img = np.where(over[..., None] == 0, warp[None, :, :], weft[:, None, :])
    mixed = 0.75 * img + 0.25 * (warp[None, :, :] / 2 + weft[:, None, :] / 2)
    return np.clip(mixed, 0, 255).astype(np.uint8)


def make_archive(num, size, seed):
    rng = np.random.default_rng(seed)
    return np.stack([_tartan_image(rng, size) for _ in range(num)])


def test_bulk_tartans_are_the_copys():
    for num, size, seed in ((5, 32, 0), (3, 64, 2 ** 33 + 7)):
        assert (make_tartans(num, size, seed) ==
                make_archive(num, size, seed)).all()


def _port_models(cfg, hp, w):
    from tartangan_torch.configs import GAN_CONFIGS
    from tartangan_torch.models import factories as F
    from tartangan_torch.models.pluggan import Discriminator, Generator
    gc = GAN_CONFIGS[cfg["program_config"]]
    g = Generator(gc, input_factory=F.g_input_factory("mlp", "relu"),
                  block_factory=F.g_block_factory("bn", "relu"),
                  output_factory=F.g_output_factory("bn", "relu"))
    d = Discriminator(gc, input_factory=F.d_input_factory(),
                      block_factory=F.d_block_factory("bn", "relu"),
                      output_factory=F.d_output_factory("bn", "relu"))
    g.load_state_dict(w["g"])
    d.load_state_dict(w["d"])
    return g, d


def test_forward_with_attention_agrees(tiny):
    # G's and D's train-mode forwards, attention included, float32: the
    # two differ by the order of their sums alone
    s = tiny("sagan-512thin-r1-b64", blocks=(16, 16, 8), attention=(1,))
    cfg, hp = s["config"], s["config"]["train"]
    arch = s["model"].architecture(cfg)
    w = s["model"].make_weights(arch, hp, 11, "cpu")
    g, d = _port_models(cfg, hp, w)
    rg, rd = reference.build(arch, hp)
    rg.load_state_dict(w["g"])
    rd.load_state_dict(w["d"])
    z = torch.randn(4, 16, generator=torch.Generator().manual_seed(1))
    x = reference.normalize(torch.from_numpy(make_tartans(4, 32, 3)))
    with torch.no_grad():
        for a, b in ((g(z), rg(z)), (d(x), rd(x))):
            assert float((a - b).norm() / b.norm()) < 1e-5


@pytest.mark.parametrize("r1_interval", [1, 2])
def test_train_steps_agree(tiny, r1_interval):
    # three float32 steps through the program's loop against the reference:
    # R1's double backward (every step, or lazily on steps 1 and 3 at twice
    # the weight), BCE, Adam, BatchNorm's statistics, the EMA; the two sum
    # in other orders. Without attention, whose max pools over flat tartan
    # stripes route R1's input gradient by rounding (PERF.md)
    s = tiny("sagan-512thin-r1-b64")
    s["traffic"] = dict(s["traffic"], r1_interval=r1_interval)
    r, prog, (archive, w) = run.train(s, 3, 0.0, False, "cpu")
    res = run.held(s, prog, archive, w, "cpu")
    n = res["numbers"]
    assert (n["loss"] < 1e-5 and n["grad"] < 1e-5 and n["g_grad"] < 1e-5
            and n["change"] < 1e-4), n
    assert r.steps == 1 and r.failed == 0


def test_moved_leaves_out_the_biases_ahead_of_batchnorm():
    grads = {"a.Conv_0.bias": torch.full((4,), 1e-9),
             "a.Conv_0.weight": torch.ones(4), "b": torch.ones(9),
             "c": torch.ones(16)}
    assert check.moved(grads) == ["a.Conv_0.weight", "b", "c"]
