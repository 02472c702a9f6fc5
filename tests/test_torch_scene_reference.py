"""The port's structured scene GAN (``tartangan_torch/models/scene.py``,
``train/scene.py``) against the benchmark's plain reference of it
(``portbench/reference_scene.py``, plain PyTorch that imports nothing of
the port), on the CPU at a small scene configuration that keeps an
attention: a 8x8 scene of 4 patches, the G blocks 16-8 up to 32x32 and
the attention after the first of them (Ck 2, Cv 8, 256 queries over 64
keys, taken by the reference in blocks of 48 queries), B 4, on the
benchmark's seeded weights. D's attention then sits at its 4x4 block: at
a larger one the max pools over flat tartan stripes route R1's input
gradient by rounding (``PERF.md``), and the step's D gradient reads ~1e-2
on either side of a tie.

Tolerances (float32 on both sides, which differ by the order of their
sums alone): G's output and gradient 1e-5 of the reference's norm (read
at ~1e-7); the step's losses 1e-5 of their size, its D and G gradients
1e-5 (read at ~1e-6 here, where 1e-2 and more is a fault: the benchmark's
half-batch step reads 0.6 and more); the query-blocked attention against
the whole one 1e-6 of the norm (the same products, cut by rows).
"""
import torch_threads  # noqa: F401  (this process's share of the cores)
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import check, exp_bound, flops, reference, run  # noqa
from portbench import reference_scene as RS  # noqa: E402
from portbench.models import scene as MS  # noqa: E402
from tartangan_torch import configs  # noqa: E402
from tartangan_torch.models.scene import StructuredSceneGenerator  # noqa
from tartangan_torch.utils import tracing  # noqa: E402

BLOCKS, ATTENTION, SCENE = (16, 16, 8), (0,), 8
B = 4


def _spec():
    """The cell scene-512thin-b64 cut to the small configuration, which
    the port knows as 'pb-scene'."""
    configs.GAN_CONFIGS["pb-scene"] = configs._cfg(16, BLOCKS,
                                                  attention=ATTENTION)
    s = run.spec("scene-512thin-b64")
    s["config"] = dict(s["config"], program_config="pb-scene",
                       latent_dims=16, blocks=list(BLOCKS),
                       attention=list(ATTENTION), scene_size=SCENE,
                       num_patches=4, dtype="f32")
    s["traffic"] = dict(s["traffic"], batch_size=B, images=12)
    return s


def _models(seed=5):
    """(the port's G, the reference's G, the weights) on the same seeded
    weights."""
    s = _spec()
    cfg = s["config"]
    arch = MS.architecture(cfg)
    w = MS.make_weights(arch, cfg["train"], seed, "cpu")
    port = StructuredSceneGenerator(
        configs.GAN_CONFIGS["pb-scene"], scene_size=SCENE, patch_size=3,
        num_patches=4, patch_noise=True, norm="bn", activation="relu")
    port.load_state_dict(w["g"])
    ref = RS.Generator(arch, cfg["train"])
    ref.load_state_dict(w["g"])
    return port, ref, w


def _rel(a, b):
    return float((a - b).detach().norm() / b.detach().norm())


def test_generator_forward_and_gradient_agree():
    port, ref, _ = _models()
    gen = torch.Generator().manual_seed(3)
    z = torch.randn(B, 16, generator=gen)
    noise = torch.randn(3, 3, generator=gen)
    ref.noise = noise
    ref.SelfAttention2d_0.block_queries = 48
    out_p, out_r = port(z, train=True, noise=noise), ref(z)
    assert out_p.shape == out_r.shape == (B, 3, 32, 32)
    assert _rel(out_p, out_r) < 1e-5
    # the placed masks are not all zeros: the seeded transforms keep the
    # patches on the canvas
    assert float(ref.structure_generator(z, noise).detach().abs().amax()) > 0.1
    r = torch.randn(out_r.shape, generator=gen)
    grads_p = torch.autograd.grad((out_p * r).sum(), list(port.parameters()))
    grads_r = torch.autograd.grad((out_r * r).sum(), list(ref.parameters()))
    names = [n for n, _ in port.named_parameters()]
    assert names == [n for n, _ in ref.named_parameters()]
    # as the benchmark's check takes it: the leaves as one vector, less the
    # biases ahead of a BatchNorm, whose gradient is 0 to rounding
    want = dict(zip(names, grads_r))
    assert check.gradient_gap(dict(zip(names, grads_p)), want) < 1e-5
    # the transforms take a gradient through the sampling
    assert "structure_generator.patch_transforms.weight" in check.moved(want)


def test_one_scene_step_agrees():
    # the program's set-up steps through SceneTrainer's own loop against
    # the reference's, on the same rows, latents and patch noise
    s = _spec()
    r, prog, (archive, w) = run.train(s, 2 ** 31 + 21, 0.0, False, "cpu")
    ref = run.reference_of(s, prog, archive, w, "cpu")
    for key in ("d_loss", "g_loss", "gp"):
        got, want = prog["losses"][0][key], ref["losses"][0][key]
        assert abs(got - want) <= 1e-5 * abs(want), key
    numbers = run.held(s, prog, archive, w, "cpu")["numbers"]
    assert numbers["grad"] < 1e-5 and numbers["g_grad"] < 1e-5, numbers
    # each step was fed the patch noise, without a batch axis
    for _, draws in prog["fed"]:
        assert draws["noise_d"].shape == (1, 3, 3)
        assert draws["noise_g"].shape == (3, 3)
    assert r.failed == 0


@pytest.mark.parametrize("block_queries", [100, 256])
def test_blocked_attention_is_the_whole_one(block_queries):
    torch.manual_seed(0)
    whole = reference.SelfAttention(16, None)
    blocked = RS.BlockedSelfAttention(16, None)
    for m in (whole, blocked):
        torch.manual_seed(1)
        for p in m.parameters():
            p.data.normal_(0, 0.5)
    blocked.block_queries = block_queries
    x = torch.randn(2, 16, 32, 32, requires_grad=True)
    y_w, y_b = whole(x), blocked(x)
    assert _rel(y_b, y_w) < 1e-6
    r = torch.randn(y_w.shape)
    g_w = torch.autograd.grad((y_w * r).sum(), [x, *whole.parameters()])
    g_b = torch.autograd.grad((y_b * r).sum(), [x, *blocked.parameters()])
    for a, b in zip(g_b, g_w):
        assert _rel(a, b) < 1e-6
    with torch.no_grad():
        assert _rel(blocked(x), y_w) < 1e-6


def test_counts_by_hand():
    cfg = MS.architecture(run.spec("scene-512thin-b64")["config"])
    step = flops.counts(MS, cfg, 64, True)
    launches = step.launches
    assert sum(n for *_, n in launches["k1"]) == 5
    assert sum(n for *_, n in launches["k2"]) == 5
    g, attns = MS.generator_layers(cfg, 64)
    # the structure block's dense 256 -> 6 x 20, then the first G block's
    # conv from the 20 placed masks at 32x32 to 128 channels
    assert (g[0].name, g[0].flops) == ("g.structure", 2 * 64 * 256 * 120)
    assert (g[1].name, g[1].flops) == ("g.0.conv0",
                                       2 * 64 * 32 * 32 * 20 * 128 * 9)
    # the attention after the 16-channel block at 256x256
    (a,) = attns
    assert (a.b, a.lq, a.lk, a.ck, a.cv) == (64, 65536, 16384, 2, 8)
    assert a.fwd_flops == 2 * 64 * 65536 * 16384 * 10
    # R1 on every step, whatever the traffic says
    assert flops.step_flops(flops.counts(MS, cfg, 64, False)) == \
        flops.step_flops(step)
    # one exponential a logit at 132 x 16 x 1.98e9 a second: 16.43 ms a
    # launch, above the bytes and the bf16 products
    assert exp_bound.exp_ms(64, 65536, 16384) == pytest.approx(16.4331,
                                                              abs=1e-4)


def test_structure_span_under_a_profiler_alone():
    port, _, _ = _models()
    z, noise = torch.randn(B, 16), torch.randn(3, 3)
    tracing.reset()
    try:
        with torch.no_grad():
            port(z, train=True, noise=noise)
            assert tracing.records() == []
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]):
                port(z, train=True, noise=noise)
        (rec,) = tracing.records()
        assert rec.name == "scene.structure" and rec.profiled
        assert rec.end_ns >= rec.start_ns
    finally:
        tracing.reset()
