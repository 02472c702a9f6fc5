"""The cell scene-512thin-b64 cut to a tiny scene on the CPU (an 8x8 scene
of 20 patches, G blocks 16-8 up to 32x32, attention after the first), run
through ``run.run_cell``: a sound run is correct and one whose step sees
half the batch, or whose G optimizer gets the negated gradient, is not;
the patch noise is recorded by name and, having no batch axis, not halved;
the structure block's span is recorded in each traced G forward; and the
exponential bound of K1 and K2 against numbers worked by hand."""
import pytest


@pytest.fixture
def scene(tiny):
    s = tiny("scene-512thin-b64", blocks=(16, 16, 8), attention=(0,))
    s["config"] = dict(s["config"], scene_size=8)
    return s


@pytest.fixture
def noise_seen(monkeypatch):
    """(batch, noise shape) of every structure block call."""
    from tartangan_torch.models import scene
    seen, forward = [], scene.SceneStructureBlock.forward

    def recorded(self, z, train=True, noise=None):
        seen.append((z.shape[0], tuple(noise.shape)))
        return forward(self, z, train, noise)
    monkeypatch.setattr(scene.SceneStructureBlock, "forward", recorded)
    return seen


@pytest.mark.parametrize("fault", [None, "half_batch", "negated_g"])
def test_tiny_scene_cell(scene, noise_seen, fault):
    from portbench import program, run
    traffic = scene["traffic"]
    run_record, prog, (archive, w) = run.train(scene, 2 ** 31 + 5, 0.0,
                                               False, "cpu", fault)
    res = run.held(scene, prog, archive, w, "cpu")
    assert res["correct"] == (fault is None), res["numbers"]
    assert run_record.failed == 0
    # the draws by name, the noise whole: (iters_d, ps, ps) and (ps, ps)
    assert len(prog["fed"]) == traffic["check_steps"]
    for batch, draws in prog["fed"]:
        assert set(draws) == set(scene["model"].DRAWS)
        assert draws["z_d"].shape[1] == draws["z_g"].shape[0] == len(batch)
        assert draws["noise_d"].shape == (1, 3, 3)
        assert draws["noise_g"].shape == (3, 3)
    # G saw half the batch under ``half_batch``, and the noise whole
    b = traffic["batch_size"] // (2 if fault == "half_batch" else 1)
    assert {(n, shape) for n, shape in noise_seen[:4]} == {(b, (3, 3))}
    # the rows fed are the archive's own
    assert None not in sum(program.rows_of([x for x, _ in prog["fed"]],
                                           archive), [])


def test_structure_spans_in_the_traced_steps(scene):
    from portbench import run, spans
    from tartangan_torch.utils import tracing
    tracing.reset()
    try:
        result, _, record = run.run_cell(scene, 2 ** 31 + 9, 0.0, True,
                                         "cpu")
        assert result["correct"], result["checks"]
        traced = spans.traced("scene.structure")
        # the D update's G forward and the G update's, in each traced step
        assert len(traced) == 2 * len(record.trace_r1) == 4
        # untraced, only the process's first step records its spans
        untraced = [r for r in spans.records()
                    if r.name == "scene.structure" and not r.profiled]
        assert {r.step for r in untraced} == {0} and len(untraced) == 2
        # no device times on the CPU: the reader gives nothing
        assert run.reader("scene_structure_device_ms")(record) is None
        assert "scene_structure_device_ms" not in result["metrics"]
    finally:
        tracing.reset()


def test_exponential_bound_by_hand():
    from portbench import exp_bound, flops
    # 132 SMs x 16 ex2 a clock x 1.98 GHz
    assert exp_bound.EX2_PER_S == pytest.approx(4.18176e12)
    # the scene G's attention at B 64: 64 x 65536 x 16384 logits
    assert exp_bound.exp_ms(64, 65536, 16384) == \
        pytest.approx(68719476736 / 4.18176e12 * 1e3)
    scene = flops.Attention("scene", 64, 65536, 16384, 2, 8)
    # SA-GAN's at 64x64 (Ck 8, Cv 32): 268,435,456 logits, 0.06419 ms,
    # above its bf16 products (0.0217 ms)
    sagan = flops.Attention("sagan", 64, 4096, 1024, 8, 32)
    step = flops.Step([], [], {"k1": [(scene, False, 1), (scene, True, 1),
                                      (sagan, True, 3)],
                               "k2": [(scene, 1), (sagan, 4)]})
    bound = exp_bound.kernel_bound_ms(step, "bf16")
    exp_scene = 16.433147
    exp_sagan = 268435456 / 4.18176e12 * 1e3
    assert exp_sagan == pytest.approx(0.064192, abs=1e-6)
    assert bound["k1"] == pytest.approx(2 * exp_scene + 3 * exp_sagan,
                                        abs=1e-5)
    assert bound["k2"] == pytest.approx(exp_scene + 4 * exp_sagan, abs=1e-5)
    # where the bytes take longer than the exponentials, the bytes bound:
    # one key, 2^20 queries of 64 channels in float32
    wide = flops.Attention("wide", 1, 2 ** 20, 1, 64, 64)
    by_bytes = flops.attention_bound_ms(1, 2 ** 20, 1, 64, 64, 4,
                                        peak=flops.peak_flops("f32"))
    one = flops.Step([], [], {"k1": [(wide, True, 1)], "k2": []})
    assert exp_bound.kernel_bound_ms(one, "f32")["k1"] == \
        pytest.approx(by_bytes)
    assert by_bytes > exp_bound.exp_ms(1, 2 ** 20, 1) * 100


def test_scene_readers_give_nothing_without_kernels():
    from types import SimpleNamespace

    from portbench import run
    record = SimpleNamespace(trace=SimpleNamespace(k1_ns=0, k2_ns=0))
    for name in ("scene_k1_roofline", "scene_k2_roofline"):
        assert run.reader(name)(record) is None
    assert run.reader("scene_k1_roofline")(SimpleNamespace(trace=None)) \
        is None

