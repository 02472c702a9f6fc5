"""The per-layer metrics that read the program's spans, on a tiny traced
run on the CPU: the device's milliseconds give nothing there, the host's
seconds give positive numbers; with no spans every reader gives nothing."""
import pytest

SPANS = ("data_wait_ms", "d_update_device_ms", "g_update_device_ms")
HOST = ("first_step_s", "libs_load_s", "trainer_build_s")


@pytest.fixture
def traced_run(tiny, monkeypatch):
    """A traced run of a tiny cell, its spans the only ones recorded, the
    native crop loaded in it."""
    from portbench import run
    from tartangan_torch import native
    from tartangan_torch.utils import tracing
    tracing.reset()
    monkeypatch.setattr(native, "_LIB", None)
    s = tiny("sagan-512thin-r1-b64", blocks=(16, 16, 8), attention=(1,))
    result, _, record = run.run_cell(s, 2 ** 31 + 11, 0.0, True, "cpu")
    yield result, record
    tracing.reset()


def test_readers_on_a_traced_cpu_run(traced_run):
    from portbench import run, spans
    result, record = traced_run
    for name in SPANS:
        assert run.reader(name)(record) is None, name  # no device times
        assert name not in result["metrics"]
    for name in HOST:
        value = run.reader(name)(record)
        assert value > 0, name
        assert result["metrics"][name] == {"value": value, "unit": "s"}
    steps = spans.traced("train.step")
    assert len(steps) == len(record.trace_r1) == 2
    for name in ("train.data", "step.d", "step.g"):
        assert len(spans.traced(name)) >= 2, name
    first = [r for r in spans.records() if r.name == "train.step"][0]
    assert not first.profiled and first.step == 0


def test_readers_give_nothing_without_spans(monkeypatch):
    from portbench import run, spans
    monkeypatch.setattr(spans, "records", lambda: [])
    for name in SPANS + HOST:
        assert run.reader(name)(None) is None, name
