"""The port's spans and launch counters (``tartangan_torch/utils/tracing.py``):
what a step records with and without a profiler, how the spans nest, that
each is the profiler's ``record_function`` event of its name on the same
clock, and that a span records no CUDA events inside a capture.

The card's cases skip without one; on the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py
"""
import torch_threads  # noqa: F401  (this process's share of the cores)
import sys
import threading
import tracemalloc

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from tartangan_torch import native
from tartangan_torch.train.cnn import CNNTrainer
from tartangan_torch.utils import tracing

EDGE_NS = 100_000  # a span's host edges against its profiler event


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """No spans of earlier tests, this test's first step the process's
    first, and the native crop loaded anew (its ``setup.libs`` span); one
    torch thread, as the other trainer tests."""
    tracing.reset()
    monkeypatch.setattr(native, "_LIB", None)
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
    tracing.reset()


@pytest.fixture
def archive(tmp_path):
    images = np.random.default_rng(0).integers(0, 256, (24, 16, 16, 3),
                                               dtype=np.uint8)
    path = tmp_path / "data.npz"
    np.savez(path, images=images)
    return str(path)


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return name


DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _trainer(archive, tmp_path, device="cpu", *extra):
    """A '16' trainer over 24 images at B 4: 6 steps in an epoch."""
    return CNNTrainer.create_from_cli([
        archive, "--config", "16", "--batch-size", "4", "--epochs", "1",
        "--output", str(tmp_path / "o"), "--run-id", "t", "--gen-freq",
        "100", "--checkpoint-freq", "100", "--quiet-logs", "--device",
        device, *extra])


def _profiled(trainer, device):
    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        trainer.train()
    return prof


def _names(recs):
    return [r.name for r in recs]


def test_without_a_profiler_only_setup_and_the_first_step(archive, tmp_path):
    """Without a profiler the set-up's spans and the first step's are
    recorded, once; the five steps after it record nothing, and a span
    there is the shared null context, which allocates nothing."""
    trainer = _trainer(archive, tmp_path)
    trainer.train()
    assert trainer.steps == 6
    recs = tracing.records()
    names = _names(recs)
    for name in ("setup.models", "setup.data", "train.data", "train.step",
                 "step.d", "step.g", "setup.libs"):
        assert names.count(name) == 1, (name, names)
    assert {r.step for r in recs if r.name.startswith(("train.", "step."))
            } == {0}
    assert not any(r.profiled for r in recs)
    assert all(r.end_ns >= r.start_ns for r in recs)
    assert [r.meta for r in recs if r.name == "setup.libs"] == [
        {"lib": "native_crop", "compiled": False}]

    off = tracing.span("train.step")
    assert off is tracing.span("step.d")
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(100):
            with tracing.span("train.step"):
                pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    here = [tracemalloc.Filter(True, tracing.__file__),
            tracemalloc.Filter(True, __file__)]
    grown = after.filter_traces(here).compare_to(
        before.filter_traces(here), "lineno")
    assert not [s for s in grown if s.count_diff > 0], grown
    assert len(tracing.records()) == len(recs)


@pytest.mark.parametrize("device", DEVICES)
def test_spans_nest_with_their_steps_under_a_profiler(archive, tmp_path,
                                                      device):
    """Under a profiler every step records its spans: ``step.d`` and
    ``step.g`` inside ``train.step`` of the same step, the loop's spans at
    the top, the set-up's before any step, the native crop's load inside
    the first ``train.data``."""
    trainer = _trainer(archive, tmp_path, _device(device))
    _profiled(trainer, device)
    recs = tracing.records()
    assert all(r.profiled for r in recs)
    assert [r.step for r in recs if r.name == "train.step"] == list(range(6))
    for r in recs:
        parent = recs[r.parent] if r.parent is not None else None
        if r.name in ("step.d", "step.g"):
            assert parent.name == "train.step" and parent.step == r.step
        elif r.name == "setup.libs":
            assert parent.name == "train.data" and r.step == 0
        else:
            assert parent is None, (r.name, parent)
        if r.name.startswith("setup.") and r.name != "setup.libs":
            assert r.step is None
    steps = [r for r in recs if r.name == "train.step"]
    for name in ("step.d", "step.g"):
        assert [recs[r.parent] for r in recs if r.name == name] == steps
    if device == "cuda":
        for r in recs:
            if r.name.startswith(("train.", "step.")):
                assert r.device_ms is not None and r.device_ms >= 0
        assert all(r.device_ms is None for r in recs
                   if r.name == "setup.models")  # before CUDA's first use
    else:
        assert all(r.device_ms is None for r in recs)


def _worst_edge(trainer, device):
    """(ns, where): the largest distance between a span's host edge and
    its profiler event's, over a profiled run of ``trainer``."""
    prof = _profiled(trainer, device)
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU and e.name().startswith(
                ("train.", "step.", "setup.")):
            events.setdefault(e.name(), []).append((e.start_ns(),
                                                    e.end_ns()))
    spans = {}
    for r in tracing.records():
        spans.setdefault(r.name, []).append((r.start_ns, r.end_ns))
    assert sorted(spans) == sorted(events)
    worst = (0, None)
    for name, edges in spans.items():
        assert len(edges) == len(events[name]), name
        for (s0, s1), (e0, e1) in zip(sorted(edges), sorted(events[name])):
            worst = max(worst, (abs(s0 - e0), f"{name} start"),
                        (abs(s1 - e1), f"{name} end"))
    return worst


@pytest.mark.parametrize("device", DEVICES)
def test_each_span_is_its_profiler_event(archive, tmp_path, device):
    """Each span is a ``record_function`` event of its name in the
    profiler's trace, its host edges within 100 us of the event's. The
    two clocks are read one call apart, and on a loaded machine the
    scheduler or a garbage collection can part them by more once in a
    while: of three runs, one must hold every edge."""
    runs = []
    for _ in range(3):
        tracing.reset()
        runs.append(_worst_edge(
            _trainer(archive, tmp_path, _device(device)), device))
        if runs[-1][0] <= EDGE_NS:
            break
    assert runs[-1][0] <= EDGE_NS, runs


def test_chunks_on_the_device_archive_under_a_profiler(archive, tmp_path):
    """``--steps-per-call 2 --device-data`` trains under a profiler: three
    calls, each a ``train.step`` span holding its two steps' updates."""
    trainer = _trainer(archive, tmp_path, "cpu", "--steps-per-call", "2",
                       "--device-data")
    _profiled(trainer, "cpu")
    assert trainer.steps == 6
    recs = tracing.records()
    steps = [r for r in recs if r.name == "train.step"]
    assert [r.step for r in steps] == [0, 2, 4]
    for name in ("step.d", "step.g"):
        inner = [r for r in recs if r.name == name]
        assert [recs[r.parent] for r in inner] == [s for s in steps
                                                   for _ in range(2)]
    assert torch.isfinite(torch.stack(trainer.logs["d_loss"])).all()


@pytest.mark.cuda
def test_no_cuda_events_inside_a_capture():
    """A span inside a CUDA graph's capture keeps its host times and no
    device time; one outside it has both."""
    device = _device("cuda")
    x = torch.ones(1024, device=device)
    with tracing.span("outside", always=True):
        y = x * 2
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        y = x * 2  # warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        with tracing.span("inside", always=True):
            y = x * 3
    graph.replay()
    torch.cuda.synchronize()
    outside, inside = tracing.records()
    assert outside.device_ms is not None and outside.device_ms >= 0
    assert inside.name == "inside" and inside.events is None
    assert inside.device_ms is None and inside.end_ns >= inside.start_ns
    assert torch.equal(y, x * 3)


def test_count_launch_counts_every_launch_across_threads():
    """One lock for every counter: 16 threads counting at once on a short
    switch interval lose no launch, in total or by dtype."""
    @tracing.counted
    def kernel():
        pass

    def launch(dtype):
        for _ in range(2000):
            tracing.count_launch(kernel, dtype)

    dtypes = (torch.float32, torch.bfloat16)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launch, args=(dtypes[i % 2],))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert kernel.launches == 32000
    assert kernel.launches_by_dtype == {torch.float32: 16000,
                                        torch.bfloat16: 16000}
