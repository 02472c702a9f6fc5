"""The port's profiler component (``--profile-dir``, ``--timing``) and its
start rule against the JAX package's.

The JAX component's ``jax.profiler`` calls are replaced by recorders here,
so only the rule of when a trace starts and stops is compared.
"""
import json

import numpy as np
import pytest
import torch

import tartangan_tpu.train.components.profiler as jax_profiler
from tartangan_torch.train.cnn import CNNTrainer
from tartangan_torch.train.components.profiler import ProfilerComponent


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tests run in several worker processes at once; torch's CPU ops
    at these small sizes gain nothing from more threads and, with every
    worker's threads spinning on the same cores, slow down many times."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_trainer_writes_trace_and_logs_rate(tiny_archive, tmp_path):
    """24 images at B 4, K = 2: calls at steps 0, 2 and 4; the trace
    covers the calls from the one holding step 1 to the one at step 2, and
    images/sec is logged at each call crossing a multiple of 2."""
    trace_dir = tmp_path / "trace"
    trainer = CNNTrainer.create_from_cli([
        tiny_archive, "--config", "16", "--batch-size", "4", "--epochs", "1",
        "--output", str(tmp_path / "o"), "--run-id", "p", "--gen-freq",
        "100", "--checkpoint-freq", "100", "--quiet-logs", "--device", "cpu",
        "--steps-per-call", "2", "--device-data", "--profile-dir",
        str(trace_dir), "--profile-start", "1", "--profile-steps", "1",
        "--timing", "--timing-freq", "2"])
    trainer.train()
    assert trainer.steps == 6
    trace = json.loads((trace_dir / "trace_1.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("conv" in n for n in names)
    rates = trainer.logs["images_per_sec"]
    assert len(rates) == 2 and all(np.isfinite(rates)) and min(rates) > 0


class _Args:
    profile_dir = "unused"
    profile_start = 6
    profile_steps = 3
    timing_freq = 0
    batch_size = 1


class _Trainer:
    device = torch.device("cpu")

    def __init__(self, k):
        self.steps_per_call = k
        self.args = _Args()


class _Recorder:
    def __init__(self):
        self.calls = []

    def start(self):
        self.calls.append("start")

    def stop(self):
        self.calls.append("stop")


def _starts(component, trainer, k):
    """The steps at which ``component`` starts a trace over calls of K
    steps from 0 to 20."""
    started = []
    component.trainer = trainer
    component.on_train_begin(0, {})
    for steps in range(0, 20, k):
        before = _active(component)
        component.on_batch_begin(steps, {})
        if _active(component) and not before:
            started.append(steps)
        component.on_batch_end(steps, {})
    return started


def _active(component):
    return bool(getattr(component, "_active", False)
                or getattr(component, "_prof", None) is not None)


@pytest.mark.parametrize("k,ours,jax_rule", [(1, [6], [6]), (2, [6], [6]),
                                             (4, [4], [])])
def test_chunk_aware_start(monkeypatch, k, ours, jax_rule):
    """At K = 1 (and any K dividing the start) both rules start at
    --profile-start; at K = 4 with start 6 the port starts in the call
    [4, 8) and the JAX component never starts (its fault, recorded in
    ROADMAP.md)."""
    monkeypatch.setattr(torch.profiler, "profile",
                        lambda activities: _Recorder())
    monkeypatch.setattr(ProfilerComponent, "_stop",
                        lambda self: setattr(self, "_prof", None))
    recorder = _Recorder()
    monkeypatch.setattr(jax_profiler.jax.profiler, "start_trace",
                        lambda d: recorder.start())
    monkeypatch.setattr(jax_profiler.jax.profiler, "stop_trace",
                        recorder.stop)
    assert _starts(ProfilerComponent(_Args()), _Trainer(k), k) == ours
    assert _starts(jax_profiler.ProfilerComponent(_Args()), _Trainer(k),
                   k) == jax_rule
    assert recorder.calls.count("start") == len(jax_rule)
