"""The port's trainer with ``--fid`` and ``--metrics-collector`` against the
JAX package's components, on the CPU.

``python -m tartangan_torch.train.cnn --device cpu --config 8 --fid
--fid-freq 2 --metrics-collector {tensorboard,katib,kubeflow}`` trains 2
epochs with the real 299x299 Inception (the seed-0 template and the
committed calibrated statistics) against moments made by the port's
moments CLI, and logs a finite FID. Its TensorBoard event file is, byte for
byte, what the JAX package's encoder writes for the same scalars at the
same wall times; its Katib ini and Kubeflow JSON equal the files the JAX
components write from the same logs.
"""
import torch_threads  # noqa: F401  (this process's share of the cores)
import configparser
import json
import os
from collections import defaultdict
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import tartangan_tpu.utils.tb_events as jtb
from tartangan_tpu.train.components.metrics import (
    KatibMetricsComponent as JaxKatib,
    KubeflowMetricsComponent as JaxKubeflow,
)
from tartangan_tpu.train.components.metrics.fid import (
    FIDComponent as JaxFIDComponent,
)
from tartangan_torch.eval import moments
from tartangan_torch.train.cnn import CNNTrainer
from tartangan_torch.train.components.metrics.fid import FIDComponent
from tartangan_torch.utils import tb_events

CALIBRATED = os.path.join(os.path.dirname(__file__), "fixtures",
                          "inception_calibrated.npz")


@pytest.fixture(scope="module")
def fid_data(tmp_path_factory):
    """A 16-image 8x8 archive (2 batches of 8 an epoch) and its moments."""
    root = tmp_path_factory.mktemp("fid")
    images = np.random.default_rng(0).integers(0, 256, (16, 8, 8, 3),
                                               dtype=np.uint8)
    archive = str(root / "data.npz")
    np.savez(archive, images=images)
    mpath = str(root / "moments.npz")
    moments.main([archive, mpath, "--batch-size", "8", "--device", "cpu",
                  "--inception-weights", CALIBRATED, "--quiet-logs"])
    return archive, mpath


def _train(archive, mpath, out, collector):
    trainer = CNNTrainer.create_from_cli([
        archive, "--config", "8", "--batch-size", "8", "--epochs", "2",
        "--output", str(out), "--run-id", "fidrun", "--gen-freq", "100",
        "--checkpoint-freq", "100", "--quiet-logs", "--device", "cpu",
        "--fid", "--fid-freq", "2", "--n-inception-imgs", "8",
        "--inception-moments", mpath, "--inception-weights", CALIBRATED,
        "--metrics-collector", collector,
        "--metrics-path", str(out / f"metrics.{collector}")])
    trainer.train()
    return trainer


def _float_logs(logs):
    out = defaultdict(list)
    for key, values in logs.items():
        out[key] = [float(v) for v in values]
    return out


@pytest.mark.parametrize("collector", ["tensorboard", "katib", "kubeflow"])
def test_trainer_fid_and_collector_match_jax(fid_data, tmp_path, collector):
    archive, mpath = fid_data
    trainer = _train(archive, mpath, tmp_path, collector)
    logs = _float_logs(trainer.logs)
    # steps 0-3; batch_end sees the step before its increment: fires at 2
    assert trainer.steps == 4
    assert len(logs["fid"]) == 1 and np.isfinite(logs["fid"][0])
    assert logs["fid"][0] >= 0
    for key in ("inception_score_mean", "inception_score_std"):
        assert len(logs[key]) == 1 and np.isfinite(logs[key][0])
    path = tmp_path / f"metrics.{collector}"

    if collector == "tensorboard":
        (name,) = os.listdir(path / "fidrun")
        assert name.startswith("events.out.tfevents.")
        event_file = path / "fidrun" / name
        records = tb_events.read_records(event_file)
        decoded = [tb_events.decode_scalar_event(r) for r in records]
        # what the JAX writer writes at the same wall times
        expected = jtb.tfrecord(jtb.encode_file_version_event(decoded[0][0]))
        for wall, step, scalars in decoded[1:]:
            expected += jtb.tfrecord(jtb.encode_scalar_event(
                step, scalars, wall))
        assert event_file.read_bytes() == expected
        assert [d[1] for d in decoded[1:]] == [0, 1, 2, 3]
        # each batch's latest values, fid from step 2 on
        for step in range(4):
            scalars = decoded[1 + step][2]
            n_fid = 1 if step >= 2 else 0
            assert ("CNNTrainer/fid" in scalars) == bool(n_fid)
            assert scalars["CNNTrainer/g_loss"] == np.float32(
                logs["g_loss"][step])
        assert decoded[-1][2]["CNNTrainer/fid"] == np.float32(logs["fid"][0])
        return

    ref = tmp_path / f"jax.{collector}"
    comp = {"katib": JaxKatib, "kubeflow": JaxKubeflow}[collector]
    comp(SimpleNamespace(metrics_path=str(ref))).on_train_end(
        trainer.steps, logs)
    assert path.read_text() == ref.read_text()
    if collector == "katib":
        config = configparser.ConfigParser()
        config.read(path)
        assert float(config["metrics"]["fid"]) == logs["fid"][0]
    else:
        by_name = {m["name"]: m["numberValue"]
                   for m in json.loads(path.read_text())["metrics"]}
        assert by_name["inception-score-mean"] == \
            logs["inception_score_mean"][0]


def test_generate_stays_on_the_device_and_sample_g_reads_it(fid_data,
                                                             tmp_path):
    """``generate`` gives G's NCHW tensor on the training device (what FID
    consumes); ``sample_g`` is the same images as NHWC numpy."""
    archive, _ = fid_data
    trainer = CNNTrainer.create_from_cli([
        archive, "--config", "8", "--batch-size", "8", "--epochs", "0",
        "--output", str(tmp_path), "--device", "cpu", "--quiet-logs"])
    trainer.train()
    z = trainer.sample_z(5)
    images = trainer.generate(z=z)
    assert isinstance(images, torch.Tensor)
    assert images.device == trainer.device and images.shape == (5, 3, 8, 8)
    np.testing.assert_array_equal(
        trainer.sample_g(z=z), images.permute(0, 2, 3, 1).numpy())


@pytest.mark.parametrize("freq", [1, 2, 3])
def test_fid_firing_rule_matches_jax(freq):
    """``steps and every(fid_freq, steps)``: the same steps as the JAX
    component, never at step 0."""
    fired = {}
    for cls in (FIDComponent, JaxFIDComponent):
        comp = cls(SimpleNamespace())
        comp.trainer = SimpleNamespace(args=SimpleNamespace(fid_freq=freq))
        comp._calculate = lambda: (1.0, 0.0, 2.0)
        logs = defaultdict(list)
        fired[cls] = []
        for steps in range(10):
            n = len(logs["fid"])
            comp.on_batch_end(steps, logs)
            if len(logs["fid"]) > n:
                fired[cls].append(steps)
    assert fired[FIDComponent] == fired[JaxFIDComponent]
    assert fired[FIDComponent] == list(range(freq, 10, freq))


@pytest.mark.parametrize("step,scalars", [
    (0, {}), (7, {"T/a": 1.5}), (2 ** 40, {"T/fid": 3.25e2, "T/b": -1e-30}),
    (123, {"Ünicode/x": float("inf"), "T/y": 0.1})])
def test_event_encoding_matches_jax(step, scalars):
    wall = 1.7e9 + 0.123456
    ours = tb_events.tfrecord(tb_events.encode_scalar_event(step, scalars,
                                                            wall))
    assert ours == jtb.tfrecord(jtb.encode_scalar_event(step, scalars, wall))
    assert tb_events.encode_file_version_event(wall) == \
        jtb.encode_file_version_event(wall)
    data = tb_events.encode_scalar_event(step, scalars, wall)
    back = tb_events.decode_scalar_event(data)
    assert back[:2] == (wall, step)
    assert back[2] == {k: float(np.float32(v)) for k, v in scalars.items()}


def test_read_records_rejects_a_corrupt_file(tmp_path):
    writer = tb_events.ScalarEventWriter(str(tmp_path))
    writer.add_scalars(1, {"T/a": 2.0})
    writer.close()
    (name,) = os.listdir(tmp_path)
    path = tmp_path / name
    assert len(tb_events.read_records(path)) == 2
    raw = bytearray(path.read_bytes())
    raw[-6] ^= 1
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError):
        tb_events.read_records(path)
