"""Tensor parallelism (``--tp``): the weights' output channels sharded
over the model group (``tartangan_torch/parallel/tp.py``).

- A (data 2, model 2) mesh of four gloo ranks against one process, for
  the CNN and IQN trainers at config '8', B 16 (the counterpart of
  ``test_dp_tp_mesh_matches_single_device``), at the JAX test's
  tolerances: metrics 1e-3, G's parameters 5e-4, D's statistics 1e-3;
  and G's and D's gradients as ``tests/test_torch_mesh.py`` holds them
  (a weight's gradient summed over the model group as well would add
  other ranks' slices into it).
- The placement summary's counts against the JAX package's
  ``param_sharding`` over the JAX trainer's state on the same config; and
  the sharded parameters a rank holds against the kernels the summary
  counts.
- The CNN trainer's CLI with ``--tp 2`` against ``--tp 1`` (one process),
  two steps (the counterpart of ``test_tp_training_matches_dp``: losses
  1e-3, G's parameters 5e-3, as there; the second step's gradients within
  TOL_GRAD_G); the tp-2 run's checkpoint
  resumes in a one-process port trainer and in the JAX trainer, bit for
  bit, and a tp-2 mesh resumes the one-process run's checkpoint and writes
  it back unchanged.
"""
import io
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch_mesh_workers as W
from test_torch_mesh import (
    TOL_GRAD_D,
    TOL_GRAD_G,
    _close,
    _close_grads,
    _leaves,
)

from tartangan_torch.parallel import launch
from tartangan_torch.parallel.tp import placement_counts
from tartangan_torch.train.cnn import CNNTrainer, main
from tartangan_torch.utils import msgpack

ARTIFACTS = ("g", "g_target", "d", "opt_g", "opt_d")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(2)
    path = str(tmp / "d16.npz")
    np.savez(path, images=rng.integers(0, 256, (W.B, 16, 16, 3),
                                       dtype=np.uint8))
    return tmp, path


@pytest.fixture(scope="module")
def dp_tp_runs(data):
    tmp, path = data
    one = W.run_families(path, None, str(tmp / "w1"), ["cnn", "iqn"])
    four = launch(W.tp_worker, 4, (path, str(tmp / "w4"), ["cnn", "iqn"]),
                  tp=2)
    return one, four


@pytest.mark.parametrize("family", ["cnn", "iqn"])
def test_dp_tp_mesh_matches_one_process(dp_tp_runs, family):
    one, four = dp_tp_runs
    a, b = one[family], four[family]
    for k in a["logs"]:
        assert abs(a["logs"][k] - b["logs"][k]) < 1e-3, (k, a, b)
    _close(a["g"], b["g"], 5e-4, "G params")
    _close(a["d_stats"], b["d_stats"], 1e-3, "D stats")
    _close_grads(a["d_grad"], b["d_grad"], TOL_GRAD_D, f"{family} D grads")
    _close_grads(a["g_grad"], b["g_grad"], TOL_GRAD_G, f"{family} G grads")


def _jax_counts(tmp, path, tp):
    """The JAX trainer's placement summary over its state (config '8')."""
    from tartangan_tpu.parallel.mesh import make_mesh, param_sharding
    from tartangan_tpu.train.cnn import CNNTrainer as JaxCNNTrainer
    jt = JaxCNNTrainer.create_from_cli([
        path, "--config", "8", "--batch-size", str(W.B), "--output",
        str(tmp / "jax"), "--run-id", "counts", "--dtype", "f32"])
    jt.build_models()
    out = io.StringIO()
    with redirect_stdout(out):
        param_sharding(jax.device_get(jt.state), make_mesh(8, tp=tp))
    words = out.getvalue().split()
    return {"sharded": int(words[words.index("weight") - 1]),
            "replicated": int(words[words.index("replicated") - 1])}


def test_placement_counts_match_jax(data, dp_tp_runs):
    tmp, path = data
    port = CNNTrainer.create_from_cli(W.trainer_argv(
        path, str(tmp / "counts"), "counts", ["--config", "8"]))
    port.build_models()
    for tp in (2, 4):
        assert placement_counts(port.checkpoint_artifacts(), tp) \
            == _jax_counts(tmp, path, tp)
    # what a rank holds sharded: each counted kernel of G's and D's
    # parameters (the summary also counts the EMA target's and the
    # moments')
    art = port.checkpoint_artifacts()
    kernels = placement_counts({"g": art["g"]["params"],
                                "d": art["d"]["params"]}, 2)["sharded"]
    assert dp_tp_runs[1]["cnn"]["probe"] == kernels > 0


def _cli_argv(path, out, run_id, *extra, jax_trainer=False):
    device = ["--dtype", "f32"] if jax_trainer else ["--device", "cpu"]
    return [path, "--config", "8", "--batch-size", "8", "--epochs", "1",
            "--output", out, "--run-id", run_id, "--gen-freq", "100",
            "--checkpoint-freq", "100", "--quiet-logs", "--seed", "4",
            *device, *extra]


def _checkpoint(out, run_id, steps):
    return {name: msgpack.loads(
        open(f"{out}/{run_id}/checkpoints/{steps}/{name}.msgpack",
             "rb").read()) for name in ARTIFACTS}


def test_tp_cli_matches_one_process_and_checkpoints_cross(data):
    tmp, path = data
    out = str(tmp / "cli")
    logs_tp = main(_cli_argv(path, out, "tp2", "--tp", "2"))
    logs_one = main(_cli_argv(path, out, "one", "--tp", "1"))
    for k in ("g_loss", "d_loss", "gp"):
        np.testing.assert_allclose(logs_tp[k], logs_one[k], rtol=1e-3,
                                   atol=1e-3, err_msg=k)
    tp2, one = _checkpoint(out, "tp2", 2), _checkpoint(out, "one", 2)
    _close(tp2["g"]["params"], one["g"]["params"], 5e-3, "G params")
    # the second step's gradients, which follow the first step's updates
    # (float32 readings 2.7e-6 for G, 7.2e-7 for D)
    for name in ("opt_g", "opt_d"):
        _close_grads(one[name]["0"]["mu"], tp2[name]["0"]["mu"], TOL_GRAD_G,
                     f"{name} grads")

    # the tp-2 checkpoint resumes in a one-process port trainer
    ours = CNNTrainer.create_from_cli(_cli_argv(
        path, out, "tp2", "--resume-training-latest", "--epochs", "0"))
    ours.train()
    assert ours.steps == 2
    mine = ours.checkpoint_artifacts()
    for name in ARTIFACTS:
        _close(mine[name], tp2[name], 0, name)

    # ... and in the JAX trainer
    from flax import serialization

    from tartangan_tpu.train.cnn import CNNTrainer as JaxCNNTrainer
    jt = JaxCNNTrainer.create_from_cli(_cli_argv(
        path, out, "tp2", "--resume-training-latest", "--epochs", "0",
        jax_trainer=True))
    jt.train()
    assert jt.steps == 2
    theirs = jax.device_get(jt.checkpoint_artifacts())
    for name in ARTIFACTS:
        ref = serialization.to_state_dict(theirs[name])
        assert dict(_leaves(ref)).keys() == dict(_leaves(tp2[name])).keys()
        _close(ref, tp2[name], 0, name)

    # a tp-2 mesh resumes the one-process checkpoint and writes it back
    main(_cli_argv(path, out, "one", "--tp", "2",
                   "--resume-training-latest", "--epochs", "0"))
    again = _checkpoint(out, "one", 2)
    for name in ARTIFACTS:
        _close(again[name], one[name], 0, name)
