"""The trainer's other paths on the data mesh (two gloo ranks against one
process, CNN trainer at config '8'): FID and the Inception Score while
training (each rank runs Inception on its rows of every sample batch;
the moment sums are all-reduced and the softmax rows gathered in the
one-process order), ``--device-data`` with ``--steps-per-call 2`` (the
two steps of a call run eagerly on the mesh), and ``--remat`` (the
recomputation re-runs BatchNorm's all-reduce). The accumulation itself is
held as ``test_fid_moments_match_across_mesh_sizes`` holds the JAX one:
a stand-in net over fixed features, moments and softmax rows.

Tolerances: the step's as in ``test_torch_mesh.py`` (metrics 1e-3, G's
parameters 5e-4, D's statistics 1e-3, the gradients of the last step
within TOL_GRAD_D and TOL_GRAD_G of the tower's largest); the logged IS
1e-4 relative (float32 sums in another order); Inception's softmax
rows, mean and covariance over the trainer's samples, and the
stand-in's, 1e-5, 1e-5 and 1e-4, as the JAX test's. The logged FID is only checked finite: from 16
samples the covariance has rank 15, and the distance to 2048-d moments
is not a well-conditioned number to compare.
"""
from pathlib import Path

import numpy as np
import pytest
import torch_mesh_workers as W
from test_torch_mesh import TOL_GRAD_D, TOL_GRAD_G, _close, _close_grads

from tartangan_torch.parallel import launch

FIXTURE = Path(__file__).parent / "fixtures" / "inception_calibrated.npz"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("paths")
    rng = np.random.default_rng(1)
    data = str(tmp / "d16.npz")
    np.savez(data, images=rng.integers(0, 256, (W.B, 16, 16, 3),
                                       dtype=np.uint8))
    moments = str(tmp / "m.npz")
    np.savez(moments, mu=rng.standard_normal(2048) * 0.1,
             sigma=np.eye(2048) * 0.5)
    paths = {
        "fid": ["--batch-size", "8", "--fid", "--fid-freq", "1",
                "--n-inception-imgs", "16", "--inception-moments", moments,
                "--inception-weights", str(FIXTURE)],
        "device_data": ["--batch-size", "8", "--device-data",
                        "--steps-per-call", "2", "--r1-interval", "2"],
        "remat": ["--remat", "--remat-policy", "convs"],
    }
    feats = rng.standard_normal((64, 2048)).astype(np.float32)
    w = (rng.standard_normal((2048, 1000)) * 0.01).astype(np.float32)
    one = W.paths_worker(data, str(tmp / "w1"), paths, feats, w,
                         str(FIXTURE))
    two = launch(W.paths_worker, 2, (data, str(tmp / "w2"), paths, feats,
                                     w, str(FIXTURE)))
    return one, two


def _same_step(a, b):
    assert a["steps"] == b["steps"]
    for k in ("g_loss", "d_loss", "gp"):
        assert abs(a["logs"][k] - b["logs"][k]) < 1e-3, (k, a, b)
    _close(a["g"], b["g"], 5e-4, "G params")
    _close(a["d_stats"], b["d_stats"], 1e-3, "D stats")
    # the last step's gradients; D's follow an update after the first step
    _close_grads(a["d_grad"], b["d_grad"],
                 TOL_GRAD_D if a["steps"] == 1 else TOL_GRAD_G, "D grads")
    _close_grads(a["g_grad"], b["g_grad"], TOL_GRAD_G, "G grads")


def test_fid_and_is_match_one_process(runs):
    one, two = runs
    a, b = one["fid"], two["fid"]
    _same_step(a, b)
    assert np.isfinite(a["logs"]["fid"]) and np.isfinite(b["logs"]["fid"])
    for k in ("inception_score_mean", "inception_score_std"):
        np.testing.assert_allclose(b["logs"][k], a["logs"][k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    (p1, mu1, s1), (p2, mu2, s2) = a["probe"], b["probe"]
    np.testing.assert_allclose(p1, p2, atol=1e-5)
    np.testing.assert_allclose(mu1, mu2, atol=1e-5)
    np.testing.assert_allclose(s1, s2, atol=1e-4)


def test_device_data_chunks_match_one_process(runs):
    one, two = runs
    assert one["device_data"]["steps"] == 2
    _same_step(one["device_data"], two["device_data"])


def test_remat_matches_one_process(runs):
    one, two = runs
    _same_step(one["remat"], two["remat"])


def test_activation_moments_match_one_process(runs):
    (p1, mu1, s1), (p2, mu2, s2) = (runs[0]["activations"],
                                    runs[1]["activations"])
    np.testing.assert_allclose(p1, p2, atol=1e-5)
    np.testing.assert_allclose(mu1, mu2, atol=1e-5)
    np.testing.assert_allclose(s1, s2, atol=1e-4)
