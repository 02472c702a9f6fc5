"""The surrogate Inception's calibration (``tartangan_torch/eval/
calibrate.py``) against the JAX package's (``tartangan_tpu/eval/
calibrate.py``).

- ``calibrate_variables`` on the same uint8 images at ``rounds=4`` (the
  four stem levels), with the same seed: every BatchNorm statistic within
  1e-4 of the JAX value relative to the largest of its leaf (a mean near
  0 has no scale of its own; float32 convolutions in another order).
- A full calibration meets the JAX test's convergence bound: on other
  images than it saw, each conv's actual variance over its stored one has
  a median under 4 and a maximum under 64.
- ``save_stats_npz``'s output has the key set of
  ``tests/fixtures/inception_calibrated.npz`` and loads in both packages'
  ``load_weights_npz``.
- ``_bn_levels`` gives each BatchNorm path the level the JAX package's
  gives it.
"""
import torch_threads  # noqa: F401  (this process's share of the cores)
from pathlib import Path

import numpy as np
import pytest
import torch

from tartangan_torch.eval import calibrate as C
from tartangan_torch.models.inception import init_inception, load_weights_npz

FIXTURE = Path(__file__).parent / "fixtures" / "inception_calibrated.npz"


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).integers(0, 256, (16, 32, 32, 3),
                                             dtype=np.uint8)


def _jax_order():
    import jax
    import jax.numpy as jnp

    from tartangan_tpu.eval.calibrate import _conv_bn_pairs
    from tartangan_tpu.models.inception import init_inception as jax_init
    model, variables = jax_init()
    _, state = jax.eval_shape(
        lambda v, xx: model.apply(
            v, xx, capture_intermediates=lambda mdl, name: (
                name == "__call__" and mdl.name == "conv")),
        variables, jnp.zeros((1, 299, 299, 3), jnp.float32))
    return [p for p, _ in _conv_bn_pairs(state["intermediates"])]


def test_bn_levels_match_jax():
    from tartangan_tpu.eval.calibrate import _bn_levels as jax_levels
    order = [p for p, _ in C.conv_outputs(
        init_inception(), torch.zeros(1, 3, 299, 299))]
    jorder = _jax_order()
    assert sorted(order) == sorted(jorder) and len(order) == 94
    assert C._bn_levels(order) == jax_levels(jorder)
    assert C._bn_levels(order) == jax_levels(order)


def test_four_rounds_match_jax(images, tmp_path):
    import flax

    from tartangan_tpu.eval.calibrate import calibrate_variables
    _, jvars = calibrate_variables(images, rounds=4, batch_size=4, seed=3)
    ref = flax.traverse_util.flatten_dict(jvars["batch_stats"], sep=".")
    model = C.calibrate_variables(images, rounds=4, batch_size=4, seed=3)
    path = tmp_path / "ours.npz"
    C.save_stats_npz(model, path)
    written = 0
    with np.load(path) as ours:
        for key, want in ref.items():
            got = ours[f"batch_stats.{key}"]
            want = np.asarray(want)
            scale = float(np.abs(want).max())
            np.testing.assert_allclose(got, want, rtol=1e-4,
                                       atol=1e-4 * scale, err_msg=key)
            fresh = 0.0 if key.endswith("mean") else 1.0
            written += not np.all(want == fresh)
    assert written >= 8  # the four stem levels' means and variances


def test_full_calibration_converges(images):
    model = C.calibrate_variables(images, batch_size=4)
    bns = {p: m for p, m in zip(
        C.bn_paths(model).values(),
        (dict(model.named_modules())[n] for n in C.bn_paths(model)))}
    ratios = []
    for path, y in C.conv_outputs(model, C._prep_batch(images[:8])):
        y = y.double()
        v_actual = max(float(y.var(dim=(0, 2, 3), unbiased=False).mean()),
                       1e-3)
        v_stored = max(float(bns[path].running_var.double().mean()), 1e-3)
        ratios.append(v_actual / v_stored)
    ratios = np.array(ratios)
    assert len(ratios) == 94
    assert float(np.median(ratios)) < 4.0
    assert float(ratios.max()) < 64.0


def test_stats_npz_loads_in_both_packages(images, tmp_path):
    import flax

    from tartangan_tpu.models.inception import init_inception as jax_init
    from tartangan_tpu.models.inception import (
        load_weights_npz as jax_load_weights_npz,
    )
    model = C.calibrate_variables(images, rounds=2, batch_size=4)
    path = tmp_path / "stats.npz"
    C.save_stats_npz(model, path)
    with np.load(path) as ours, np.load(FIXTURE) as fixture:
        assert set(ours.files) == set(fixture.files)
        stats = {k: ours[k] for k in ours.files}
    loaded = load_weights_npz(init_inception(), path)
    for name, t in loaded.state_dict().items():
        torch.testing.assert_close(t, model.state_dict()[name], rtol=0,
                                   atol=0)
    _, template = jax_init()
    jloaded = flax.traverse_util.flatten_dict(
        jax_load_weights_npz(template, str(path)), sep=".")
    for key, value in stats.items():
        np.testing.assert_array_equal(np.asarray(jloaded[key]), value)
