"""The port's native batcher (``tartangan_torch/native``): the C++ gather
and crop against numpy and against the JAX package's library, byte for
byte, and the port's archive dataset batching through it."""
import torch_threads  # noqa: F401  (this process's share of the cores)
import numpy as np
import pytest

from tartangan_torch import native
from tartangan_torch.data.image_bytes import ImageBytesDataset


@pytest.fixture()
def archive(rng):
    return rng.integers(0, 256, (10, 12, 14, 3), dtype=np.uint8)


def test_crop_matches_numpy_and_jax(archive):
    from tartangan_tpu import native as jax_native
    indices = np.array([3, 1, 7, 7, 0])
    ys = np.array([0, 2, 4, 1, 4], np.int32)
    xs = np.array([5, 0, 3, 2, 6], np.int32)
    out = native.crop_batch(archive, indices, ys, xs, 8)
    assert out.shape == (5, 8, 8, 3) and out.dtype == np.uint8
    np.testing.assert_array_equal(
        out, native.crop_batch_plain(archive, indices, ys, xs, 8))
    ref = jax_native.crop_batch(archive, indices, ys, xs, 8)
    assert ref is not None
    np.testing.assert_array_equal(out, ref)


def test_gather_matches_numpy_and_jax(archive):
    from tartangan_tpu import native as jax_native
    indices = np.array([5, 0, 2, 5])
    out = native.gather_batch(archive, indices)
    np.testing.assert_array_equal(out,
                                  native.gather_batch_plain(archive, indices))
    np.testing.assert_array_equal(out, jax_native.gather_batch(archive,
                                                               indices))


def test_crop_outside_the_archive_raises(archive):
    with pytest.raises(IndexError):
        native.crop_batch(archive, np.array([0]), np.array([5]),
                          np.array([0]), 8)
    with pytest.raises(IndexError):
        native.gather_batch(archive, np.array([10]))


def test_dataset_batches_through_the_library(archive, monkeypatch):
    """The archive dataset's batch is the library's crop of the offsets it
    draws, the JAX package's dataset's batch from the same seed."""
    from tartangan_tpu.data.image_bytes import (
        ImageBytesDataset as JaxImageBytesDataset,
    )
    calls = []
    real = native.crop_batch
    monkeypatch.setattr(native, "crop_batch",
                        lambda *a: calls.append(a) or real(*a))
    ours = ImageBytesDataset(archive, crop_size=8).batch(
        np.arange(4), np.random.default_rng(7))
    theirs = JaxImageBytesDataset(archive, crop_size=8).batch(
        np.arange(4), np.random.default_rng(7))
    assert len(calls) == 1
    np.testing.assert_array_equal(ours, theirs)
    whole = ImageBytesDataset(archive).batch(np.array([4, 1]), None)
    np.testing.assert_array_equal(whole, archive[[4, 1]])


def test_build_failure_raises(monkeypatch, tmp_path):
    """No quiet fallback: a compiler that fails makes ``load`` raise."""
    broken = tmp_path / "crop.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="native crop build failed"):
        native.load()
