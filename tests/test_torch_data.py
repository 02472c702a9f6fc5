"""The port's data paths (``tartangan_torch/data``) against the JAX
package's: the prep CLI, the folder dataset and its cache, and the
device-resident archive's gather (``--device-data``).

Each comparison is exact (uint8 arrays, bit for bit): both packages resize
with the same Pillow calls, and the device gather indexes the same rows and
windows as the JAX sampler when fed its indices and offsets. The folder of
images is written by the test itself, PNGs of mixed sizes and aspects.
"""
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tartangan_torch.data import device as D
from tartangan_torch.data.image_bytes import (
    ImageBytesDataset,
    main as prep_main,
)
from tartangan_torch.data.image_folder import ImageFolderDataset
from tartangan_torch.train.cnn import CNNTrainer
from tartangan_tpu.data.device import make_device_sampler
from tartangan_tpu.data.image_bytes import main as jax_prep_main
from tartangan_tpu.data.image_folder import (
    ImageFolderDataset as JaxImageFolderDataset,
)
from tartangan_tpu.train.trainer import Trainer as JaxTrainer

# (width, height) of the images in the test's folder: square, landscape,
# portrait, smaller and larger than the target size
SIZES = [(20, 20), (37, 23), (19, 41), (12, 12), (64, 30), (25, 26)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tests run in several worker processes at once; torch's CPU ops
    at these small sizes gain nothing from more threads and, with every
    worker's threads spinning on the same cores, slow down many times."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture()
def image_dir(tmp_path, rng):
    root = tmp_path / "images"
    (root / "sub").mkdir(parents=True)
    for i, (w, h) in enumerate(SIZES):
        pixels = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        folder = root / "sub" if i % 2 else root
        Image.fromarray(pixels).save(folder / f"img{i}.png")
    (root / "notes.txt").write_text("not an image")
    return root


@pytest.mark.parametrize("flags", [["--square"], [], ["--trunc", "4"]],
                         ids=["square", "aspect", "trunc"])
def test_prep_cli_matches_jax(image_dir, tmp_path, flags):
    ours, ref = tmp_path / "ours.npz", tmp_path / "ref.npz"
    prep_main([str(image_dir), str(ours), "--resize", "16", *flags])
    jax_prep_main([str(image_dir), str(ref), "--resize", "16", *flags])
    with np.load(ours) as a, np.load(ref) as b:
        assert sorted(a.files) == sorted(b.files) == ["images"]
        n = 4 if "--trunc" in flags else len(SIZES)
        assert a["images"].shape == (n, 16, 16, 3)
        assert a["images"].dtype == np.uint8
        np.testing.assert_array_equal(a["images"], b["images"])
    # the archive feeds the port's dataset as any other
    assert len(ImageBytesDataset.from_path(str(ours), crop_size=8)) == n


def test_folder_batches_match_jax(image_dir, rng):
    ours = ImageFolderDataset(str(image_dir), 16)
    ref = JaxImageFolderDataset(str(image_dir), 16)
    assert ours.image_filenames == ref.image_filenames
    assert len(ours) == len(SIZES)
    for _ in range(3):
        idx = rng.permutation(len(SIZES))[:4]
        a, b = ours.batch(idx, rng), ref.batch(idx, rng)
        assert a.shape == (4, 16, 16, 3) and a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


def test_caches_read_across_packages(image_dir, tmp_path):
    """Each package's cache loaded by the other gives the same batches,
    without reading an image (the images are removed first)."""
    ours = ImageFolderDataset(str(image_dir), 16)
    ref = JaxImageFolderDataset(str(image_dir), 16)
    idx = np.arange(len(SIZES))
    want = ours.batch(idx)
    ours.save_cache(str(tmp_path / "c" / "ours.pkl"))
    ref.batch(idx)
    ref.save_cache(str(tmp_path / "c" / "ref.pkl"))
    names = list(ours.image_filenames)
    for name in names:
        Image.new("RGB", (3, 3)).save(name)  # any read would differ
    from_ours = JaxImageFolderDataset(str(image_dir), 16)
    from_ours.load_cache(str(tmp_path / "c" / "ours.pkl"))
    from_ref = ImageFolderDataset(str(image_dir), 16)
    from_ref.load_cache(str(tmp_path / "c" / "ref.pkl"))
    np.testing.assert_array_equal(from_ours.batch(idx), want)
    np.testing.assert_array_equal(from_ref.batch(idx), want)
    with open(tmp_path / "c" / "ours.pkl", "rb") as f:
        cache = pickle.load(f)
    assert sorted(cache) == sorted(names)
    assert all(v.dtype == np.uint8 and v.shape == (16, 16, 3)
               for v in cache.values())


def _argv(data, out, *extra):
    return [str(data), "--config", "16", "--batch-size", "2", "--epochs",
            "1", "--output", str(out), "--gen-freq", "100",
            "--checkpoint-freq", "100", "--run-id", "r", "--dtype", "f32",
            "--quiet-logs", "--device", "cpu", *extra]


def test_dataset_cache_path_matches_jax(image_dir, tmp_path):
    trainer = CNNTrainer.create_from_cli(_argv(
        image_dir, tmp_path / "o", "--dataset-cache",
        str(tmp_path / "cache" / "{root}_{size}.pkl")))

    class JaxLike:
        args = trainer.args
    for size in (16, 128):
        assert trainer.dataset_cache_path(size, root=str(image_dir)) == \
            JaxTrainer.dataset_cache_path(JaxLike(), size,
                                          root=str(image_dir))


def test_trainer_trains_from_folder_and_writes_cache(image_dir, tmp_path):
    """``python -m tartangan_torch.train.cnn DIR/`` with --cache-dataset:
    6 images at B 2 are 3 steps an epoch; the cache holds every image
    after epoch 1, and a second run reads it."""
    cache = tmp_path / "cache" / "{root}_{size}.pkl"
    argv = _argv(image_dir, tmp_path / "o", "--epochs", "2",
                 "--cache-dataset", "--dataset-cache", str(cache))
    trainer = CNNTrainer.create_from_cli(argv)
    trainer.train()
    assert trainer.steps == 6
    assert all(np.isfinite(float(v)) for v in trainer.logs["g_loss"])
    path = trainer.dataset_cache_path(16)
    with open(path, "rb") as f:
        assert len(pickle.load(f)) == len(SIZES)
    again = CNNTrainer.create_from_cli(argv)
    again.build_models()
    dataset = again.prepare_dataset()
    assert sorted(dataset._image_cache) == sorted(dataset.image_filenames)


def test_device_data_with_folder_raises(image_dir, tmp_path):
    trainer = CNNTrainer.create_from_cli(_argv(image_dir, tmp_path / "o",
                                               "--device-data"))
    with pytest.raises(NotImplementedError):
        trainer.train()


def test_pillow_is_needed_only_for_folders(image_dir, tmp_path,
                                           tiny_archive, monkeypatch):
    """Without Pillow the trainer trains from an archive; a folder and the
    prep CLI raise an ImportError that names Pillow."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    trainer = CNNTrainer.create_from_cli(_argv(tiny_archive, tmp_path / "o",
                                               "--batch-size", "8"))
    trainer.train()
    assert trainer.steps == 3
    with pytest.raises(ImportError, match="Pillow"):
        CNNTrainer.create_from_cli(_argv(image_dir, tmp_path / "o")).train()
    with pytest.raises(ImportError, match="Pillow"):
        prep_main([str(image_dir), str(tmp_path / "x.npz")])


# ------------------------------------------------- the device archive
def _jax_draws(key, shape, crop, batch):
    """The JAX sampler's own indices and offsets from ``key``, split as
    ``make_device_sampler`` splits it."""
    n, h, w, _ = shape
    k_idx, k_y, k_x = jax.random.split(key, 3)
    idx = jax.random.randint(k_idx, (batch,), 0, n)
    ys = jax.random.randint(k_y, (batch,), 0, h - crop + 1)
    xs = jax.random.randint(k_x, (batch,), 0, w - crop + 1)
    return [torch.from_numpy(np.asarray(a).astype(np.int64))
            for a in (idx, ys, xs)]


@pytest.mark.parametrize("shape,crop", [((10, 12, 15, 3), 5),
                                        ((6, 8, 8, 3), 8),
                                        ((7, 9, 6, 1), 6)],
                         ids=["crop", "whole", "one_channel"])
def test_gather_crop_matches_jax_sampler(rng, shape, crop):
    images = rng.integers(0, 256, shape, dtype=np.uint8)
    sample = make_device_sampler(shape, crop, batch_size=16)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(sample(jnp.asarray(images), key))
        idx, ys, xs = _jax_draws(key, shape, crop, 16)
        got = D.gather_crop(torch.from_numpy(images), idx, ys, xs, crop)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)


def test_gather_no_crop_returns_archive_rows():
    n, h = 24, 16
    images = torch.arange(n, dtype=torch.uint8)[:, None, None, None] \
        .expand(n, h, h, 3).contiguous()
    gen = torch.Generator().manual_seed(0)
    idx, ys, xs = D.draw(n, h, h, h, 8, gen)
    batch = D.gather_crop(images, idx[0], ys[0], xs[0], h)
    assert batch.shape == (8, h, h, 3)
    for img in batch:
        assert img.min() == img.max() and 0 <= int(img[0, 0, 0]) < n


def test_gather_crop_is_contiguous_window():
    n, h, s = 4, 12, 5
    base = (torch.arange(h, dtype=torch.uint8)[:, None] * 16
            + torch.arange(h, dtype=torch.uint8)[None, :])
    images = base[None, :, :, None].expand(n, h, h, 3).contiguous()
    gen = torch.Generator().manual_seed(1)
    idx, ys, xs = D.draw(n, h, h, s, 16, gen)
    batch = D.gather_crop(images, idx[0], ys[0], xs[0], s)
    assert batch.shape == (16, s, s, 3)
    for img in batch.numpy():
        rows = img[:, 0, 0].astype(np.int32)
        cols = img[0, :, 0].astype(np.int32)
        assert np.all(np.diff(rows) == 16) and np.all(np.diff(cols) == 1)
        y0, x0 = divmod(int(img[0, 0, 0]), 16)
        assert 0 <= y0 <= h - s and 0 <= x0 <= h - s


def test_draw_covers_archive_and_stays_in_range():
    n, h, w, s = 8, 10, 7, 4
    gen = torch.Generator().manual_seed(2)
    idx, ys, xs = D.draw(n, h, w, s, 32, gen, k=8)
    assert idx.shape == ys.shape == xs.shape == (8, 32)
    assert set(idx.flatten().tolist()) == set(range(n))
    assert ys.min() >= 0 and ys.max() <= h - s
    assert xs.min() >= 0 and xs.max() <= w - s
    again = D.draw(n, h, w, s, 32, torch.Generator().manual_seed(2), k=8)
    for a, b in zip((idx, ys, xs), again):
        assert torch.equal(a, b)


def test_oversize_crop_raises():
    with pytest.raises(ValueError):
        D.crop_size_of((4, 8, 8, 3), 16)
    assert D.crop_size_of((4, 8, 9, 3), None) == 8


def test_wrapped_step_threads_batch_and_state():
    n, h, b = 6, 4, 3
    images = torch.arange(n, dtype=torch.uint8)[:, None, None, None] \
        .expand(n, h, h, 3).contiguous()
    seen = []

    def fake_step(state, batch_u8, z_d, z_g):
        assert batch_u8.shape == (b, h, h, 3)
        seen.append((z_d, z_g))
        state["n"] += 1
        return {"mean": batch_u8.float().mean()}

    step = D.wrap_step_with_device_data(fake_step, h)
    state = {"n": 0}
    idx, ys, xs = D.draw(n, h, h, h, b, torch.Generator().manual_seed(0))
    metrics = step(state, images, "zd", "zg", idx[0], ys[0], xs[0])
    assert state["n"] == 1 and seen == [("zd", "zg")]
    assert 0.0 <= float(metrics["mean"]) < n


def test_trainer_device_data_end_to_end(tiny_archive, tmp_path):
    """The epoch cadence of the host path (24 images at B 8: 3 steps an
    epoch), finite losses, and every batch gathered on the device."""
    trainer = CNNTrainer.create_from_cli(_argv(
        tiny_archive, tmp_path / "o", "--batch-size", "8", "--epochs", "2",
        "--device-data"))
    trainer.train()
    assert trainer.steps == 6
    assert trainer._archive.shape == (24, 16, 16, 3)
    for key in ("g_loss", "d_loss", "gp"):
        vals = [float(v) for v in trainer.logs[key]]
        assert len(vals) == 6 and all(np.isfinite(vals))
