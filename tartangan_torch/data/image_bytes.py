"""Pre-resized uint8 image archive dataset.

Counterpart of ``tartangan_tpu/data/image_bytes.py:26-80``: an ``.npz``
with an ``images`` array of shape (N, H, W, C) uint8 (or an ``.npy``) lives
in host memory, and each batch is a random crop in numpy, drawn from the
caller's ``np.random.Generator`` in the same order as there, so a seed
gives the JAX trainer's batches. Batches stay uint8 until the train step
normalizes them on the device. The offline prep CLI (which resizes with
PIL) and the native crop library are not ported.
"""
from __future__ import annotations

import numpy as np

from ..utils.fs import smart_open


class ImageBytesDataset:
    """In-RAM uint8 archive; yields random-cropped uint8 NHWC batches."""

    def __init__(self, images: np.ndarray, crop_size: int | None = None):
        if images.dtype != np.uint8 or images.ndim != 4:
            raise ValueError("ImageBytesDataset takes (N, H, W, C) uint8, "
                             f"got {images.shape} {images.dtype}")
        self.images = images
        self.crop_size = crop_size

    def __len__(self):
        return self.images.shape[0]

    @property
    def image_size(self):
        return self.crop_size or self.images.shape[1]

    def batch(self, indices: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        """Gather + random-crop a batch (uint8 NHWC)."""
        _, h, w, _ = self.images.shape
        size = self.crop_size
        if size is None or (h == size and w == size):
            return self.images[indices]
        n = len(indices)
        ys = rng.integers(0, h - size + 1, size=n)
        xs = rng.integers(0, w - size + 1, size=n)
        out = np.empty((n, size, size, self.images.shape[3]), dtype=np.uint8)
        for i, idx in enumerate(indices):
            out[i] = self.images[idx, ys[i]:ys[i] + size, xs[i]:xs[i] + size]
        return out

    @classmethod
    def from_path(cls, path, crop_size: int | None = None):
        """Load an ``.npz``/``.npy`` archive."""
        with smart_open(path, "rb") as infile:
            images = np.load(infile)
            if isinstance(images, np.lib.npyio.NpzFile):
                images = images["images"]
            images = np.asarray(images)
        if images.ndim == 4 and images.shape[1] in (1, 3) \
                and images.shape[-1] not in (1, 3):
            # tolerate NCHW archives
            images = images.transpose(0, 2, 3, 1)
        return cls(np.ascontiguousarray(images, dtype=np.uint8),
                   crop_size=crop_size)
