"""Lazy-resize image-folder dataset with a pickled RAM cache.

Counterpart of ``tartangan_tpu/data/image_folder.py:19-56``: a directory
as ``data_path``. Each image is LANCZOS-resized to the model's size at its
first use, with no crop, and kept as a uint8 HWC array; batches stay uint8
until the train step normalizes them on the device. The cache is a pickle
of ``{filename: uint8 HWC array}``, the JAX package's format, so either
package reads the other's (``--cache-dataset``, ``--dataset-cache``).
Needs Pillow.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from ..utils.fs import list_files_recursive, maybe_makedirs
from .image_bytes import IMG_EXTENSIONS, pil_image


class ImageFolderDataset:
    def __init__(self, root, image_size: int):
        pil_image()  # fail here, not at the first batch, without Pillow
        self.root = root
        self.image_size = image_size
        self.image_filenames = list_files_recursive(root, IMG_EXTENSIONS)
        self._image_cache: dict[str, np.ndarray] = {}

    def __len__(self):
        return len(self.image_filenames)

    def _load(self, filename) -> np.ndarray:
        cached = self._image_cache.get(filename)
        if cached is None:
            Image = pil_image()
            img = Image.open(filename).convert("RGB")
            img = img.resize((self.image_size, self.image_size),
                             Image.LANCZOS)
            cached = np.asarray(img, dtype=np.uint8)
            self._image_cache[filename] = cached
        return cached

    def batch(self, indices: np.ndarray, rng=None) -> np.ndarray:
        """uint8 NHWC; ``rng`` is not used (no crop on this path)."""
        return np.stack([self._load(self.image_filenames[i])
                         for i in indices])

    def load_cache(self, filename):
        """Read a cache this program (or the JAX package) wrote, if the
        file exists."""
        if os.path.exists(filename):
            with open(filename, "rb") as infile:
                self._image_cache = pickle.load(infile)

    def save_cache(self, filename):
        if os.path.dirname(filename):
            maybe_makedirs(os.path.dirname(filename), exist_ok=True)
        with open(filename, "wb") as outfile:
            pickle.dump(self._image_cache, outfile)
