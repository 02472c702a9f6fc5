"""Pre-resized uint8 image archive dataset and its offline prep CLI.

Counterpart of ``tartangan_tpu/data/image_bytes.py``: an ``.npz`` with an
``images`` array of shape (N, H, W, C) uint8 (or an ``.npy``) lives in host
memory, and each batch is a random crop in numpy, drawn from the caller's
``np.random.Generator`` in the same order as there, so a seed gives the JAX
trainer's batches. The gather and the crops run in the port's C++ batcher
(``native/``, built with ``g++`` at first use; a failed build raises), as
the JAX package's loader does. Batches stay uint8 until the train step
normalizes them on the device.

The prep CLI LANCZOS-resizes a folder of images into such an archive, the
same arrays as the JAX package's CLI writes; it needs Pillow, which only
the prep CLI and the folder dataset (``data/image_folder.py``) import:

    python -m tartangan_torch.data.image_bytes SRC DST.npz --resize 128 \
        [--square] [--trunc N]
"""
from __future__ import annotations

import numpy as np

from .. import native
from ..utils.fs import list_files_recursive, smart_open

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm",
                  ".tif", ".tiff", ".webp")


def pil_image():
    """PIL's ``Image`` module, imported at first use: training from an
    archive does not need Pillow."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("the folder dataset and the prep CLI need Pillow "
                          "(the PIL package), which is not installed") from e
    return Image


class ImageBytesDataset:
    """In-RAM uint8 archive; yields random-cropped uint8 NHWC batches."""

    def __init__(self, images: np.ndarray, crop_size: int | None = None):
        if images.dtype != np.uint8 or images.ndim != 4:
            raise ValueError("ImageBytesDataset takes (N, H, W, C) uint8, "
                             f"got {images.shape} {images.dtype}")
        self.images = np.ascontiguousarray(images)
        self.crop_size = crop_size

    def __len__(self):
        return self.images.shape[0]

    @property
    def image_size(self):
        return self.crop_size or self.images.shape[1]

    def batch(self, indices: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        """Gather + random-crop a batch (uint8 NHWC) in the native batcher;
        the offsets are drawn from ``rng`` as the JAX package draws them."""
        _, h, w, _ = self.images.shape
        size = self.crop_size
        if size is None or (h == size and w == size):
            return native.gather_batch(self.images, indices)
        n = len(indices)
        ys = rng.integers(0, h - size + 1, size=n)
        xs = rng.integers(0, w - size + 1, size=n)
        return native.crop_batch(self.images, indices, ys, xs, size)

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

    @classmethod
    def prepare_data_from_path(cls, path, resize: int = 64,
                               square: bool = False,
                               trunc: int | None = None) -> np.ndarray:
        """Walk a folder, LANCZOS-resize each image, stack to uint8."""
        Image = pil_image()
        filenames = list_files_recursive(path, IMG_EXTENSIONS)
        if trunc is not None:
            filenames = filenames[:trunc]
        images = []
        for filename in filenames:
            img = Image.open(filename).convert("RGB")
            img = _resize_lanczos(img, resize, square)
            images.append(np.asarray(img, dtype=np.uint8)[None])
        return np.vstack(images)


def _resize_lanczos(img, size: int, square: bool):
    """``size`` x ``size``: a plain resize with ``square``, else the short
    side to ``size`` (aspect kept) and a center crop."""
    Image = pil_image()
    if square:
        return img.resize((size, size), Image.LANCZOS)
    w, h = img.size
    if w < h:
        nw, nh = size, max(round(h * size / w), size)
    else:
        nw, nh = max(round(w * size / h), size), size
    img = img.resize((nw, nh), Image.LANCZOS)
    left = (nw - size) // 2
    top = (nh - size) // 2
    return img.crop((left, top, left + size, top + size))


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Create image data from a folder.")
    p.add_argument("source", help="Root path of images")
    p.add_argument("destination", help="Output location of dataset")
    p.add_argument("--resize", type=int, default=64,
                   help="Width/height of saved images")
    p.add_argument("--trunc", type=int, default=None,
                   help="Take only first N samples")
    p.add_argument("--square", action="store_true",
                   help="Don't preserve aspect ratio")
    args = p.parse_args(argv)

    print(f'preparing data from "{args.source}"')
    data = ImageBytesDataset.prepare_data_from_path(
        args.source, resize=args.resize, square=args.square, trunc=args.trunc)
    print(f'saving dataset to "{args.destination}"')
    with smart_open(args.destination, "wb") as outfile:
        np.savez_compressed(outfile, images=data)


if __name__ == "__main__":
    main()
