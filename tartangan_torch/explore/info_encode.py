"""Encode images to latent codes with an InfoGAN discriminator head.

Counterpart of ``tartangan_tpu/explore/info_encode.py``: images go through
the two-headed discriminator in batches of ``--batch-size``, and the code
head's outputs are pickled as ``{"id": [...], "features": [...]}`` keyed by
file name; ``--recon`` also renders G(codes), the codes padded with zeros
to ``latent_dims``.

``run`` reads the files with Pillow (imported there); ``encode_batch``
takes a batch as an array.
"""
from __future__ import annotations

import glob
import os
import pickle

import numpy as np

from ..utils.fs import maybe_makedirs
from .base import GOutputApp


class InfoGANEncodeImage(GOutputApp):
    app_name = "InfoGAN image encoder"

    def run(self):
        from PIL import Image
        self.load_generator(target=False)
        self.load_discriminator(info=True)
        img_size = self.gan_config.max_size
        if os.path.dirname(self.args.output_prefix):
            maybe_makedirs(os.path.dirname(self.args.output_prefix))

        ids, codes = [], []
        batch_imgs, batch_names = [], []

        def flush(batch_i):
            if not batch_imgs:
                return
            codes.append(self.encode_batch(np.stack(batch_imgs), batch_i))
            ids.extend(os.path.splitext(n)[0] for n in batch_names)
            batch_imgs.clear()
            batch_names.clear()

        batch_i = 0
        for filename in self.gen_filenames():
            try:
                img = Image.open(filename).convert("RGB")
            except OSError:
                print(f"Error opening {filename}")
                continue
            img = img.resize((img_size, img_size), Image.LANCZOS)
            batch_imgs.append(
                np.asarray(img, np.float32) / 127.5 - 1.0)
            batch_names.append(os.path.basename(filename))
            if len(batch_imgs) == self.args.batch_size:
                flush(batch_i)
                batch_i += 1
        flush(batch_i)

        codes = np.concatenate(codes, axis=0) if codes else np.zeros((0,))
        out = {"id": ids, "features": [codes[i] for i in range(len(ids))]}
        with open(f"{self.args.output_prefix}_codes.pkl", "wb") as f:
            pickle.dump(out, f)
        print(f"encoded {len(ids)} images")

    def encode_batch(self, imgs: np.ndarray, batch_i: int = 0) -> np.ndarray:
        """(B, H, W, C) images in [-1, 1] -> the code head's (B, codes)
        float32; with ``--recon`` also writes G(codes) as
        ``{output_prefix}_{batch_i}.png``."""
        _, p_code = self.discriminate(imgs)
        p_code = np.asarray(p_code, np.float32)
        if self.args.recon:
            latent = self.gan_config.latent_dims
            pad = latent - p_code.shape[-1]
            z = np.pad(p_code, ((0, 0), (0, max(pad, 0))))[:, :latent]
            recon = self.generate(z)
            self.save_image(recon, f"{self.args.output_prefix}_{batch_i}.png")
        return p_code

    def gen_filenames(self):
        for name in self.args.target_images:
            if os.path.isfile(name):
                yield name
            else:
                yield from glob.iglob(name)

    @classmethod
    def add_args_to_parser(cls, p):
        super().add_args_to_parser(p)
        p.add_argument("target_images", nargs="+",
                       help="Filenames/globs of images to encode")
        p.add_argument("--recon", action="store_true",
                       help="Render G(codes) reconstructions")
        p.add_argument("--batch-size", default=32, type=int)


if __name__ == "__main__":
    InfoGANEncodeImage.run_from_cli()
