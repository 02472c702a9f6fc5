"""InfoGAN sample sweeps: continuous-code sweeps and categorical one-hots.

Counterpart of ``tartangan_tpu/train/components/info_image_sampler.py``,
a component beside the image sampler: at its cadence one grid sweeps each of the first (up
to 4) continuous codes from -2 to 2 over 7 points, with a row sweeping the
last, uncontrolled dimension for contrast (``info_cont_{name}``), and one
grid renders each categorical one-hot for 3 base latents
(``info_cat_{name}``), from the EMA target generator.
"""
from __future__ import annotations

import os

import numpy as np

from ...utils.imaging import save_image
from .image_sampler import ImageSamplerComponent


class InfoImageSamplerComponent(ImageSamplerComponent):
    def on_train_begin(self, steps, logs):
        super().on_train_begin(steps, logs)
        args = self.trainer.args
        num_cont_dims = min(4, args.info_cont_dims)
        num_points = 7
        base_z = self.trainer.sample_z(1).cpu().numpy()[0]

        pts = np.linspace(-2, 2, num_points, dtype=np.float32)
        rows = []
        for i in range(num_cont_dims):
            sweep = np.tile(base_z, (num_points, 1))
            sweep[:, args.info_cat_dims + i] = pts
            rows.append(sweep)
        sweep = np.tile(base_z, (num_points, 1))
        sweep[:, -1] = pts
        rows.append(sweep)
        self.continuous_samples = np.stack(rows)  # (rows, 7, latent)

        self.categorical_samples = None
        if args.info_cat_dims:
            extra = self.trainer.sample_z(2).cpu().numpy()
            eye = np.eye(args.info_cat_dims, dtype=np.float32)
            cats = []
            for b in np.concatenate([base_z[None], extra], axis=0):
                block = np.tile(b, (args.info_cat_dims, 1))
                block[:, :args.info_cat_dims] = eye
                cats.append(block)
            self.categorical_samples = np.stack(cats)

    def output_samples(self, filename):
        # the image sampler's own panels come from its own component
        for name, samples in (("cat", self.categorical_samples),
                              ("cont", self.continuous_samples)):
            if samples is None:
                continue
            imgs = self.trainer.sample_g(
                z=samples.reshape(-1, samples.shape[-1]), target_g=True)
            if not self.writer:
                continue
            save_image(imgs, os.path.join(
                os.path.dirname(filename),
                f"info_{name}_{os.path.basename(filename)}"),
                nrow=samples.shape[1])
