"""Periodic sample rendering: fixed-z panels + slerp interpolation grid.

Counterpart of ``tartangan_tpu/train/components/image_sampler.py:20-59``:
at train begin fix a 32-z panel; every ``--gen-freq`` steps render 16
target-G + 16 G samples to ``samples/sample_{steps}.png`` and a 5x5 slerp
grid to ``grid_sample_{steps}.png``, with the port's zlib PNG writer.
Sampling leaves the BatchNorm running statistics as they are.
"""
from __future__ import annotations

import os

import numpy as np

from ...utils.fs import maybe_makedirs
from ...utils.imaging import save_image
from ...utils.slerp import slerp_grid
from .base import TrainerComponent


class ImageSamplerComponent(TrainerComponent):
    def on_train_begin(self, steps, logs):
        if self.writer:
            maybe_makedirs(self.sample_root, exist_ok=True)
        self.progress_samples = self.trainer.sample_z(32)

    def on_train_end(self, steps, logs):
        self.output_samples(f"{self.sample_root}/sample_{steps}.png")

    def on_batch_end(self, steps, logs):
        if self.every(self.trainer.args.gen_freq, steps):
            self.output_samples(f"{self.sample_root}/sample_{steps}.png")

    def output_samples(self, filename):
        trainer = self.trainer
        imgs = np.concatenate([
            trainer.sample_g(z=self.progress_samples, target_g=True)[:16],
            trainer.sample_g(z=self.progress_samples)[:16],
        ], axis=0)
        if self.writer:
            save_image(imgs, filename, nrow=8)

        if not hasattr(self, "_latent_grid_samples"):
            self._latent_grid_samples = self.sample_latent_grid(5, 5)
        grid_imgs = trainer.sample_g(z=self._latent_grid_samples,
                                     target_g=True)
        grid_filename = os.path.join(
            os.path.dirname(filename), f"grid_{os.path.basename(filename)}"
        )
        if self.writer:
            save_image(grid_imgs, grid_filename, nrow=5)

    def sample_latent_grid(self, nrows, ncols):
        corners = self.trainer.sample_z(4).cpu().numpy()
        return slerp_grid(*corners, nrows, ncols)

    @property
    def sample_root(self):
        return f"{self.trainer.output_root}/samples"
