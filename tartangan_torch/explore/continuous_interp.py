"""Continuous latent-space interpolation image (optionally seamless-tiled).

Counterpart of ``tartangan_tpu/explore/continuous_interp.py``: build a
slerp grid of latents, render it row by row (one ``generate`` call a grid
row), and blend per pixel so the output sweeps continuously through latent
space; ``--tile`` renders a 3x3-seamless unmirrored tiling.
"""
from __future__ import annotations

import os

import numpy as np

from ..utils.fs import maybe_makedirs
from ..utils.slerp import slerp_grid
from .base import GOutputApp


class ContinuousInterp(GOutputApp):
    app_name = "Continuous Interpolation"

    def run(self):
        self.load_generator()
        if os.path.dirname(self.args.output_prefix):
            maybe_makedirs(os.path.dirname(self.args.output_prefix))
        if self.args.tile:
            grid = self.unmirrored_tiled_grid(
                self.args.num_points, self.args.num_points)
        else:
            grid = self.sample_latent_grid(
                self.args.num_points, self.args.num_points)
        grid_h, grid_w = grid.shape[:2]
        out_size = self.args.output_size
        output = np.zeros((out_size, out_size, 3), np.float32)
        row_cache = {}
        for y in range(out_size):
            gy = int(y * grid_h / out_size)
            if gy not in row_cache:
                row_cache = {gy: np.asarray(self.generate(grid[gy]))}
            row_imgs = row_cache[gy]
            img_h, img_w = row_imgs.shape[1:3]
            iy = int(y * img_h / out_size)
            for x in range(out_size):
                gx = int(x * grid_w / out_size)
                ix = int(x * img_w / out_size)
                output[y, x] = row_imgs[gx, iy, ix]
        self.save_image(output, f"{self.args.output_prefix}_combined.png")

    def sample_latent_grid(self, nrows, ncols):
        corners = np.asarray(self.sample_z(4))
        grid = slerp_grid(*corners, nrows, ncols)
        return grid.reshape(nrows, ncols, -1).astype(np.float32)

    def unmirrored_tiled_grid(self, nrows, ncols):
        """3x3 block of slerp grids sharing wrapped corners so the full
        image tiles seamlessly (continuous_interp.py:66-88)."""
        nrows //= 3
        ncols //= 3
        zs = np.asarray(self.sample_z(9))
        a, b, c, d, e, f, g, h, i = zs
        corners = (
            (a, b, c, a),
            (d, e, f, d),
            (g, h, i, g),
            (a, b, c, a),
        )
        latent = zs.shape[-1]
        all_zs = np.zeros(((nrows - 1) * 3, (ncols - 1) * 3, latent),
                          np.float32)
        off_r = 0
        for row in range(3):
            off_c = 0
            for col in range(3):
                tl, tr = corners[row][col:col + 2]
                bl = corners[row + 1][col]
                br = corners[row + 1][col + 1]
                grid = slerp_grid(tl, tr, bl, br, nrows, ncols)
                grid = grid.reshape(nrows, ncols, -1)[:nrows - 1, :ncols - 1]
                all_zs[off_r:off_r + nrows - 1,
                       off_c:off_c + ncols - 1] = grid
                off_c += ncols - 1
            off_r += nrows - 1
        return all_zs

    @classmethod
    def add_args_to_parser(cls, p):
        super().add_args_to_parser(p)
        p.add_argument("--output-size", default=256, type=int)
        p.add_argument("--num-points", type=int, default=6,
                       help="Latent grid resolution")
        p.add_argument("--tile", action="store_true")


if __name__ == "__main__":
    ContinuousInterp.run_from_cli()
