"""Render a slerp circuit of generator samples.

Counterpart of ``tartangan_tpu/explore/render_tour.py``: visit
``--num-points`` random latents, slerp ``--seg-frames`` frames per segment,
render them as one batch (one ``generate`` call) and write one PNG per
frame.
"""
from __future__ import annotations

import os

import numpy as np

from ..utils.fs import maybe_makedirs
from ..utils.slerp import slerp
from .base import GOutputApp


class RenderTour(GOutputApp):
    app_name = "Render tour"

    def run(self):
        self.load_generator()
        points = np.asarray(self.sample_z(self.args.num_points))
        path = []
        nxt = np.concatenate([points[1:], points[:1]], axis=0)
        for p_a, p_b in zip(points, nxt):
            for t in np.linspace(0, 1, self.args.seg_frames + 1)[:-1]:
                path.append(slerp(t, p_a, p_b))
        zs = np.stack(path).astype(np.float32)
        imgs = np.asarray(self.generate(zs))
        if os.path.dirname(self.args.output_prefix):
            maybe_makedirs(os.path.dirname(self.args.output_prefix))
        for i, img in enumerate(imgs):
            self.save_image(img, f"{self.args.output_prefix}_{i}.png")

    @classmethod
    def add_args_to_parser(cls, p):
        super().add_args_to_parser(p)
        p.add_argument("--num-points", type=int, default=2,
                       help="Number of points to visit")
        p.add_argument("--seg-frames", type=int, default=3,
                       help="Frames per segment")


if __name__ == "__main__":
    RenderTour.run_from_cli()
