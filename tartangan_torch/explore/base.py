"""Base app for post-training generator exploration.

Counterpart of ``tartangan_tpu/explore/base.py:30-177`` (generator side).
The app rebuilds the architecture from the run's ``config.args`` replay file
and loads the flax msgpack checkpoint that the JAX trainer wrote
(``checkpoints/<step>/g.msgpack``, and ``g_target.msgpack`` for the EMA
weights) through ``utils/msgpack.py`` and ``convert.from_flax``.

``checkpoint_root`` may be the step directory itself
(``.../run_id/checkpoints/1234``) or a run directory (latest step used).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..configs import GAN_CONFIGS
from ..convert import from_flax
from ..models import factories as F
from ..models.pluggan import Generator
from ..utils import msgpack
from ..utils.app import App
from ..utils.fs import smart_ls, smart_open
from ..utils.precision import full_float32


def parse_run_config(config_args_path):
    """Parse the model-defining flags out of a run's config.args file."""
    p = argparse.ArgumentParser()
    p.add_argument("data_path", nargs="?")
    p.add_argument("--config", default="64")
    p.add_argument("--model-scale", type=float, default=1.0)
    p.add_argument("--g-base", default="mlp")
    p.add_argument("--norm", default="bn")
    p.add_argument("--activation", default="relu")
    with smart_open(config_args_path, "r") as f:
        argv = [line.strip() for line in f if line.strip()]
    args, _ = p.parse_known_args(argv)
    return args


def _read_msgpack(path):
    with smart_open(path, "rb") as f:
        return msgpack.loads(f.read())


class GOutputApp(App):
    """Loads a generator checkpoint for exploration apps."""

    def resolve_checkpoint_dir(self):
        root = self.args.checkpoint_root
        if os.path.exists(os.path.join(root, "g.msgpack")):
            return root
        # run directory: pick the latest step under checkpoints/
        ckpts = os.path.join(root, "checkpoints")
        steps = [int(s) for s in smart_ls(ckpts) if s.isdigit()]
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {root}")
        return os.path.join(ckpts, str(max(steps)))

    def run_root(self):
        """The run directory containing config.args."""
        ckpt_dir = self.resolve_checkpoint_dir()
        run_root = os.path.dirname(os.path.dirname(ckpt_dir))
        return run_root if run_root else "."

    def load_run_config(self):
        self.run_config = parse_run_config(
            os.path.join(self.run_root(), "config.args"))
        self.gan_config = GAN_CONFIGS[self.run_config.config].scale_model(
            self.run_config.model_scale)
        return self.run_config

    def build_generator(self):
        rc = self.run_config
        return Generator(
            self.gan_config,
            input_factory=F.g_input_factory(rc.g_base, rc.activation),
            block_factory=F.g_block_factory(rc.norm, rc.activation),
            output_factory=F.g_output_factory(rc.norm, rc.activation),
        )

    def load_generator(self, target: bool = True):
        self.load_run_config()
        ckpt = self.resolve_checkpoint_dir()
        self.device = torch.device(self.args.device)
        full_float32()
        g = self.build_generator()
        variables = _read_msgpack(os.path.join(ckpt, "g.msgpack"))
        if target:
            # target checkpoints store only params; reuse g's batch stats
            tvars = _read_msgpack(os.path.join(ckpt, "g_target.msgpack"))
            variables = {**variables, "params": tvars["params"]}
        g.load_state_dict(from_flax(variables))
        self.g = g.to(self.device)
        return self.g

    def generate(self, z: np.ndarray) -> np.ndarray:
        """(B, latent) float32 latents -> (B, H, W, C) float32 images in
        [-1, 1], with train-mode (batch-statistics) BatchNorm as the JAX
        app runs it: an image depends on the rest of its batch."""
        with torch.inference_mode():
            zt = torch.as_tensor(np.asarray(z, np.float32), device=self.device)
            out = self.g(zt, train=True)
            return out.permute(0, 2, 3, 1).float().cpu().numpy()
