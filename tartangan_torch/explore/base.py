"""Base app for post-training generator exploration.

Counterpart of ``tartangan_tpu/explore/base.py``. The app rebuilds the
architecture from the run's ``config.args`` replay file and loads the flax
msgpack checkpoint that the JAX trainer wrote
(``checkpoints/<step>/g.msgpack``, ``g_target.msgpack`` for the EMA weights
and ``d.msgpack``) through ``utils/msgpack.py`` and ``convert.from_flax``.

``checkpoint_root`` may be the step directory itself
(``.../run_id/checkpoints/1234``) or a run directory (latest step used).

Every app runs on ``--device`` (default ``cuda``), and raises if CUDA is
asked for and missing.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..configs import GAN_CONFIGS
from ..convert import from_flax
from ..models import factories as F
from ..models.pluggan import Discriminator, Generator
from ..utils import msgpack
from ..utils.app import App
from ..utils.fs import smart_ls, smart_open
from ..utils.imaging import save_image
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
    p.add_argument("--info-cat-dims", type=int, default=10)
    p.add_argument("--info-cont-dims", type=int, default=5)
    with smart_open(config_args_path, "r") as f:
        argv = [line.strip() for line in f if line.strip()]
    args, _ = p.parse_known_args(argv)
    return args


def _read_msgpack(path):
    with smart_open(path, "rb") as f:
        return msgpack.loads(f.read())


def add_device_arg(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to run the models on")


def _to_numpy(out):
    if isinstance(out, (list, tuple)):
        return [_to_numpy(o) for o in out]
    return out.float().cpu().numpy()


class GOutputApp(App):
    """Loads generator/discriminator checkpoints for exploration apps."""

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

    def resolve_device(self) -> torch.device:
        device = torch.device(self.args.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("--device cuda but no CUDA device is "
                               "available; pass --device cpu to run on the "
                               "CPU")
        self.device = device
        full_float32()
        return device

    def build_generator(self):
        rc = self.run_config
        return Generator(
            self.gan_config,
            input_factory=F.g_input_factory(rc.g_base, rc.activation),
            block_factory=F.g_block_factory(rc.norm, rc.activation),
            output_factory=F.g_output_factory(rc.norm, rc.activation),
        )

    def build_discriminator(self, info: bool = False):
        rc = self.run_config
        if info:
            output_factory = F.info_d_output_factory(
                rc.norm, rc.activation,
                rc.info_cat_dims + rc.info_cont_dims)
        else:
            output_factory = F.d_output_factory(rc.norm, rc.activation)
        return Discriminator(
            self.gan_config,
            input_factory=F.d_input_factory(),
            block_factory=F.d_block_factory(rc.norm, rc.activation),
            output_factory=output_factory,
        )

    def load_generator(self, target: bool = True):
        self.load_run_config()
        ckpt = self.resolve_checkpoint_dir()
        device = self.resolve_device()
        g = self.build_generator()
        variables = _read_msgpack(os.path.join(ckpt, "g.msgpack"))
        if target:
            # target checkpoints store only params; reuse g's batch stats
            tvars = _read_msgpack(os.path.join(ckpt, "g_target.msgpack"))
            variables = {**variables, "params": tvars["params"]}
        g.load_state_dict(from_flax(variables))
        self.g = g.to(device)
        return self.g

    def load_discriminator(self, info: bool = False):
        if not hasattr(self, "run_config"):
            self.load_run_config()
        ckpt = self.resolve_checkpoint_dir()
        device = self.resolve_device()
        d = self.build_discriminator(info=info)
        d.load_state_dict(from_flax(
            _read_msgpack(os.path.join(ckpt, "d.msgpack"))))
        self.d = d.to(device)
        return self.d

    def generate(self, z: np.ndarray) -> np.ndarray:
        """(B, latent) float32 latents -> (B, H, W, C) float32 images in
        [-1, 1], with train-mode (batch-statistics) BatchNorm as the JAX
        app runs it: an image depends on the rest of its batch."""
        with torch.inference_mode():
            zt = torch.as_tensor(np.asarray(z, np.float32), device=self.device)
            out = self.g(zt, train=True)
            return out.permute(0, 2, 3, 1).float().cpu().numpy()

    def discriminate(self, x: np.ndarray):
        """(B, H, W, C) float32 images -> D's output as numpy (a list of the
        heads' outputs for the InfoGAN D), with train-mode BatchNorm that
        leaves the running statistics alone, as ``generate`` runs G."""
        with torch.inference_mode():
            xt = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
            return _to_numpy(self.d(xt.permute(0, 3, 1, 2), train=True))

    def sample_z(self, n, rng=None):
        """Normal or truncated-normal latents, (n, latent) float32."""
        rng = rng or np.random.default_rng()
        dims = self.gan_config.latent_dims
        if self.args.trunc_norm is not None:
            from scipy.stats import truncnorm
            z = truncnorm.rvs(-self.args.trunc_norm, self.args.trunc_norm,
                              size=n * dims, random_state=rng)
            return z.reshape(n, dims).astype(np.float32)
        return rng.standard_normal((n, dims)).astype(np.float32)

    def save_image(self, img, filename, value_range=(-1, 1)):
        save_image(np.asarray(img, np.float32), filename,
                   value_range=value_range)

    @classmethod
    def add_args_to_parser(cls, p):
        super().add_args_to_parser(p)
        p.add_argument("checkpoint_root",
                       help="Path to a checkpoint step dir or run dir.")
        p.add_argument("output_prefix", help="Prefix for output files.")
        p.add_argument("--trunc-norm", type=float, default=None,
                       help="Sample from truncated normal distribution")
        add_device_arg(p)
