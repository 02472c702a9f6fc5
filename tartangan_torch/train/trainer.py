"""Trainer core: the host loop around the train step.

Counterpart of ``tartangan_tpu/train/trainer.py:48-599``: the two-pass CLI
with ``@argfile`` and the same flags and defaults (plus ``--device``), the
run id and ``config.args``, the epoch loop with component hooks and a
SIGTERM-safe shutdown, the logs dict, and the checkpoint artifacts in the
JAX trainer's layout (``g``, ``g_target``, ``d``, ``opt_g``, ``opt_d``).

Batches are uint8 crops made on the host (``data/``), copied to the device
one batch ahead from pinned memory, and normalized there by the step.
Latents come from the trainer's own ``torch.Generator``, seeded by
``--seed``, on the training device.

Flags whose feature is not ported yet raise ``NotImplementedError`` when
set away from their default (``_UNPORTED``); none is ignored.
"""
from __future__ import annotations

import argparse
import os
import random
import signal
import string
from collections import defaultdict
from datetime import datetime

import torch

from ..convert import adam_from_flax, adam_to_flax, from_flax, to_flax
from ..data.image_bytes import ImageBytesDataset
from ..data.prefetch import EpochBatcher, prefetch_to_device
from ..utils.cli import save_cli_arguments, type_or_none
from ..utils.fs import is_s3_path, maybe_makedirs
from ..utils.precision import full_float32, resolve_dtype
from .components.container import ComponentContainer
from .progress import ProgressLine

# flag -> (is it set away from its default?, what is missing)
_UNPORTED = {
    "device_data": (lambda a: a.device_data,
                    "the device-resident archive"),
    "steps_per_call": (lambda a: a.steps_per_call > 1,
                       "multi-step calls"),
    "num_devices": (lambda a: a.num_devices not in (None, 1),
                    "data parallelism over several devices"),
    "tp": (lambda a: a.tp > 1, "tensor parallelism"),
    "remat": (lambda a: a.remat, "rematerialization"),
    "fid": (lambda a: a.fid, "the FID component"),
    "metrics_collector": (lambda a: a.metrics_collector is not None,
                          "the metrics collectors"),
    "profile_dir": (lambda a: a.profile_dir is not None,
                    "the profiler component"),
    "timing": (lambda a: a.timing, "the profiler component"),
    "checkpoint_format": (lambda a: getattr(a, "checkpoint_format",
                                            "msgpack") != "msgpack",
                          "orbax checkpoints"),
    "activation": (lambda a: a.activation == "selu",
                   "the SELU re-initialization"),
}


def check_unported(args) -> None:
    """Raise ``NotImplementedError`` for any flag of a feature that is
    not ported yet."""
    for flag, (is_set, what) in _UNPORTED.items():
        if is_set(args):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} {getattr(args, flag)}: {what} "
                "is not ported yet")


class Trainer:
    """Base trainer. Subclasses implement ``build_models`` (the modules,
    the optimizers, ``self.state`` and ``self._train_step``)."""

    def __init__(self, args, components):
        self.args = args
        check_unported(args)
        if (getattr(args, "data_path", None)
                and not is_s3_path(args.data_path)):
            if not os.path.exists(args.data_path):
                raise FileNotFoundError(
                    f"data_path does not exist: {args.data_path}")
            if os.path.isdir(args.data_path):
                raise NotImplementedError(
                    "a directory as data_path: the folder dataset is not "
                    "ported yet; pass an .npz/.npy uint8 archive")
        self.device = torch.device(args.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("--device cuda but no CUDA device is "
                               "available; pass --device cpu to train on "
                               "the CPU")
        # the compute dtype; parameters, BatchNorm statistics, Adam's state
        # and the EMA target stay float32 (flax's dtype / param_dtype)
        self.dtype = resolve_dtype(args.dtype)
        full_float32()

        self.run_id = args.run_id if args.run_id is not None \
            else self._generate_run_id()
        maybe_makedirs(self.output_root, exist_ok=True)
        self._save_cli_arguments()

        self.components = ComponentContainer()
        self.components.trainer = self
        self.components.add_components(*components)

        self.steps = 0
        self.epoch = 1
        self.z_gen = torch.Generator(device=self.device).manual_seed(args.seed)

    # ----------------------------------------------------------------- hooks
    def build_models(self):
        raise NotImplementedError

    def prepare_dataset(self):
        return ImageBytesDataset.from_path(self.args.data_path,
                                           crop_size=self.g.max_size)

    # ------------------------------------------------------------ train loop
    def train(self):
        self.build_models()
        print(f"Preparing dataset from {self.args.data_path}")
        self.dataset = self.prepare_dataset()
        batcher = EpochBatcher(self.dataset, self.args.batch_size,
                               seed=self.args.seed)
        logs = defaultdict(list)
        self.logs = logs

        # SIGTERM triggers the same graceful shutdown as Ctrl-C: final
        # checkpoint, samples
        def _on_sigterm(signum, frame):
            raise KeyboardInterrupt

        try:
            prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:  # not on the main thread
            prev_handler = None
        progress = ProgressLine(newlines=self.args.log_progress_newlines)
        num_batches = len(batcher)
        if num_batches == 0:
            raise ValueError(
                f"dataset of {len(self.dataset)} images yields no batch of "
                f"size {self.args.batch_size}")
        try:
            self.components.invoke("train_begin", self.steps, logs)
            while self.epoch <= self.args.epochs:
                if not self.args.quiet_logs:
                    print(f"Starting epoch {self.epoch}")
                self.components.invoke(
                    "epoch_begin", self.steps, self.epoch, logs)
                progress.epoch_begin(self.epoch, num_batches)
                epoch_batches = 0
                for batch in prefetch_to_device(batcher.epoch(), self.device):
                    self.components.invoke("batch_begin", self.steps, logs)
                    training_metrics = self.train_batch(batch)
                    for name, value in training_metrics.items():
                        logs[name].append(value)
                    self.components.invoke("batch_end", self.steps, logs)
                    epoch_batches += 1
                    if (not self.args.quiet_logs
                            and self.steps % self.args.log_iters == 0):
                        progress.update(self.steps, epoch_batches,
                                        self.args.batch_size,
                                        training_metrics)
                    self.steps += 1
                progress.epoch_end()
                self.components.invoke(
                    "epoch_end", self.steps, self.epoch, logs)
                self.epoch += 1
        except KeyboardInterrupt:
            pass
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)
        self.components.invoke("train_end", self.steps, logs)

    def train_batch(self, batch):
        """One train step on a uint8 device batch; lazy R1 alternates the
        two steps on the global step count, as the JAX trainer does.
        Returns 0-d device tensors, with no host sync here."""
        lazy_off = (self._r1_interval > 1
                    and self.steps % self._r1_interval != 0)
        fn = self._train_step_alt if lazy_off else self._train_step
        n = batch.shape[0]
        z_d = torch.stack([self.sample_z(n) for _ in range(self.args.iters_d)])
        z_g = self.sample_z(n)
        return fn(self.state, batch, z_d, z_g)

    # ------------------------------------------------------------- sampling
    def sample_z(self, n=None):
        if n is None:
            n = self.args.batch_size
        return torch.randn((n, self.gan_config.latent_dims),
                           generator=self.z_gen, device=self.device)

    def sample_g(self, n=None, target_g=False, z=None):
        """Images (NHWC float32 numpy in [-1, 1]) from random or given z,
        with train-mode BatchNorm that leaves the running statistics as
        they are (the JAX sampler discards its batch-stat update)."""
        if z is None:
            z = self.sample_z(n)
        z = torch.as_tensor(z, device=self.device)
        g = self.state.g_target if target_g else self.state.g
        with torch.no_grad():
            out = g(z, train=True)
        return out.permute(0, 2, 3, 1).float().cpu().numpy()

    # --------------------------------------------------------------- state
    def get_state(self):
        return dict(epoch=self.epoch, steps=self.steps)

    def set_state(self, state):
        for key, value in state.items():
            setattr(self, key, value)

    def checkpoint_artifacts(self):
        """name -> flax tree of numpy arrays, in the JAX trainer's layout."""
        s = self.state
        return {
            "g": to_flax(s.g),
            "g_target": {"params": to_flax(s.g_target)["params"]},
            "d": to_flax(s.d),
            "opt_g": adam_to_flax(s.g, s.opt_g),
            "opt_d": adam_to_flax(s.d, s.opt_d),
        }

    def load_checkpoint_artifacts(self, artifacts):
        s = self.state
        s.g.load_state_dict(from_flax(artifacts["g"]))
        s.d.load_state_dict(from_flax(artifacts["d"]))
        target = from_flax({"params": artifacts["g_target"]["params"]})
        missing, unexpected = s.g_target.load_state_dict(target, strict=False)
        params = {name for name, _ in s.g_target.named_parameters()}
        if unexpected or params & set(missing):
            raise KeyError(f"g_target checkpoint does not fit: missing "
                           f"{sorted(params & set(missing))}, unexpected "
                           f"{unexpected}")
        adam_from_flax(s.g, s.opt_g, artifacts["opt_g"])
        adam_from_flax(s.d, s.opt_d, artifacts["opt_d"])

    # ------------------------------------------------------------ plumbing
    def _save_cli_arguments(self):
        save_cli_arguments(f"{self.output_root}/config.args",
                           argv=getattr(self.args, "_argv", None))

    def _generate_run_id(self, suffix_len=6):
        now = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        random_suffix = "".join(random.sample(string.ascii_letters, suffix_len))
        return f"{now}_{random_suffix}"

    @property
    def output_root(self):
        return f"{self.args.output}/{self.run_id}"

    # ----------------------------------------------------------------- CLI
    @classmethod
    def get_component_classes(cls, args):
        from .components.image_sampler import ImageSamplerComponent
        from .components.model_checkpoint import ModelCheckpointComponent
        return [ImageSamplerComponent, ModelCheckpointComponent]

    @classmethod
    def create_from_cli(cls, argv=None):
        """Two-pass parser assembly so the selected components can register
        their own flags."""
        base_parser = argparse.ArgumentParser(
            description="TartanGAN trainer (PyTorch)", fromfile_prefix_chars="@"
        )
        cls.add_args_to_parser(base_parser)
        base_args = base_parser.parse_known_args(argv)[0]

        component_classes = cls.get_component_classes(base_args)
        full_parser = argparse.ArgumentParser(
            description="TartanGAN trainer (PyTorch)", fromfile_prefix_chars="@"
        )
        cls.add_args_to_parser(full_parser)
        for component_class in component_classes:
            component_class.add_args_to_parser(full_parser)
        args = full_parser.parse_args(argv)
        args._argv = list(argv) if argv is not None else None

        print(f'Using torch device "{args.device}"')
        components = [cc(args) for cc in component_classes]
        return cls(args, components)

    @classmethod
    def add_args_to_parser(cls, p):
        # the JAX trainer's flags and defaults (trainer.py:492-599)
        p.add_argument("data_path")
        p.add_argument("--batch-size", type=int, default=128)
        p.add_argument("--gen-freq", type=int, default=200,
                       help="Output samples every N batches")
        p.add_argument("--lr-g", type=float, default=1e-4,
                       help="Learning rate for the generator")
        p.add_argument("--lr-d", type=float, default=4e-4,
                       help="Learning rate for the discriminator")
        p.add_argument("--lr-target-g", type=float, default=1e-3,
                       help="EMA factor for the target generator")
        p.add_argument("--epochs", type=int, default=10000)
        p.add_argument("--output", default="output",
                       help="Root of output locations. A path segment unique "
                            "to the run will be appended.")
        p.add_argument("--dataset-cache", default="cache/{root}_{size}.pkl",
                       help="Location of dataset cache for the folder "
                            "dataset (not ported yet)")
        p.add_argument("--grad-penalty", type=float, default=5.0,
                       help="R1 gradient penalty weight on real data")
        p.add_argument("--config", default="64",
                       help="Id of model configuration (see configs.py)")
        p.add_argument("--model-scale", type=float, default=1.0,
                       help="Multiply all layer widths by this factor")
        p.add_argument("--cache-dataset", action="store_true",
                       help="Cache the folder dataset (not ported yet; no "
                            "effect on an archive)")
        p.add_argument("--g-base", default="mlp",
                       help="Generator latent input: 'mlp' or 'tiledz'")
        p.add_argument("--norm", default="bn",
                       help="Normalization: 'bn' (batchnorm) or 'id'")
        p.add_argument("--activation", default="relu",
                       help="Activation: 'relu' or 'elu' ('selu' is not "
                            "ported yet)")
        p.add_argument("--quiet-logs", action="store_true",
                       help="Reduce log output")
        p.add_argument("--log-iters", type=int, default=100,
                       help="Progress logging frequency in steps")
        p.add_argument("--log-progress-newlines", action="store_true",
                       help="Emit each progress refresh on its own line "
                            "instead of rewriting one line in place")
        p.add_argument("--metrics-collector", default=None,
                       help="Metric collector (not ported yet)")
        p.add_argument("--run-id", type=type_or_none(str), default=None,
                       help="Explicit run id (otherwise generated)")
        p.add_argument("--fid", action="store_true",
                       help="Calculate FID test metric (not ported yet)")
        p.add_argument("--profile-dir", type=type_or_none(str), default=None,
                       help="Capture a device trace (not ported yet)")
        p.add_argument("--timing", action="store_true",
                       help="Log images/sec throughput (not ported yet)")
        p.add_argument("--r1-interval", type=int, default=1,
                       help="Lazy R1 regularization: apply the R1 "
                            "double-backward every N steps with weight "
                            "grad_penalty*N. 1 = R1 every step")
        p.add_argument("--iters-d", type=int, default=1,
                       help="Discriminator updates per generator update")
        p.add_argument("--remat", action="store_true",
                       help="Rematerialize blocks (not ported yet)")
        p.add_argument("--remat-policy", default="full",
                       choices=("full", "convs", "dots"),
                       help="With --remat: what may be saved (not ported "
                            "yet)")
        p.add_argument("--parity-blocks", default="auto",
                       choices=("auto", "on", "off"),
                       help="Parity-domain tower blocks; auto = off here "
                            "(the JAX package's rule off a TPU)")
        p.add_argument("--steps-per-call", type=int, default=1,
                       help="Train steps per call (only 1 is ported)")
        p.add_argument("--device-data", action="store_true",
                       help="Keep the archive on the device (not ported "
                            "yet)")
        p.add_argument("--dtype", default="auto",
                       choices=["auto", "bf16", "f32"],
                       help="Compute dtype (params always f32); auto = f32 "
                            "(the JAX package's rule off a TPU)")
        p.add_argument("--num-devices", type=type_or_none(int), default=None,
                       help="Devices in the data mesh (only 1 is ported)")
        p.add_argument("--tp", type=int, default=1,
                       help="Tensor-parallel degree (only 1 is ported)")
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--ema-start", default="copy",
                       choices=["copy", "reference"],
                       help="'copy' initializes target-G = G; 'reference' "
                            "replicates the reference bug where the initial "
                            "'copy' is a single EMA step from random init")
        p.add_argument("--device", default="cuda",
                       help="torch device to train on (cuda or cpu)")
