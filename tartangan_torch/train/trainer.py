"""Trainer core: the host loop around the train step.

Counterpart of ``tartangan_tpu/train/trainer.py:48-599``: the two-pass CLI
with ``@argfile`` and the same flags and defaults (plus ``--device``), the
run id and ``config.args``, the epoch loop with component hooks and a
SIGTERM-safe shutdown, the logs dict, and the checkpoint artifacts in the
JAX trainer's layout (``g``, ``g_target``, ``d``, ``opt_g``, ``opt_d``).

Batches are uint8 crops made on the host (``data/``: an archive, or a
directory of images) and copied to the device one batch ahead from pinned
memory, or, under ``--device-data``, gathered on the device from the
archive kept there (``data/device.py``); the step normalizes them.
Latents (and the device archive's draws) come from the trainer's own
``torch.Generator``, seeded by ``--seed``, on the training device.
``--steps-per-call K`` runs K steps a call (``train/multi.py``), replayed
from captured CUDA graphs on the card.

``--num-devices N`` and ``--tp T`` run the trainer on a mesh of N ranks,
one process each (``parallel/``; ``run_cli`` starts them). ``--batch-size``
is the global batch, as in the JAX package: every rank draws the global
batch's indices, crops, latents and other draws from the same seeded
streams and keeps its rows, so a rank's numbers are the one-process run's.
The losses and BatchNorm's moments are taken over the global batch, the
gradients are summed over the data group before each optimizer step (so
Adam and the EMA run alike on every rank), the logged metrics are summed
over it too, and ``--tp`` shards the weights' output channels over the
model group (``parallel/tp.py``). Only rank 0 writes samples, checkpoints,
logs and traces; checkpoints stay in the one-process layout. Under the
mesh a K-step call runs eagerly (gloo's collectives are not captured in
a CUDA graph).

``--checkpoint-format orbax`` raises ``NotImplementedError``
(``_UNPORTED``): the port imports neither orbax nor tensorstore.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib
import os
import random
import signal
import string
import sys
from collections import defaultdict
from datetime import datetime

import torch
import torch.distributed as dist

from ..convert import adam_from_flax, adam_to_flax, from_flax, to_flax
from ..data.device import (
    crop_size_of,
    draw,
    gather_crop,
    wrap_step_with_device_data,
)
from ..data.image_bytes import ImageBytesDataset
from ..data.prefetch import EpochBatcher, prefetch_to_device
from ..ops.remat import POLICIES
from ..parallel import collectives as C
from ..parallel import mesh as M
from ..utils.cli import save_cli_arguments, type_or_none
from ..utils.fs import is_s3_path, maybe_makedirs
from ..utils.precision import full_float32, resolve_dtype
from ..utils.scalars import last_scalar
from .components.container import ComponentContainer
from .multi import GraphedChunk, chunk_train_step, stack_batches
from .progress import ProgressLine

# flag -> (is it set away from its default?, what is missing)
_UNPORTED = {
    "checkpoint_format": (lambda a: getattr(a, "checkpoint_format",
                                            "msgpack") != "msgpack",
                          "orbax checkpoints"),
}


def check_unported(args) -> None:
    """Raise ``NotImplementedError`` for any flag of a feature that is
    not ported (orbax checkpoints)."""
    for flag, (is_set, what) in _UNPORTED.items():
        if is_set(args):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} {getattr(args, flag)}: {what} "
                "is not ported yet")


def _train_cli(trainer_path: str, argv):
    """One rank's (or the only process's) run of a trainer's CLI:
    ``trainer_path`` is 'module:Class'. Returns the last logged value of
    each metric, as floats."""
    module, name = trainer_path.split(":")
    cls = getattr(importlib.import_module(module), name)
    trainer = cls.create_from_cli(argv)
    trainer.train()
    return {k: last_scalar(v[-1]) for k, v in trainer.logs.items() if v}


def _writes_only(component_class) -> bool:
    """A component that only writes (a metrics collector, the profiler):
    rank 0 of a mesh runs it, the other ranks leave it out. The FID
    component's Inception runs on every rank."""
    from .components.metrics.base import FileBasedMetricsComponent
    from .components.metrics.fid import FIDComponent
    from .components.profiler import ProfilerComponent
    return component_class is not FIDComponent and issubclass(
        component_class, (FileBasedMetricsComponent, ProfilerComponent))


def checkpoint_component(args):
    """The checkpoint component: under ``--metrics-collector kubeflow`` the
    one that also tracks the model in Kubeflow's metadata store (it adds
    ``--kubeflow-metadata``), else the plain one."""
    if args.metrics_collector == "kubeflow":
        from .components.kubeflow_model_checkpoint import (
            KubeflowModelCheckpointComponent,
        )
        return KubeflowModelCheckpointComponent
    from .components.model_checkpoint import ModelCheckpointComponent
    return ModelCheckpointComponent


def metrics_component(name: str):
    """--metrics-collector's component class: katib, kubeflow or
    tensorboard."""
    from .components.metrics import (
        KatibMetricsComponent,
        KubeflowMetricsComponent,
        TensorboardComponent,
    )
    return {"katib": KatibMetricsComponent,
            "kubeflow": KubeflowMetricsComponent,
            "tensorboard": TensorboardComponent}[name]


class Trainer:
    """Base trainer. Subclasses implement ``build_models`` (the modules,
    the optimizers, ``self.state`` and ``self._train_step``)."""

    def __init__(self, args, components):
        self.args = args
        check_unported(args)
        if (getattr(args, "data_path", None)
                and not is_s3_path(args.data_path)
                and not os.path.exists(args.data_path)):
            raise FileNotFoundError(
                f"data_path does not exist: {args.data_path}")
        self.device = torch.device(args.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("--device cuda but no CUDA device is "
                               "available; pass --device cpu to train on "
                               "the CPU")
        self.mesh = self._join_mesh(args)
        if self.mesh is not None:
            self.device = self.mesh.device
        # the compute dtype; parameters, BatchNorm statistics, Adam's state
        # and the EMA target stay float32 (flax's dtype / param_dtype)
        self.dtype = resolve_dtype(args.dtype)
        full_float32()

        self.run_id = args.run_id if args.run_id is not None \
            else self._generate_run_id()
        if self.mesh is not None:
            # the run id is random per process: rank 0's is the run's
            chosen = [self.run_id]
            dist.broadcast_object_list(chosen, src=0)
            self.run_id = chosen[0]
        if M.is_writer():
            maybe_makedirs(self.output_root, exist_ok=True)
            self._save_cli_arguments()

        self.components = ComponentContainer()
        self.components.trainer = self
        self.components.add_components(*components)

        self.steps = 0
        self.epoch = 1
        self.steps_per_call = max(getattr(args, "steps_per_call", 1) or 1, 1)
        self._chunk_call = None
        self.z_gen = torch.Generator(device=self.device).manual_seed(args.seed)

    # ------------------------------------------------------------------ mesh
    @staticmethod
    def _join_mesh(args):
        """The mesh of this rank, or None for one process. A process group
        exists when ``run_cli`` (or ``torchrun``) started the ranks; more
        than one device without one is an error."""
        mesh = M.current()
        if mesh is not None:
            if (args.num_devices not in (None, mesh.world)
                    or args.tp != mesh.tp):
                raise ValueError(
                    f"--num-devices {args.num_devices} --tp {args.tp}, but "
                    f"this process is a rank of a {mesh.world}-rank mesh "
                    f"with tp {mesh.tp}")
        else:
            world = M.resolve_world(args.num_devices, args.tp,
                                    torch.device(args.device).type)
            if world == 1:
                return None
            raise ValueError(
                f"--num-devices {world}: start the ranks with the trainer's "
                "CLI (python -m tartangan_torch.train.<trainer>) or torchrun")
        if args.batch_size % mesh.dp:
            raise ValueError(f"--batch-size {args.batch_size} does not "
                             f"divide over {mesh.dp} data shards")
        return mesh

    def place(self, module):
        """``module`` placed on the mesh: its weights' output channels
        sharded over the model group under ``--tp``, else as it is."""
        if self.mesh is not None and self.mesh.tp > 1:
            from ..parallel.tp import shard_module_
            shard_module_(module, self.mesh.model)
        return module

    def _setup_mesh_state(self):
        """After ``build_models``: each optimizer sums its gradients over
        the data group before it steps, and ``--tp`` logs the placement
        summary."""
        if self.mesh is None:
            return
        group = self.mesh.data_group
        for opt in vars(self.state).values():
            if isinstance(opt, torch.optim.Optimizer):
                params = [p for g in opt.param_groups for p in g["params"]]
                opt.register_step_pre_hook(
                    lambda _opt, _args, _kwargs, params=params:
                        C.all_reduce_grads(params, group))
        if self.mesh.tp > 1:
            from ..parallel.tp import placement_summary
            summary = placement_summary(self.checkpoint_artifacts(),
                                        self.mesh.tp)
            if M.is_writer():
                print(summary)

    def shard(self, t, dim: int = 0):
        """This rank's rows of a global-batch tensor (or numpy array) along
        ``dim``; itself without a mesh."""
        if self.mesh is None:
            return t
        if isinstance(t, torch.Tensor):
            return self.mesh.shard(t, dim)
        rows = self.mesh.rows(t.shape[dim])
        return t[(slice(None),) * dim + (rows,)]

    def shard_extra(self, draws: dict, lead: tuple) -> dict:
        """This rank's part of ``extra_draws``'s draws (made for the global
        batch); the CNN step takes none, the scene's patch noise has no
        batch dimension."""
        return draws

    # ----------------------------------------------------------------- hooks
    def build_models(self):
        raise NotImplementedError

    def prepare_dataset(self):
        """Directory -> the lazy-resize folder dataset (with its cache under
        ``--dataset-cache``); file -> the archive with a random crop."""
        img_size = self.g.max_size
        if os.path.isdir(self.args.data_path):
            from ..data.image_folder import ImageFolderDataset
            dataset = ImageFolderDataset(self.args.data_path, img_size)
            if self.args.dataset_cache:
                dataset.load_cache(
                    self.dataset_cache_path(img_size, root=dataset.root))
            return dataset
        return ImageBytesDataset.from_path(self.args.data_path,
                                           crop_size=img_size)

    def dataset_cache_path(self, size, root=None):
        root = root if root is not None else self.dataset.root
        root_hash = hashlib.md5(root.encode("utf-8")).hexdigest()
        return self.args.dataset_cache.format(root=root_hash, size=size)

    def _setup_device_data(self):
        """``--device-data``: the uint8 archive on the device, once."""
        images = getattr(self.dataset, "images", None)
        if images is None:
            raise NotImplementedError(
                "--device-data requires a pre-resized uint8 archive "
                "(ImageBytesDataset); a folder dataset streams from the host")
        self._crop = crop_size_of(images.shape, self.dataset.crop_size)
        self._archive = torch.from_numpy(images).to(self.device)

    # ------------------------------------------------------------ train loop
    def train(self):
        self.build_models()
        self._setup_mesh_state()
        print(f"Preparing dataset from {self.args.data_path}")
        self.dataset = self.prepare_dataset()
        if self.args.device_data:
            self._setup_device_data()
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
        k = self.steps_per_call
        self._warn_chunk_cadence(k)
        if k > 1 and self.mesh is not None:
            print(f"--steps-per-call {k} on a {self.mesh.world}-rank mesh: "
                  "each call runs its steps eagerly (no CUDA graph)")
        # with K steps a call, an epoch runs the largest multiple of K
        # batches that fits (a graph has one shape)
        num_batches = (len(batcher) // k) * k
        if num_batches == 0:
            raise ValueError(
                f"dataset of {len(self.dataset)} images yields "
                f"{len(batcher)} batch(es) of size {self.args.batch_size} "
                f"but --steps-per-call={k} needs at least {k} per epoch; "
                "lower --steps-per-call or --batch-size (training would "
                "otherwise run zero steps)")
        try:
            self.components.invoke("train_begin", self.steps, logs)
            while self.epoch <= self.args.epochs:
                if not self.args.quiet_logs:
                    print(f"Starting epoch {self.epoch}")
                self.components.invoke(
                    "epoch_begin", self.steps, self.epoch, logs)
                progress.epoch_begin(self.epoch, num_batches)
                epoch_batches = 0
                if self.args.device_data:
                    # batches are gathered on the device, in the step
                    batch_iter = iter([None] * (num_batches // k))
                elif k > 1:
                    # K host batches stacked: one copy a call
                    batch_iter = prefetch_to_device(
                        (self.shard(b, 1) for b in
                         stack_batches(batcher.epoch(), k)), self.device)
                else:
                    batch_iter = prefetch_to_device(
                        (self.shard(b) for b in batcher.epoch()),
                        self.device)
                for batch in batch_iter:
                    self.components.invoke("batch_begin", self.steps, logs)
                    training_metrics = C.sum_metrics(self.train_batch(batch))
                    for name, value in training_metrics.items():
                        logs[name].append(value)
                    self.components.invoke("batch_end", self.steps, logs)
                    epoch_batches += k
                    li = self.args.log_iters
                    # the call [steps, steps + K) crosses a multiple of
                    # log_iters (steps % log_iters == 0 at K == 1)
                    if (not self.args.quiet_logs
                            and (self.steps + k - 1) // li
                            > (self.steps - 1) // li):
                        progress.update(self.steps, epoch_batches,
                                        self.args.batch_size,
                                        training_metrics)
                    self.steps += k
                progress.epoch_end()
                self.components.invoke(
                    "epoch_end", self.steps, self.epoch, logs)
                if (self.epoch == 1 and self.args.cache_dataset
                        and hasattr(self.dataset, "save_cache")):
                    self.dataset.save_cache(
                        self.dataset_cache_path(self.g.max_size))
                self.epoch += 1
        except KeyboardInterrupt:
            pass
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)
        self.components.invoke("train_end", self.steps, logs)

    def train_batch(self, batch):
        """One call: a train step on a uint8 device batch, or K steps
        (``--steps-per-call``) on stacked (K, B, ...) batches; ``batch`` is
        None under ``--device-data``, where each step gathers its own. Lazy
        R1 alternates the two steps on the global step count, as the JAX
        trainer does. Returns device tensors, 0-d or stacked (K,), with no
        host sync here."""
        if self.steps_per_call > 1:
            return self._train_chunk(batch)
        if batch is None:
            idx, ys, xs = (self.shard(t[0])
                           for t in self._draw_device_data(1))
            batch = gather_crop(self._archive, idx, ys, xs, self._crop)
        lazy_off = (self._r1_interval > 1
                    and self.steps % self._r1_interval != 0)
        fn = self._train_step_alt if lazy_off else self._train_step
        # the global batch's draws, of which this rank keeps its rows
        n = self.args.batch_size
        z_d = torch.stack([self.sample_z(n) for _ in range(self.args.iters_d)])
        z_g = self.sample_z(n)
        extra = self.shard_extra(self.extra_draws((), n), ())
        return fn(self.state, batch, self.shard(z_d, 1), self.shard(z_g),
                  **extra)

    def _draw_device_data(self, k):
        n, h, w, _ = self._archive.shape
        return draw(n, h, w, self._crop, self.args.batch_size, self.z_gen,
                    k)

    def _train_chunk(self, batch):
        """K steps in one call, fed the draws of all K steps, made here
        outside the call (``train/multi.py``)."""
        if self._chunk_call is None:
            self._chunk_call = self.make_chunk_call(batch is None)
        inputs = self._archive if batch is None else batch
        return self._chunk_call(self.state, inputs, self.steps,
                                **self.chunk_draws(batch is None))

    def chunk_draws(self, device_data: bool) -> dict:
        """Every random draw of one K-step call, on the device: the latents
        ``z_d`` (K, iters_d, B, latent) and ``z_g`` (K, B, latent), the
        subclass's ``extra_draws`` and, from the device archive, the rows
        ``idx`` and crop offsets ``ys``, ``xs`` (K, B)."""
        k, b = self.steps_per_call, self.args.batch_size
        draws = {}
        if device_data:
            draws.update(zip(("idx", "ys", "xs"),
                             (self.shard(t, 1)
                              for t in self._draw_device_data(k))))
        draws["z_d"] = self.shard(self.draw_z((k, self.args.iters_d, b)), 2)
        draws["z_g"] = self.shard(self.draw_z((k, b)), 1)
        draws.update(self.shard_extra(self.extra_draws((k,), b), (k,)))
        return draws

    def draw_z(self, lead: tuple) -> torch.Tensor:
        """Latents of shape ``lead + (latent,)`` from the trainer's
        generator, on the device."""
        return torch.randn(lead + (self.gan_config.latent_dims,),
                           generator=self.z_gen, device=self.device)

    def extra_draws(self, lead: tuple, n: int) -> dict:
        """The draws a subclass's train step takes besides the latents, as
        keyword arguments: for one step (``lead`` ()) or a K-step call
        (``lead`` (K,)) at batch size ``n``, from the trainer's generator.
        The CNN step takes none."""
        return {}

    def make_chunk_call(self, device_data: bool):
        """The K-step call: ``chunk_train_step`` over the train step (and
        its lazy-R1 alternate), in 'broadcast' mode over the device archive
        or 'scan' over stacked host batches; a ``GraphedChunk`` of it on
        CUDA, itself (eager) elsewhere."""
        step, alt = self._train_step, self._train_step_alt
        if device_data:
            step = wrap_step_with_device_data(step, self._crop)
            if alt is not None:
                alt = wrap_step_with_device_data(alt, self._crop)
        multi = chunk_train_step(
            step, self.steps_per_call, "broadcast" if device_data else "scan",
            alt_step_fn=alt, alt_interval=self._r1_interval)
        if self.device.type != "cuda" or self.mesh is not None:
            return multi
        return GraphedChunk(multi)

    def _warn_chunk_cadence(self, k):
        """--steps-per-call moves the step counter K at a time; component
        frequencies that aren't multiples of K can only fire late (on the
        next call boundary). Say so once."""
        if k <= 1:
            return
        for flag in ("log_iters", "gen_freq", "checkpoint_freq", "fid_freq"):
            freq = getattr(self.args, flag, None)
            if freq and freq % k:
                print(f"warning: --{flag.replace('_', '-')}={freq} is not a "
                      f"multiple of --steps-per-call={k}; it will fire on "
                      f"chunk boundaries only")

    # ------------------------------------------------------------- sampling
    def sample_z(self, n=None):
        if n is None:
            n = self.args.batch_size
        return self.draw_z((n,))

    def generate(self, n=None, target_g=False, z=None):
        """Images (NCHW in [-1, 1], the compute dtype) on the training
        device from random or given z, with train-mode BatchNorm that
        leaves the running statistics as they are (the JAX sampler discards
        its batch-stat update). No host synchronization: the FID component
        feeds these to Inception on the device. Under a mesh every rank
        generates the whole batch (``mesh.replicated``), so the samples are
        the one-process run's."""
        if z is None:
            z = self.sample_z(n)
        z = torch.as_tensor(z, device=self.device)
        g = self.state.g_target if target_g else self.state.g
        with torch.no_grad(), M.replicated():
            return g(z, train=True)

    def sample_g(self, n=None, target_g=False, z=None):
        """``generate``'s samples channels-last as float32 numpy: NHWC
        images (the image sampler's), or the text GAN's (B, L, D)."""
        out = self.generate(n, target_g, z)
        return out.movedim(1, -1).float().cpu().numpy()

    # --------------------------------------------------------------- state
    def get_state(self):
        return dict(epoch=self.epoch, steps=self.steps)

    def set_state(self, state):
        for key, value in state.items():
            setattr(self, key, value)

    def _unsharded(self):
        """The models whole for a while under ``--tp`` (``tp.unsharded``);
        a no-op otherwise."""
        from ..parallel.tp import unsharded
        s = self.state
        modules = [m for m in vars(s).values() if isinstance(m, torch.nn.Module)]
        opts = [o for o in vars(s).values()
                if isinstance(o, torch.optim.Optimizer)]
        return unsharded(modules, opts)

    def checkpoint_artifacts(self):
        """name -> flax tree of numpy arrays, in the JAX trainer's layout
        (gathered from the model group's slices under ``--tp``; every rank
        calls it)."""
        with self._unsharded():
            return self._checkpoint_artifacts()

    def _checkpoint_artifacts(self):
        s = self.state
        return {
            "g": to_flax(s.g),
            "g_target": {"params": to_flax(s.g_target)["params"]},
            "d": to_flax(s.d),
            "opt_g": adam_to_flax(s.g, s.opt_g),
            "opt_d": adam_to_flax(s.d, s.opt_d),
        }

    def load_checkpoint_artifacts(self, artifacts):
        """Load a one-process checkpoint; under ``--tp`` each rank keeps
        its slices."""
        with self._unsharded():
            self._load_checkpoint_artifacts(artifacts)

    def _load_checkpoint_artifacts(self, artifacts):
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
        classes = [ImageSamplerComponent, checkpoint_component(args)]

        if args.profile_dir or args.timing:
            from .components.profiler import ProfilerComponent
            classes.append(ProfilerComponent)

        if args.fid:
            from .components.metrics.fid import FIDComponent
            classes.append(FIDComponent)

        if args.metrics_collector:
            classes.append(metrics_component(args.metrics_collector))
        return classes

    @classmethod
    def run_cli(cls, argv=None):
        """The trainer's CLI: train in this process, or, for
        ``--num-devices`` N > 1 (or ``--tp`` > 1 on the CPU), start N
        ranks (``parallel.mesh.launch``: NCCL with a card each, gloo on
        the CPU; under ``torchrun`` this process is one rank) and train on
        each. Returns rank 0's last logged value of each metric."""
        argv = list(sys.argv[1:] if argv is None else argv)
        parser = argparse.ArgumentParser(add_help=False,
                                         fromfile_prefix_chars="@")
        cls.add_args_to_parser(parser)
        args = parser.parse_known_args(argv)[0]
        module = cls.__module__
        if module == "__main__":  # python -m tartangan_torch.train.<x>
            module = sys.modules["__main__"].__spec__.name
        path = f"{module}:{cls.__qualname__}"
        device_type = torch.device(args.device).type
        world = M.resolve_world(args.num_devices, args.tp, device_type)
        if world == 1 or M.current() is not None:
            return _train_cli(path, argv)
        return M.launch(_train_cli, world, (path, argv), tp=args.tp,
                        device_type=device_type)

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
        components = [cc(args) for cc in component_classes
                      if M.is_writer() or not _writes_only(cc)]
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
                            "dataset ({root}: md5 of the folder's path)")
        p.add_argument("--grad-penalty", type=float, default=5.0,
                       help="R1 gradient penalty weight on real data")
        p.add_argument("--config", default="64",
                       help="Id of model configuration (see configs.py)")
        p.add_argument("--model-scale", type=float, default=1.0,
                       help="Multiply all layer widths by this factor")
        p.add_argument("--cache-dataset", action="store_true",
                       help="Cache the folder dataset after the first "
                            "epoch (no effect on an archive)")
        p.add_argument("--g-base", default="mlp",
                       help="Generator latent input: 'mlp' or 'tiledz'")
        p.add_argument("--norm", default="bn",
                       help="Normalization: 'bn' (batchnorm) or 'id'")
        p.add_argument("--activation", default="relu",
                       help="Activation: 'relu', 'elu' or 'selu' (selu "
                            "re-initializes G and D for it)")
        p.add_argument("--quiet-logs", action="store_true",
                       help="Reduce log output")
        p.add_argument("--log-iters", type=int, default=100,
                       help="Progress logging frequency in steps")
        p.add_argument("--log-progress-newlines", action="store_true",
                       help="Emit each progress refresh on its own line "
                            "instead of rewriting one line in place")
        p.add_argument("--metrics-collector", default=None,
                       help="Metric collector: katib, kubeflow, tensorboard")
        p.add_argument("--run-id", type=type_or_none(str), default=None,
                       help="Explicit run id (otherwise generated)")
        p.add_argument("--fid", action="store_true",
                       help="Calculate FID test metric")
        p.add_argument("--profile-dir", type=type_or_none(str), default=None,
                       help="Write a torch.profiler trace of steps "
                            "[--profile-start, +--profile-steps) here")
        p.add_argument("--timing", action="store_true",
                       help="Log images/sec throughput")
        p.add_argument("--r1-interval", type=int, default=1,
                       help="Lazy R1 regularization: apply the R1 "
                            "double-backward every N steps with weight "
                            "grad_penalty*N. 1 = R1 every step")
        p.add_argument("--iters-d", type=int, default=1,
                       help="Discriminator updates per generator update")
        p.add_argument("--remat", action="store_true",
                       help="Rematerialize residual blocks in the backward "
                            "pass (saves device memory at high resolutions)")
        p.add_argument("--remat-policy", default="full",
                       choices=POLICIES,
                       help="With --remat: what the checkpoint may save. "
                            "'full' recomputes everything; 'convs' saves "
                            "the main-path conv outputs and recomputes "
                            "only the norm/act chains (less backward "
                            "FLOPs, most of the memory win); 'dots' is "
                            "the stock no-batch-dims policy (no such "
                            "products in the blocks: as 'full')")
        p.add_argument("--parity-blocks", default="auto",
                       choices=("auto", "on", "off"),
                       help="Parity-domain tower blocks; auto = off here "
                            "(the JAX package's rule off a TPU)")
        p.add_argument("--steps-per-call", type=int, default=1,
                       help="Train steps per call: K > 1 replays a "
                            "captured CUDA graph of K steps on the card")
        p.add_argument("--device-data", action="store_true",
                       help="Keep the archive on the device; each step "
                            "gathers and crops its batch there")
        p.add_argument("--dtype", default="auto",
                       choices=["auto", "bf16", "f32"],
                       help="Compute dtype (params always f32); auto = f32 "
                            "(the JAX package's rule off a TPU)")
        p.add_argument("--num-devices", type=type_or_none(int), default=None,
                       help="Ranks in the mesh, one process each (default: "
                            "every visible card on CUDA, --tp on the CPU)")
        p.add_argument("--tp", type=int, default=1,
                       help="Tensor-parallel degree: shard the weights' "
                            "output channels over a (data, model) mesh")
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--ema-start", default="copy",
                       choices=["copy", "reference"],
                       help="'copy' initializes target-G = G; 'reference' "
                            "replicates the reference bug where the initial "
                            "'copy' is a single EMA step from random init")
        p.add_argument("--device", default="cuda",
                       help="torch device to train on (cuda or cpu)")
