"""Step-numbered checkpoint save/resume in the JAX trainer's layout.

Counterpart of ``tartangan_tpu/train/components/model_checkpoint.py:25-149``
(msgpack format): ``{output}/{run_id}/checkpoints/{steps}/`` holds
``g``, ``g_target``, ``d``, ``opt_g`` and ``opt_d`` (and a trainer's other
artifacts, as ``{name}.msgpack``: the text GAN's ``embedding`` and
``opt_emb``) as flax msgpack trees
(``utils/msgpack.py``, the trees from ``convert.py``) and
``trainer.json``, so the JAX package's ``serialization.from_bytes`` and
``tartangan_tpu.serve`` read the port's checkpoints and the port resumes
from the JAX trainer's. Same CLI: ``--checkpoint-freq``,
``--resume-training-step``, ``--resume-training-latest``,
``--checkpoint-format``.

``--checkpoint-format orbax`` writes each artifact as the directory
``{name}.orbax`` in orbax's ``StandardCheckpointer`` layout
(``utils/orbax.py``: an OCDBT store of zarr arrays, written and read
without orbax or tensorstore), which the JAX package's orbax path reads,
and reads the JAX package's. As there, orbax paths are local only: an
``s3://`` output raises ``ValueError``.
"""
from __future__ import annotations

import json

from ...utils import msgpack, orbax
from ...utils.cli import type_or_none
from ...utils.fs import is_s3_path, maybe_makedirs, smart_ls, smart_open
from .base import TrainerComponent

ARTIFACT_FILES = {
    "g": "g.msgpack",
    "g_target": "g_target.msgpack",
    "d": "d.msgpack",
    "opt_g": "opt_g.msgpack",
    "opt_d": "opt_d.msgpack",
}


class ModelCheckpointComponent(TrainerComponent):
    """Saves the models at regular intervals."""

    def on_train_begin(self, steps, logs):
        self._loaded_from = None
        if self._format == "orbax" and is_s3_path(self.checkpoint_root):
            raise ValueError("--checkpoint-format orbax writes local "
                             f"directories only, not {self.checkpoint_root}")
        if self.trainer.args.resume_training_step:
            self.trainer.steps = self.trainer.args.resume_training_step
            self.load_checkpoint()
        elif self.trainer.args.resume_training_latest:
            self.resume_training_from_latest()

    def on_batch_end(self, steps, logs):
        if steps and self.every(self.trainer.args.checkpoint_freq, steps):
            if self._loaded_from != steps:  # prevent immediate re-save
                self.save_checkpoint(steps)

    def on_train_end(self, steps, logs):
        self.save_checkpoint(steps)

    @property
    def _format(self):
        return getattr(self.trainer.args, "checkpoint_format", "msgpack")

    def _orbax_path(self, name):
        return f"{self.checkpoint_root}/{name}.orbax"

    def save_checkpoint(self, steps):
        """Every rank gathers the artifacts (``--tp`` slices); rank 0
        writes them."""
        artifacts = self.trainer.checkpoint_artifacts()
        if not self.writer:
            return
        maybe_makedirs(self.checkpoint_root)
        print(f"saving checkpoint to {self.checkpoint_root}")
        for name, tree in artifacts.items():
            if self._format == "orbax":
                orbax.save(self._orbax_path(name), tree)
                continue
            fname = ARTIFACT_FILES.get(name, f"{name}.msgpack")
            with smart_open(f"{self.checkpoint_root}/{fname}", "wb") as out:
                out.write(msgpack.dumps(tree))
        with smart_open(f"{self.checkpoint_root}/trainer.json", "w") as out:
            json.dump(self.trainer.get_state(), out)

    def load_checkpoint(self):
        print(f"resuming from checkpoint {self.checkpoint_root}")
        self._loaded_from = self.trainer.steps
        loaded = {}
        for name in self.trainer.checkpoint_artifacts():
            if self._format == "orbax":
                loaded[name] = orbax.restore(self._orbax_path(name))
                continue
            fname = ARTIFACT_FILES.get(name, f"{name}.msgpack")
            filename = f"{self.checkpoint_root}/{fname}"
            with smart_open(filename, "rb") as infile:
                loaded[name] = msgpack.loads(infile.read())
        self.trainer.load_checkpoint_artifacts(loaded)
        with smart_open(f"{self.checkpoint_root}/trainer.json", "r") as infile:
            self.trainer.set_state(json.load(infile))

    def resume_training_from_latest(self):
        latest_id = self.latest_checkpoint_id()
        if latest_id is not None:
            self.trainer.steps = latest_id
            self.load_checkpoint()
        else:
            print("No checkpoints found to resume.")

    def latest_checkpoint_id(self):
        """Largest numeric subdir of checkpoints/."""
        int_dirs = []
        for key in smart_ls(self.all_checkpoints_root):
            try:
                int_dirs.append(int(key))
            except ValueError:
                pass
        return max(int_dirs) if int_dirs else None

    @property
    def checkpoint_root(self):
        return f"{self.all_checkpoints_root}/{self.trainer.steps}"

    @property
    def all_checkpoints_root(self):
        return f"{self.trainer.output_root}/checkpoints"

    @classmethod
    def add_args_to_parser(cls, parser):
        parser.add_argument("--checkpoint-freq", type=int, default=100000,
                            help="Output a checkpoint every N batches")
        parser.add_argument("--resume-training-step",
                            type=type_or_none(int), default=None,
                            help="Resume training from this step's checkpoint "
                                 "under the --run-id output path")
        parser.add_argument("--resume-training-latest", action="store_true",
                            help="Resume from the latest checkpoint for the "
                                 "given run-id")
        parser.add_argument("--checkpoint-format", default="msgpack",
                            choices=["msgpack", "orbax"],
                            help="msgpack: one flax pytree per artifact "
                                 "(S3-capable); orbax: StandardCheckpointer "
                                 "directories (local paths only)")
