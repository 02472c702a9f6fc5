"""Checkpoint component that also registers the model with Kubeflow.

Counterpart of ``tartangan_tpu/train/components/kubeflow_model_checkpoint
.py`` (reference components/kubeflow_model_checkpoint.py:10-54, which the
JAX package repairs by extending the checkpoint component). With
``--kubeflow-metadata`` a run resumes from the latest model of its run id
in the metadata store (its ``trainer.json`` and checkpoint), and the final
checkpoint is logged as a ``Model`` artifact; without it, it is the
checkpoint component. Under a mesh every rank resumes; rank 0 logs.
"""
from __future__ import annotations

import json

from ...kubeflow.metadata_mixin import MetadataMixin, _metadata
from ...utils.fs import smart_open
from .model_checkpoint import ModelCheckpointComponent


class KubeflowModelCheckpointComponent(ModelCheckpointComponent,
                                       MetadataMixin):
    def on_train_begin(self, steps, logs):
        self._loaded_from = None
        if getattr(self.trainer.args, "kubeflow_metadata", False):
            self._setup_kubeflow_metadata()
            self.load_from_metadata()
        else:
            super().on_train_begin(steps, logs)

    def _setup_kubeflow_metadata(self):
        self.create_metadata_store()
        self.create_metadata_workspace(name="tartangan")

    def load_from_metadata(self):
        models_md = self.find_metadata_models_by_name(self.model_name)
        if not models_md:
            print("No model metadata found.")
            return
        model_md = models_md[-1]
        with smart_open(f"{model_md['uri']}/trainer.json", "r") as infile:
            self.trainer.set_state(json.load(infile))
        self.load_checkpoint()

    def on_train_end(self, steps, logs):
        super().on_train_end(steps, logs)
        if getattr(self.trainer.args, "kubeflow_metadata", False) \
                and self.writer:
            self.save_checkpoint_metadata()

    def save_checkpoint_metadata(self):
        metadata = _metadata()
        execution = metadata.Execution(
            "train", workspace=self.metadata_workspace)
        model_md = metadata.Model(
            name=self.model_name, uri=self.checkpoint_root, version="0")
        execution.log_output(model_md)

    @property
    def model_name(self):
        return self.trainer.run_id

    @classmethod
    def add_args_to_parser(cls, parser):
        super().add_args_to_parser(parser)
        parser.add_argument("--kubeflow-metadata", action="store_true",
                            help="Track checkpoints in the Kubeflow "
                                 "metadata store")
