"""Kubeflow metadata-store client helpers.

A copy of ``tartangan_tpu/kubeflow/metadata_mixin.py`` (reference
tartangan/kubeflow/metadata_mixin.py:6-33). The ``kubeflow.metadata``
gRPC client is an optional dependency, imported at first use with the
same error as there.
"""
from __future__ import annotations

import os


def _metadata():
    try:
        from kubeflow.metadata import metadata  # noqa: PLC0415
    except ImportError as e:
        raise RuntimeError(
            "kubeflow metadata apps require the 'kubeflow-metadata' package"
        ) from e
    return metadata


class MetadataMixin:
    def create_metadata_store(self):
        metadata = _metadata()
        self.metadata_store = metadata.Store(
            grpc_host=os.getenv("METADATA_STORE_HOST",
                                "metadata-grpc-service.kubeflow"),
            grpc_port=int(os.getenv("METADATA_STORE_PORT", "8080")),
        )
        return self.metadata_store

    def create_metadata_workspace(self, name):
        metadata = _metadata()
        self.metadata_workspace = metadata.Workspace(
            store=self.metadata_store, name=name)
        return self.metadata_workspace

    def find_metadata_datasets_by_name(self, name):
        return self.find_metadata_artifacts_by_name(
            _metadata().DataSet, name)

    def find_metadata_models_by_name(self, name):
        return self.find_metadata_artifacts_by_name(_metadata().Model, name)

    def find_metadata_artifacts_by_name(self, artifact_class, name):
        objs = self.metadata_workspace.list(
            artifact_class.ARTIFACT_TYPE_NAME)
        return [obj for obj in objs if obj["name"] == name]
