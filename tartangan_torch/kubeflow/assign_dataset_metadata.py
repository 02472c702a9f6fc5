"""Register a dataset artifact in the metadata store: a copy of
``tartangan_tpu/kubeflow/assign_dataset_metadata.py`` (reference
kubeflow/assign_dataset_metadata.py:7-33).

Usage: python -m tartangan_torch.kubeflow.assign_dataset_metadata NAME URI
       [--version V] [--workspace W]
"""
from __future__ import annotations

from .base_metadata_app import BaseMetadataApp
from .metadata_mixin import _metadata


class AssignDatasetMetadata(BaseMetadataApp):
    def run(self):
        super().run()
        metadata = _metadata()
        execution = metadata.Execution(
            "assign-dataset-metadata", workspace=self.metadata_workspace)
        ds = metadata.DataSet(
            name=self.args.dataset_name,
            uri=self.args.dataset_uri,
            version=self.args.version,
        )
        execution.log_output(ds)

    @classmethod
    def add_args_to_parser(cls, p):
        super().add_args_to_parser(p)
        p.add_argument("dataset_name", help="Name of metadata entity")
        p.add_argument("dataset_uri", help="Location of the target dataset")
        p.add_argument("--version", default="0")


def main(argv=None):
    AssignDatasetMetadata(AssignDatasetMetadata.parse_cli_args(argv)).run()


if __name__ == "__main__":
    main()
