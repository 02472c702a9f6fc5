"""Fetch a dataset registered in the metadata store by name: a copy of
``tartangan_tpu/kubeflow/download_dataset.py`` (reference
kubeflow/download_dataset.py:6-29). The latest registration wins; its URI
is read with ``utils/fs.py::smart_open`` (a local path or s3://).

Usage: python -m tartangan_torch.kubeflow.download_dataset NAME OUT
       [--workspace W]
"""
from __future__ import annotations

from ..utils.fs import smart_open
from .base_metadata_app import BaseMetadataApp


class DownloadDatasetMetadata(BaseMetadataApp):
    def run(self):
        super().run()
        datasets = self.find_metadata_datasets_by_name(
            self.args.dataset_name)
        dataset = datasets[-1]  # latest registration wins
        with smart_open(dataset["uri"], "rb") as infile:
            with smart_open(self.args.output_path, "wb") as outfile:
                outfile.write(infile.read())

    @classmethod
    def add_args_to_parser(cls, p):
        super().add_args_to_parser(p)
        p.add_argument("dataset_name", help="Name of metadata entity")
        p.add_argument("output_path", help="Where the files go")


def main(argv=None):
    DownloadDatasetMetadata(
        DownloadDatasetMetadata.parse_cli_args(argv)).run()


if __name__ == "__main__":
    main()
