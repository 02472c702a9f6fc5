"""Kubeflow-pipeline JSON metrics emitter: a copy of
``tartangan_tpu/train/components/metrics/kubeflow_pipeline.py``
(reference components/metrics/kubeflow_pipeline.py:11-28)."""
from __future__ import annotations

import json
import os

from ....utils.fs import maybe_makedirs, smart_open
from ....utils.kubeflow import key_to_kf_name
from ....utils.scalars import last_scalar
from .base import FileBasedMetricsComponent


class KubeflowMetricsComponent(FileBasedMetricsComponent):
    """Output metrics in the Kubeflow pipelines metrics JSON format."""

    whitelist = None

    def on_train_end(self, steps, logs):
        output = dict(
            metrics=[
                dict(name=key_to_kf_name(key), numberValue=last_scalar(values[-1]))
                for key, values in logs.items()
                if values and (not self.whitelist or key in self.whitelist)
            ]
        )
        dirname = os.path.dirname(self.args.metrics_path)
        if dirname:
            maybe_makedirs(dirname, exist_ok=True)
        with smart_open(self.args.metrics_path, "w") as outfile:
            json.dump(output, outfile)
