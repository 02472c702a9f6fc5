"""Katib INI metrics emitter: a copy of
``tartangan_tpu/train/components/metrics/katib.py`` (reference
components/metrics/katib.py:11-43)."""
from __future__ import annotations

import configparser
import os

from ....utils.fs import maybe_makedirs, smart_open
from ....utils.kubeflow import key_to_kf_name
from ....utils.scalars import last_scalar
from .base import FileBasedMetricsComponent


class KatibMetricsComponent(FileBasedMetricsComponent):
    """Output final metric values in a format suitable for Katib's
    file-based metrics collector."""

    whitelist = None

    def on_train_end(self, steps, logs):
        output = {
            key_to_kf_name(key): last_scalar(values[-1])
            for key, values in logs.items()
            if values and (not self.whitelist or key in self.whitelist)
        }
        config = configparser.ConfigParser()
        config["metrics"] = {k: str(v) for k, v in output.items()}
        dirname = os.path.dirname(self.args.metrics_path)
        if dirname:
            maybe_makedirs(dirname, exist_ok=True)
        with smart_open(self.args.metrics_path, "w") as outfile:
            config.write(outfile)
