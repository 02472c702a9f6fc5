"""Per-batch TensorBoard scalars, written without a TensorBoard package.

Counterpart of ``tartangan_tpu/train/components/metrics/tensorboard.py``
(reference components/metrics/tensorboard.py:9-25): the latest value of
every logged metric, each batch, under the trainer class's name as the main
tag, as ``MainTag/metric`` scalars in ONE event file (``utils/tb_events.py``,
the same bytes as the JAX package's writer).
"""
from __future__ import annotations

from ....utils.scalars import last_scalar
from ....utils.tb_events import ScalarEventWriter
from .base import FileBasedMetricsComponent


class TensorboardComponent(FileBasedMetricsComponent):
    whitelist = None

    def on_train_begin(self, steps, logs):
        metrics_path = f"{self.args.metrics_path}/{self.trainer.run_id}"
        self.summary_writer = ScalarEventWriter(metrics_path)

    def on_batch_end(self, steps, logs):
        scalars = {
            f"{self.main_tag}/{key}": last_scalar(values[-1])
            for key, values in logs.items()
            if values and (not self.whitelist or key in self.whitelist)
        }
        self.summary_writer.add_scalars(steps, scalars)

    def on_train_end(self, steps, logs):
        self.summary_writer.close()

    @property
    def main_tag(self):
        return self.trainer.__class__.__name__
