"""File-based metrics base: a copy of
``tartangan_tpu/train/components/metrics/base.py`` (reference
components/metrics/base.py:4-8)."""
from __future__ import annotations

from ..base import TrainerComponent


class FileBasedMetricsComponent(TrainerComponent):
    @classmethod
    def add_args_to_parser(cls, parser):
        parser.add_argument("--metrics-path", default=None,
                            help="Where to output a file containing run metrics")
