"""Keras-style trainer callback interface.

A copy of ``tartangan_tpu/train/components/base.py`` (reference
tartangan/trainers/components/base.py:4-39). Components are host-side
orchestration around the train step; they observe ``logs`` (device
scalars are converted lazily).
"""
from __future__ import annotations

import abc


class TrainerComponent(abc.ABC):
    """Interface for composable functionality in the Trainer."""

    def __init__(self, args):
        self.args = args

    def on_train_begin(self, steps, logs):
        pass

    def on_train_end(self, steps, logs):
        pass

    def on_batch_begin(self, steps, logs):
        pass

    def on_batch_end(self, steps, logs):
        pass

    def on_epoch_begin(self, steps, epochs, logs):
        pass

    def on_epoch_end(self, steps, epochs, logs):
        pass

    def every(self, freq, steps):
        """Periodic-fire predicate: True when the window [steps, steps + K)
        of one call (``--steps-per-call K``) crosses a multiple of
        ``freq``, which is ``steps % freq == 0`` at one step per call."""
        k = getattr(self.trainer, "steps_per_call", 1)
        return (steps + k - 1) // freq > (steps - 1) // freq

    @property
    def writer(self) -> bool:
        """Whether this process writes files: rank 0 of a mesh (every rank
        runs the hooks, which may hold collectives), or the only one."""
        from ...parallel.mesh import is_writer
        return is_writer()

    @property
    def trainer(self):
        if not hasattr(self, "_trainer"):
            raise AttributeError(
                f"trainer not set on `{self.__class__.__name__}`")
        return self._trainer

    @trainer.setter
    def trainer(self, trainer):
        self._trainer = trainer

    @classmethod
    def add_args_to_parser(cls, parser):
        pass
