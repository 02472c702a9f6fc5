"""Live training progress line.

A copy of ``tartangan_tpu/train/progress.py``. The reference drives a
tqdm bar with a per-batch metrics postfix (reference
trainers/trainer.py:95-104) and swaps in a newline-per-update variant for
k8s log collectors (trainers/tqdm_newlines.py:6-26,
``--log-progress-newlines``).

Refreshing the postfix every batch would force a device->host sync on the
metric scalars each step and stall the launch queue, so the line refreshes
every ``--log-iters`` steps — the hot loop stays sync-free. Default mode rewrites one line in place (carriage return);
newline mode emits a full line per refresh so dumb log pipes stay readable.
"""
from __future__ import annotations

import sys
import time


class ProgressLine:
    """In-place (or line-per-update) epoch progress + metrics postfix."""

    def __init__(self, newlines: bool = False, stream=None):
        self.newlines = newlines
        self.stream = stream if stream is not None else sys.stdout
        self._dirty = False
        self._width = 0

    def epoch_begin(self, epoch: int, num_batches: int):
        self.epoch = epoch
        self.num_batches = num_batches
        self.batch = 0
        self._t0 = time.time()
        self._images = 0

    def update(self, steps: int, batch: int, batch_size: int, metrics):
        """Refresh the line. ``metrics`` maps name -> device scalar; the
        float() conversions here are the only host syncs and happen at the
        caller's --log-iters cadence."""
        self.batch = batch
        self._images = batch * batch_size
        rate = self._images / max(time.time() - self._t0, 1e-9)
        from ..utils.scalars import last_scalar
        postfix = " ".join(
            f"{k}={last_scalar(v):.4f}" for k, v in metrics.items())
        line = (f"epoch {self.epoch} [{batch}/{self.num_batches}] "
                f"step {steps} {rate:.1f} img/s {postfix}")
        if self.newlines:
            self.stream.write(line + "\n")
        else:
            pad = max(self._width - len(line), 0)
            self.stream.write("\r" + line + " " * pad)
            self._width = len(line)
            self._dirty = True
        self.stream.flush()

    def epoch_end(self):
        """Terminate the in-place line so following prints start clean."""
        if self._dirty:
            self.stream.write("\n")
            self.stream.flush()
            self._dirty = False
            self._width = 0
