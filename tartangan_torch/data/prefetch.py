"""Host batches and their copy to the device, one batch ahead.

``EpochBatcher`` is ``tartangan_tpu/data/prefetch.py:27-47``: the same
shuffles and crops from the same ``np.random.default_rng(seed)``, so a seed
gives the JAX trainer's host batches. ``prefetch_to_device`` takes the
place of the JAX package's ``jax.device_put`` pipeline: each batch is
copied from pinned host memory with ``non_blocking=True``, and the copy of
batch k + 1 is issued before batch k is handed out, so it overlaps the
step on batch k.
"""
from __future__ import annotations

from collections import deque

import numpy as np
import torch


class EpochBatcher:
    """Shuffled, drop-last batch stream over a dataset with a
    ``batch(indices, rng) -> np.uint8[N, ...]`` method."""

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 shuffle: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.shuffle = shuffle

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def epoch(self):
        n = len(self.dataset)
        order = self.rng.permutation(n) if self.shuffle else np.arange(n)
        for start in range(0, n - self.batch_size + 1, self.batch_size):
            yield self.dataset.batch(
                order[start:start + self.batch_size], self.rng
            )


def prefetch_to_device(iterator, device: torch.device, depth: int = 1):
    """Yield device batches while keeping ``depth`` copies in flight ahead
    of the consumer."""
    buf = deque()
    for host_batch in iterator:
        t = torch.from_numpy(np.ascontiguousarray(host_batch))
        if device.type == "cuda":
            t = t.pin_memory()
        buf.append(t.to(device, non_blocking=True))
        if len(buf) > depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()
