"""Metric-scalar coercion shared by logs consumers.

Counterpart of ``tartangan_tpu/utils/scalars.py``: a logged metric entry is
a python number or a 0-d tensor, possibly on the card; ``float`` of it is
the host sync, so callers convert only when they actually emit.
"""
from __future__ import annotations

import numpy as np
import torch


def last_scalar(value) -> float:
    """Latest per-step value of a logged metric entry: a python number, a
    0-d tensor or array, or a stacked 1-d chunk (last element)."""
    if isinstance(value, torch.Tensor):
        value = value.detach().float().cpu().numpy()
    arr = np.ravel(np.asarray(value))
    return float(arr[-1])
