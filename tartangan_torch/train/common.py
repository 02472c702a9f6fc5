"""Shared pieces of the train steps.

Counterpart of ``tartangan_tpu/train/common.py`` (``normalize_batch``,
``make_adam``, ``ema_update``, ``bce_labels``). ``selu_reinit`` is not
ported: the trainer raises on ``--activation selu``.
"""
from __future__ import annotations

import torch
from torch import nn


def normalize_batch(batch_u8: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 NHWC -> NCHW ``dtype`` in [-1, 1], on the batch's device,
    divided by 127.5 in ``dtype`` as the reference does (``common.py:11-14``;
    torch rounds each op's result to bfloat16, as XLA does)."""
    x = batch_u8.permute(0, 3, 1, 2).to(dtype) / 127.5 - 1.0
    return x.contiguous()


def make_adam(params, lr: float) -> torch.optim.Adam:
    """Adam with betas (0, 0.999) and eps 1e-8: the same update as
    ``optax.adam(lr, b1=0.0, b2=0.999, eps=1e-8)``."""
    return torch.optim.Adam(params, lr=lr, betas=(0.0, 0.999), eps=1e-8)


@torch.no_grad()
def ema_update(new: nn.Module, target: nn.Module, factor: float) -> None:
    """target += factor * (new - target), for every parameter, in place
    (``optax.incremental_update``)."""
    for t, n in zip(target.parameters(), new.parameters()):
        t.lerp_(n, factor)


def bce_labels(batch_size: int, real_first: bool = True,
               device=None) -> torch.Tensor:
    """[1]*B + [0]*B adversarial labels, (2B, 1) float32."""
    ones = torch.ones((batch_size, 1), device=device)
    zeros = torch.zeros((batch_size, 1), device=device)
    return torch.cat([ones, zeros] if real_first else [zeros, ones], 0)
