"""Shared pieces of the train steps.

Counterpart of ``tartangan_tpu/train/common.py`` (``normalize_batch``,
``make_adam``, ``ema_update``, ``selu_reinit``, ``bce_labels``).
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.init import selu_normal


def normalize_batch(batch_u8: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 NHWC -> NCHW ``dtype`` in [-1, 1], on the batch's device,
    divided by 127.5 in ``dtype`` as the reference does (``common.py:11-14``;
    torch rounds each op's result to bfloat16, as XLA does)."""
    x = batch_u8.permute(0, 3, 1, 2).to(dtype) / 127.5 - 1.0
    return x.contiguous()


def make_adam(params, lr: float) -> torch.optim.Adam:
    """Adam with betas (0, 0.999) and eps 1e-8: the same update as
    ``optax.adam(lr, b1=0.0, b2=0.999, eps=1e-8)``. For CUDA parameters it
    is capturable: its step count and its rate are tensors on the device,
    so a CUDA graph captures the update reading them (``train/multi.py``)
    and a rate set with ``param_groups[i]["lr"].fill_`` holds in the
    replays."""
    params = list(params)
    on_card = bool(params) and params[0].is_cuda
    if on_card:
        lr = torch.tensor(float(lr), device=params[0].device)
    return torch.optim.Adam(params, lr=lr, betas=(0.0, 0.999), eps=1e-8,
                            capturable=on_card)


@torch.no_grad()
def ema_update(new: nn.Module, target: nn.Module, factor: float) -> None:
    """target += factor * (new - target), for every parameter, in place
    (``optax.incremental_update``)."""
    for t, n in zip(target.parameters(), new.parameters()):
        t.lerp_(n, factor)


@torch.no_grad()
def selu_reinit(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialize for SELU (``tartangan_tpu/train/common.py:44-58``):
    every parameter of 2 or more dimensions from N(0, 1/fan_in), in module
    order from ``generator``; every parameter of 1 or fewer dimensions
    (biases, BatchNorm's scale, attention's ``gamma``) zeroed. fan_in is
    the JAX package's count in flax's layout, all dimensions but the last
    (out features), which is all but the first in torch's out-first
    layout. Buffers stay as they are."""
    for p in module.parameters():
        if p.dim() <= 1:
            p.zero_()
        else:
            p.copy_(selu_normal(p[0].numel())(p.shape, generator))
    return module


def bce_labels(batch_size: int, real_first: bool = True,
               device=None) -> torch.Tensor:
    """[1]*B + [0]*B adversarial labels, (2B, 1) float32."""
    ones = torch.ones((batch_size, 1), device=device)
    zeros = torch.zeros((batch_size, 1), device=device)
    return torch.cat([ones, zeros] if real_first else [zeros, ones], 0)
