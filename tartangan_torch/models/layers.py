"""Shared layer primitives: norms, activations, convs (NCHW).

Counterpart of ``tartangan_tpu/models/layers.py:24-109``. Submodules keep
the flax module names (``BatchNorm_0``, ``Conv_0``, ...) as attribute names,
so ``convert.py`` maps a flax tree onto a ``state_dict`` by renaming paths.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

ACTIVATIONS: dict[str, Callable] = {
    "relu": lambda x: F.leaky_relu(x, 0.2),
    "selu": F.selu,
    "elu": F.elu,
}


def activation_fn(name: str) -> Callable:
    return ACTIVATIONS[name]


class BatchNorm(nn.Module):
    """BatchNorm over all axes but the channel axis (dim 1).

    In train mode it normalizes with the batch mean and *biased* batch
    variance, as flax's ``nn.BatchNorm`` does; the running statistics are
    neither read nor written, so a forward pass never mutates the module
    (the JAX serve discards the batch-stat update as well). In eval mode it
    normalizes with the running statistics. Statistics and normalization are
    computed in float32 and the result is cast back to the input's dtype
    before the activation.
    """

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        if train:
            y = F.batch_norm(x.float(), None, None, self.weight, self.bias,
                             training=True, eps=self.eps)
        else:
            y = F.batch_norm(x.float(), self.running_mean, self.running_var,
                             self.weight, self.bias, training=False,
                             eps=self.eps)
        return y.to(x.dtype)


class NormAct(nn.Module):
    """The pre-activation ``norm -> activation`` pair used by every block."""

    def __init__(self, num_features: int, norm: str = "bn",
                 activation: str = "relu"):
        super().__init__()
        if norm == "bn":
            self.BatchNorm_0 = BatchNorm(num_features)
        elif norm != "id":
            raise ValueError(f"unknown norm '{norm}'")
        self.act = activation_fn(activation)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        if hasattr(self, "BatchNorm_0"):
            x = self.BatchNorm_0(x, train)
        return self.act(x)


def Conv(in_features: int, features: int, kernel: int = 3, *,
         use_bias: bool = True) -> nn.Conv2d:
    """Conv with SAME padding (odd kernels), NCHW."""
    return nn.Conv2d(in_features, features, kernel, padding=kernel // 2,
                     bias=use_bias)


def Dense(in_features: int, features: int, *,
          use_bias: bool = True) -> nn.Linear:
    return nn.Linear(in_features, features, bias=use_bias)
