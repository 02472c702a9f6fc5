"""Shared layer primitives: norms, activations, convs (NCHW).

Counterpart of ``tartangan_tpu/models/layers.py:24-109``. Submodules keep
the flax module names (``BatchNorm_0``, ``Conv_0``, ...) as attribute names,
so ``convert.py`` maps a flax tree onto a ``state_dict`` by renaming paths.
"""
from __future__ import annotations

import contextlib
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
    variance, as flax's ``nn.BatchNorm`` does. The running statistics are
    updated only while ``update_stats`` is set (``update_batch_stats``
    sets it for the train step): ``ra = 0.9 ra + 0.1 batch`` for the mean
    and the biased variance, flax's momentum 0.9 (torch's 0.1), in float32
    (float64 for a float64 input) and outside autograd. ``F.batch_norm``'s
    own update would store the unbiased variance, so it is not used.
    Serving and sampling run train-mode forwards that leave the statistics
    untouched, as the JAX package discards its batch-stat update there. In eval mode it
    normalizes with the running statistics. Statistics and normalization
    are computed in float32 (float64 for a float64 input) and the result is
    cast back to the input's dtype before the activation.
    """

    momentum = 0.9  # flax convention: ra = momentum * ra + (1 - m) * batch

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.update_stats = False
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        if train:
            if self.update_stats:
                with torch.no_grad():
                    dims = [d for d in range(x.dim()) if d != 1]
                    var, mean = torch.var_mean(x32.detach(), dim=dims,
                                               correction=0)
                    m = self.momentum
                    self.running_mean.mul_(m).add_(mean, alpha=1 - m)
                    self.running_var.mul_(m).add_(var, alpha=1 - m)
            y = F.batch_norm(x32, None, None, self.weight, self.bias,
                             training=True, eps=self.eps)
        else:
            y = F.batch_norm(x32, self.running_mean, self.running_var,
                             self.weight, self.bias, training=False,
                             eps=self.eps)
        return y.to(x.dtype)


@contextlib.contextmanager
def update_batch_stats(*modules: nn.Module):
    """Within the block, every train-mode forward of a module in
    ``modules`` that keeps running statistics (an ``update_stats``
    attribute: ``BatchNorm``, the parity blocks' folded BatchNorm, the
    fused generator block) updates them (flax's ``mutable=
    ["batch_stats"]``)."""
    bns = [m for mod in modules for m in mod.modules()
           if hasattr(m, "update_stats")]
    for bn in bns:
        bn.update_stats = True
    try:
        yield
    finally:
        for bn in bns:
            bn.update_stats = False


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
