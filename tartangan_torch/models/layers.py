"""Shared layer primitives: norms, activations, convs (NCHW; NCL in 1-D).

Counterpart of ``tartangan_tpu/models/layers.py:24-122``. Submodules keep
the flax module names (``BatchNorm_0``, ``Conv_0``, ...) as attribute names,
so ``convert.py`` maps a flax tree onto a ``state_dict`` by renaming paths.

Parameters are float32; every layer computes in its input's dtype (the
compute dtype, which ``Generator`` and ``Discriminator`` set), as flax's
``dtype`` / ``param_dtype`` split does: ``Conv`` and ``Dense`` cast their
weights at use, ``BatchNorm`` reduces and normalizes in float32 and casts
back, and the activation runs on the cast value
(``utils/precision.py``).

Under a data mesh (``parallel/``) ``BatchNorm`` normalizes with the moments
of the global batch, and under ``--tp`` a conv or dense layer whose
weight is sharded computes its slice of the output channels and gathers
them (``parallel/tp.py``); without a mesh both are as they were.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import collectives as C
from ..utils.precision import apply_in_dtype, rounded


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """leaky-relu with slope 0.2 rounded to ``x``'s dtype, as flax's
    ``nn.leaky_relu(x, 0.2)`` multiplies in ``x``'s dtype."""
    return F.leaky_relu(x, rounded(0.2, x.dtype))


ACTIVATIONS: dict[str, Callable] = {
    "relu": leaky_relu,
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
    untouched, as the JAX package discards its batch-stat update there.
    Under a data mesh the train-mode moments are the global batch's
    (``collectives.batch_moments``, ``mean(x^2) - mean^2`` as flax's),
    so every rank normalizes and stores the same statistics. In eval mode it
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
        if train and C.data_reducing() is not None:
            y = self._global_batch_norm(x32)
        elif train:
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

    def _global_batch_norm(self, x32):
        c = x32.shape[1]
        mean, var = C.batch_moments(x32.movedim(1, -1).reshape(-1, c))
        if self.update_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean.detach(), alpha=1 - m)
                self.running_var.mul_(m).add_(var.detach(), alpha=1 - m)
        shape = (1, c) + (1,) * (x32.dim() - 2)
        inv = torch.rsqrt(var + self.eps) * self.weight
        return ((x32 - mean.view(shape)) * inv.view(shape)
                + self.bias.view(shape))


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


class PixelNorm(nn.Module):
    """x / sqrt(mean(x^2 over channels) + eps), the channels being dim 1
    (``layers.py:112-120``, whose NHWC channels are the last axis)."""

    def __init__(self, eps: float = 1e-8):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x / torch.sqrt(x.square().mean(dim=1, keepdim=True) + self.eps)


def _column_parallel(layer, op, x, dim, **kwargs):
    """A layer whose weight holds this rank's output channels (``--tp``):
    its slice of ``op``'s output from the whole input, gathered along
    ``dim`` over the model group, plus the bias."""
    y = apply_in_dtype(op, C.tp_copy(x, layer.tp), layer.weight, None,
                       **kwargs)
    y = C.tp_gather(y, dim, layer.tp)
    if layer.bias is None:
        return y
    shape = [1] * y.dim()
    shape[dim] = -1
    return y + layer.bias.to(y.dtype).view(shape)


def full_weight(layer: nn.Module) -> torch.Tensor:
    """``layer.weight`` whole: gathered over the model group when ``--tp``
    shards it (for code that packs it, as the parity blocks do)."""
    if getattr(layer, "tp", None) is None:
        return layer.weight
    return C.tp_gather(layer.weight, 0, layer.tp)


class _Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in its input's dtype (flax's ``Conv`` with ``dtype``)."""
    tp = None  # the model group when --tp shards the weight

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            return _column_parallel(self, F.conv2d, x, 1,
                                    padding=self.padding)
        return apply_in_dtype(F.conv2d, x, self.weight, self.bias,
                              padding=self.padding)


class _Conv1d(nn.Conv1d):
    """``nn.Conv1d`` in its input's dtype (the text GAN's NCL convs)."""
    tp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            return _column_parallel(self, F.conv1d, x, 1,
                                    padding=self.padding)
        return apply_in_dtype(F.conv1d, x, self.weight, self.bias,
                              padding=self.padding)


class _Linear(nn.Linear):
    """``nn.Linear`` in its input's dtype (flax's ``Dense`` with ``dtype``)."""
    tp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            return _column_parallel(self, F.linear, x, -1)
        return apply_in_dtype(F.linear, x, self.weight, self.bias)


def Conv(in_features: int, features: int, kernel: int = 3, *,
         use_bias: bool = True, ndim: int = 2) -> nn.Module:
    """Conv with SAME padding (odd kernels), NCHW, or NCL with ``ndim=1``
    (the JAX package's NLC ``Conv(..., ndim=1)``, ``layers.py:75``; torch's
    default init, whose bias bound has fan_in = in * kernel)."""
    cls = {1: _Conv1d, 2: _Conv2d}[ndim]
    return cls(in_features, features, kernel, padding=kernel // 2,
               bias=use_bias)


def Dense(in_features: int, features: int, *,
          use_bias: bool = True) -> nn.Linear:
    return _Linear(in_features, features, bias=use_bias)


class AutoNamed(nn.Module):
    """A model whose submodules take flax's auto-names, their class and a
    count (``SharedConvBlock_1``, ``SelfAttention2d_0``), or a name given,
    so a ``state_dict`` is the flax tree by path; ``layers`` lists them in
    call order."""

    def __init__(self):
        super().__init__()
        self.layers = []

    def _add(self, module: nn.Module, name: str | None = None) -> None:
        if name is None:
            kind = type(module).__name__
            count = sum(n.startswith(kind + "_") for n in self.layers)
            name = f"{kind}_{count}"
        self.add_module(name, module)
        self.layers.append(name)
