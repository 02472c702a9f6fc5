"""Parameter init, from an explicit ``torch.Generator``.

``tartangan_tpu/ops/init.py`` imitates torch's default ``nn.Conv2d`` /
``nn.Linear`` init: weights ``kaiming_uniform_(a=sqrt(5))``, i.e.
``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``, and biases
``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``. So the port reuses torch's own
formula, drawn from the caller's generator. ``SelfAttention2d.gamma`` starts
at 0 (``models/attention.py`` in both packages).
"""
from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def default_init_(weight: torch.Tensor, bias, generator: torch.Generator):
    """torch's default ``nn.Conv2d`` / ``nn.Linear`` init of one weight
    (out first) and its bias (or None), drawn from ``generator``."""
    nn.init.kaiming_uniform_(weight, a=math.sqrt(5), generator=generator)
    if bias is not None:
        bound = 1.0 / math.sqrt(max(weight[0].numel(), 1))
        nn.init.uniform_(bias, -bound, bound, generator=generator)


@torch.no_grad()
def init_module_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every conv / linear parameter of ``module`` with torch's
    default init from ``generator``, in module order (a module with an
    ``init_parameters_(generator)`` method draws its own), and zero every
    attention ``gamma``."""
    for m in module.modules():
        init = getattr(m, "init_parameters_", None)
        if init is not None:  # a module with flat parameters of its own
            init(generator)
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            default_init_(m.weight, m.bias, generator)
        gamma = getattr(m, "gamma", None)
        if isinstance(gamma, nn.Parameter):
            gamma.zero_()
    return module
