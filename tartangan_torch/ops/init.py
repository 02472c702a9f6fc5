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
def init_module_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every conv / linear parameter of ``module`` with torch's
    default init from ``generator``, in module order, and zero every
    attention ``gamma``."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5),
                                     generator=generator)
            if m.bias is not None:
                fan_in = m.weight[0].numel()
                bound = 1.0 / math.sqrt(max(fan_in, 1))
                nn.init.uniform_(m.bias, -bound, bound, generator=generator)
        gamma = getattr(m, "gamma", None)
        if isinstance(gamma, nn.Parameter):
            gamma.zero_()
    return module
