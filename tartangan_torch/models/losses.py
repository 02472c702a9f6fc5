"""GAN losses: BCE-with-logits and the R1 gradient penalty.

Counterparts of ``tartangan_tpu/models/losses.py:15-21`` and ``:36-51``.
"""
from __future__ import annotations

import torch


def bce_with_logits(logits: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross entropy on raw logits, in the stable form
    max(x, 0) - x y + log1p(exp(-|x|)), in float32."""
    logits = logits.float()
    labels = labels.float()
    loss = (logits.clamp(min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))
    return loss.mean()


def r1_gradient_penalty(d_apply_fn, real: torch.Tensor):
    """R1 penalty: the sum over pixels of |d D(x) / dx|^2, mean over the
    batch, in float32. The gradient keeps its graph
    (``create_graph=True``), so the penalty differentiates again w.r.t.
    D's parameters. ``real`` must require grad. Returns (penalty, logits).
    """
    logits = d_apply_fn(real)
    (grads,) = torch.autograd.grad(logits.float().sum(), real,
                                   create_graph=True)
    penalty = grads.float().square().reshape(real.shape[0], -1).sum(1).mean()
    return penalty, logits
