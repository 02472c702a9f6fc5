"""GAN losses: BCE-with-logits, hinge and the R1 gradient penalty.

Counterparts of ``tartangan_tpu/models/losses.py:15-35`` and ``:36-51``;
the IQN loss is ``models/iqn.py::iqn_loss``. Each mean over the batch is
``parallel.collectives.batch_mean``: ``.mean()`` in one process, and this
rank's share of the global batch's mean under a data mesh.
"""
from __future__ import annotations

import torch

from ..parallel.collectives import batch_mean


def _f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32, or in float64 if it is float64."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def bce_with_logits(logits: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross entropy on raw logits, in the stable form
    max(x, 0) - x y + log1p(exp(-|x|)), in float32 (float64 for float64
    logits)."""
    logits = _f32(logits)
    labels = labels.to(logits.dtype)
    loss = (logits.clamp(min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))
    return batch_mean(loss)


def discriminator_hinge_loss(real: torch.Tensor, fake: torch.Tensor):
    """(mean relu(1 - real), mean relu(1 + fake)), in float32 (float64 for
    float64 logits)."""
    return (batch_mean(torch.relu(1.0 - _f32(real))),
            batch_mean(torch.relu(1.0 + _f32(fake))))


def generator_hinge_loss(fake: torch.Tensor) -> torch.Tensor:
    """-mean(fake), in float32 (float64 for float64 logits)."""
    return -batch_mean(_f32(fake))


def r1_gradient_penalty(d_apply_fn, real: torch.Tensor):
    """R1 penalty: the sum over pixels of |d D(x) / dx|^2, mean over the
    batch, in float32 (float64 for a float64 input). The gradient keeps its
    graph (``create_graph=True``), so the penalty differentiates again
    w.r.t. D's parameters. ``real`` must require grad. Returns (penalty,
    D's output). Where D's output is a tuple or list (the IQN head's
    prediction and loss, the InfoGAN heads' logits and codes), its first
    element is what the penalty differentiates, as the JAX trainers sum
    only the prediction (``train/iqn.py:56-60``, ``train/info.py:75-80``).
    """
    out = d_apply_fn(real)
    logits = out[0] if isinstance(out, (tuple, list)) else out
    (grads,) = torch.autograd.grad(_f32(logits).sum(), real,
                                   create_graph=True)
    penalty = batch_mean(
        _f32(grads).square().reshape(real.shape[0], -1).sum(1))
    return penalty, out
