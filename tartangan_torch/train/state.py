"""The GAN train state.

Counterpart of ``tartangan_tpu/train/state.py:15-23``. The JAX package
threads one immutable pytree of parameters, batch statistics, EMA target
and optimizer states through a jitted step; here the same five objects
are modules and optimizers that the step updates in place: the
parameters and batch statistics live in ``g``/``d``, the EMA target's
parameters in ``g_target``, the Adam moments in ``opt_g``/``opt_d``.
``TextGANTrainState`` (:26-30) adds the text GAN's SkipGram embedding and
its SGD.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn


@dataclasses.dataclass
class GANTrainState:
    g: nn.Module
    g_target: nn.Module
    d: nn.Module
    opt_g: torch.optim.Adam
    opt_d: torch.optim.Adam


@dataclasses.dataclass
class TextGANTrainState(GANTrainState):
    embedding: nn.Module
    opt_emb: torch.optim.SGD
