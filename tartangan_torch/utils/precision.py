"""Float32 means IEEE float32 on the card.

PyTorch lets cuDNN run float32 convolutions in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True), which keeps ten mantissa
bits. The port's entry points (the trainer, the generator apps) call
``full_float32`` when they are built, so their float32 runs are float32,
as the JAX package's are off a TPU.
"""
from __future__ import annotations

import torch


def full_float32() -> None:
    """Turn TF32 off for cuDNN's convolutions and cuBLAS's matmuls."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
