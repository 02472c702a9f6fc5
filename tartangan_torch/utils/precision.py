"""The port's numerics: IEEE float32 on the card, and the compute dtype.

PyTorch lets cuDNN run float32 convolutions in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True), which keeps ten mantissa
bits. The port's entry points (the trainer, the generator apps) call
``full_float32`` when they are built, so their float32 runs are float32,
as the JAX package's are off a TPU.

``--dtype bf16`` computes in bfloat16 with float32 parameters, as flax's
``dtype`` / ``param_dtype`` split does (``tartangan_tpu/models/layers.py``).
``Generator`` and ``Discriminator`` cast their input to the compute dtype;
every layer then computes in its input's dtype and casts its float32
weights at use (``apply_in_dtype``). Casts are explicit, not
``torch.autocast``, so values are rounded where flax rounds them.
"""
from __future__ import annotations

import functools

import torch

REDUCED = (torch.bfloat16, torch.float16)


def full_float32() -> None:
    """Turn TF32 off for cuDNN's convolutions and cuBLAS's matmuls."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_dtype(name: str) -> torch.dtype:
    """``--dtype`` -> compute dtype. 'auto' is bfloat16 on a TPU and float32
    elsewhere in the JAX package (``train/trainer.py:41-45``); the port
    never runs on a TPU, so 'auto' is float32."""
    return {"auto": torch.float32, "f32": torch.float32,
            "bf16": torch.bfloat16}[name]


def wide(dtype: torch.dtype) -> torch.dtype:
    """The dtype that statistics and kernel accumulators use: float32, or
    float64 for float64."""
    return torch.promote_types(dtype, torch.float32)


@functools.lru_cache(maxsize=None)
def rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``: JAX multiplies a bfloat16 array by a
    Python float in bfloat16 (leaky-relu's 0.2 becomes 0.2001953125)."""
    return float(torch.tensor(value, dtype=dtype))


def apply_in_dtype(op, x, w, b=None, **kwargs):
    """``op(x, w, b, **kwargs)`` (``F.conv2d``, ``F.linear``) in ``x``'s
    dtype, ``w`` and ``b`` cast to it at use. In a reduced dtype the bias is
    added after ``op``'s own rounding, as flax's ``Conv`` and ``Dense`` add
    it; in float32 and float64 ``op`` takes it.

    On the CPU a reduced dtype's ``op`` runs in float32 on the rounded
    operands and its result is rounded once: the same values as a
    reduced-precision op that accumulates in float32, and its derivatives
    the same way. oneDNN's bfloat16 convolution gives wrong values where the
    kernel spans the padded input (measured: over 100 % of the norm off);
    autograd's second derivative of a convolution (R1's) is such a
    convolution."""
    dt = x.dtype
    w = w.to(dt)
    if dt in REDUCED and x.device.type == "cpu":
        y = op(x.float(), w.float(), None, **kwargs).to(dt)
    elif b is not None and dt in REDUCED:
        y = op(x, w, None, **kwargs)
    else:
        return op(x, w, None if b is None else b.to(dt), **kwargs)
    if b is None:
        return y
    return y + b.to(dt).reshape(-1, *(1,) * (y.dim() - 2))
