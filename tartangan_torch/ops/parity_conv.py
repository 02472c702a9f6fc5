"""Fused merged-tap parity convolution, generator side: the CUDA kernel
``csrc/parity_conv.cu`` (K3) and its plain PyTorch version.

Counterpart of ``tartangan_tpu/ops/pallas/parity_conv.py``:
``fused_parity_conv`` (:167) with the kernel of ``_fused_conv_impl`` (:130).
Layout is the reference's NHWC at the public functions: ``mode='up'`` takes
the small-resolution (B, H, W, cin) tensor and gives conv3x3-over-nearest-up2
as a (B, H, W, 4*cout) parity stack; ``mode='full'`` takes a parity stack
(B, H, W, 4*cin) and gives the full-resolution conv3x3 as a parity stack.
``w_raw`` is the block's own (cout, cin, 3, 3) OIHW conv weight and ``b``
its (cout,) bias.

``fused_parity_conv`` is a ``torch.autograd.Function``: its forward is the
kernel (``merged_tap_conv``) plus ``tile(b, 4)``; its backward is the
vector-Jacobian product of the 3x3-packed form (``_reference_form``), as in
the reference. That is first order only, which is why only the generator's
parity blocks use it (the R1 penalty differentiates D twice).

For CUDA tensors ``merged_tap_conv`` launches the kernel or raises; for CPU
tensors it runs ``fused_parity_conv_plain`` (``conv_parity2`` with the 2x2
packers). ``merged_tap_conv.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import build
from .parity import (
    conv2d,
    conv_parity2,
    pack_full_conv,
    pack_full_conv2,
    pack_up_conv,
    pack_up_conv2,
)

_COUNT_LOCK = threading.Lock()
_MODES = ("up", "full")


def _check(x, w_raw, cout, mode):
    if mode not in _MODES:
        raise ValueError(f"mode must be 'up' or 'full', got {mode!r}")
    if x.dim() != 4 or w_raw.dim() != 4 or w_raw.shape[2:] != (3, 3):
        raise ValueError("merged-tap conv takes NHWC x and a (cout, cin, 3, 3)"
                         f" weight, got {tuple(x.shape)}, {tuple(w_raw.shape)}")
    cin = w_raw.shape[1]
    if w_raw.shape[0] != cout or x.shape[3] != (4 * cin if mode == "full"
                                                else cin):
        raise ValueError(f"merged-tap conv '{mode}': x {tuple(x.shape)} does "
                         f"not fit the weight {tuple(w_raw.shape)}")
    if x.dtype != torch.float32 or w_raw.dtype != torch.float32:
        raise TypeError("the merged-tap parity conv takes float32, got "
                        f"{x.dtype}, {w_raw.dtype}")
    if x.device != w_raw.device:
        raise ValueError("x and the weight must be on one device")


def _pack2(w_raw, mode):
    """The (4*cout, Ci, 2, 2) OIHW merged-tap weights of ``mode``."""
    return (pack_up_conv2 if mode == "up" else pack_full_conv2)(w_raw)


def fused_parity_conv_plain(x, w_raw, cout, mode):
    """The kernel's function in plain torch ops: ``conv_parity2`` with the
    2x2 packers, NHWC in and out, no bias."""
    y = conv_parity2(x.permute(0, 3, 1, 2), _pack2(w_raw, mode), cout)
    return y.permute(0, 2, 3, 1)


def _count(fn):
    with _COUNT_LOCK:
        fn.launches += 1


def merged_tap_conv(x, w_raw, cout, mode):
    """(B, H, W, 4*cout) merged-tap parity conv of NHWC ``x``, no bias: K3
    for CUDA tensors, ``fused_parity_conv_plain`` for CPU tensors."""
    _check(x, w_raw, cout, mode)
    if x.device.type == "cpu":
        return fused_parity_conv_plain(x, w_raw, cout, mode)
    if x.device.type != "cuda":
        raise ValueError(f"merged_tap_conv runs on cuda or cpu, not {x.device}")
    b, h, w, ci = x.shape
    x = x.contiguous()
    # (4*cout, Ci, 2, 2) OIHW -> (2, 2, Ci, 4*cout), the kernel's layout
    w2 = _pack2(w_raw.detach(), mode).permute(2, 3, 1, 0).contiguous()
    out = torch.empty((b, h, w, 4 * cout), dtype=x.dtype, device=x.device)
    fn = build.load("parity_conv").tt_parity_conv
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w2.data_ptr(), out.data_ptr(), b, h, w, ci,
                 cout, int(mode == "full"), stream)
    if err != 0:
        raise RuntimeError(f"parity_conv kernel launch failed: cudaError {err}")
    _count(merged_tap_conv)
    return out


def _reference_form(x, w_raw, b, cout, mode):
    """The 3x3-packed form of the same conv, NHWC, with the bias: the
    function whose vector-Jacobian product is the backward."""
    pack = pack_up_conv if mode == "up" else pack_full_conv
    y = conv2d(x.permute(0, 3, 1, 2), pack(w_raw), b.repeat(4), padding=1)
    return y.permute(0, 2, 3, 1)


class _FusedParityConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_raw, b, cout, mode):
        ctx.save_for_backward(x, w_raw, b)
        ctx.cout, ctx.mode = cout, mode
        return merged_tap_conv(x, w_raw, cout, mode) + b.repeat(4)

    @staticmethod
    def backward(ctx, g):
        _, vjp = torch.func.vjp(
            lambda x, w, b: _reference_form(x, w, b, ctx.cout, ctx.mode),
            *ctx.saved_tensors)
        return (*vjp(g.contiguous()), None, None)


def fused_parity_conv(x, w_raw, b, cout, mode):
    """Merged-tap parity conv with the bias, differentiable once: the kernel
    forward (or its plain version on the CPU), the 3x3-packed form's
    vector-Jacobian product backward."""
    return _FusedParityConv.apply(x, w_raw, b, cout, mode)


merged_tap_conv.launches = 0
