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
kernel (``merged_tap_conv``, which adds ``tile(b, 4)`` as it stores); its
backward is the vector-Jacobian product of the 3x3-packed form
(``_reference_form``), as in the reference. That is first order only, which is why only the generator's
parity blocks use it (the R1 penalty differentiates D twice).

For CUDA tensors ``merged_tap_conv`` launches the kernel or raises; for CPU
tensors it runs ``fused_parity_conv_plain`` (``conv_parity2`` with the 2x2
packers). ``merged_tap_conv.launches`` counts kernel launches
(``utils/tracing.py::count_launch``).

x is float32 or bfloat16 (the compute dtype); the weight and the bias are
the float32 parameters. In bfloat16 the kernel rounds where the TPU kernel
does: the merged taps are summed in float32 and rounded to bfloat16 once
(``parity_conv.py:190``), the products accumulate in float32, the sum is
rounded to bfloat16 as it is stored (``:126``), and the bias, rounded to
bfloat16, is added to it in bfloat16 (``:193``).
"""
from __future__ import annotations

import torch

from ..utils import tracing
from ..utils.precision import wide
from . import build
from .remat import reuse
from .parity import (
    conv2d,
    conv_parity2,
    pack_full_conv,
    pack_full_conv2,
    pack_up_conv,
    pack_up_conv2,
)

_MODES = ("up", "full")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the library of each dtype's instances (``ops/build.py``)
_LIBRARY = {torch.float32: "parity_conv",
            torch.bfloat16: "parity_conv_bf16"}


def _check(x, w_raw, cout, mode, bias):
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
    ts = (x, w_raw) if bias is None else (x, w_raw, bias)
    if x.dtype not in _DTYPES or any(t.dtype != torch.float32
                                     for t in ts[1:]):
        raise TypeError("the merged-tap parity conv takes float32 or "
                        "bfloat16 x and a float32 weight and bias, got "
                        f"{[str(t.dtype) for t in ts]}")
    if any(t.device != x.device for t in ts):
        raise ValueError("x, the weight and the bias must be on one device")
    if bias is not None and bias.shape != (cout,):
        raise ValueError(f"the bias must be ({cout},), got {tuple(bias.shape)}")


def _pack2(w_raw, mode):
    """The (4*cout, Ci, 2, 2) OIHW merged-tap weights of ``mode``."""
    return (pack_up_conv2 if mode == "up" else pack_full_conv2)(w_raw)


def fused_parity_conv_plain(x, w_raw, cout, mode, bias=None):
    """The kernel's function in plain torch ops: ``conv_parity2`` with the
    2x2 packers, NHWC in and out, plus ``tile(bias, 4)`` if given, rounded
    where the kernel rounds: the packed weights to ``x``'s dtype, the conv
    accumulated in float32 (float64 for float64) and rounded to ``x``'s
    dtype, then the bias added in that dtype."""
    dt, wt = x.dtype, wide(x.dtype)
    w2 = _pack2(w_raw, mode).to(dt).to(wt)
    y = conv_parity2(x.permute(0, 3, 1, 2).to(wt), w2, cout).to(dt)
    if bias is not None:
        y = y + bias.to(dt).repeat(4)[None, :, None, None]
    return y.permute(0, 2, 3, 1)


@tracing.counted
def merged_tap_conv(x, w_raw, cout, mode, bias=None):
    """(B, H, W, 4*cout) merged-tap parity conv of NHWC ``x`` plus
    ``tile(bias, 4)`` if given: K3 for CUDA tensors (one launch, the bias
    added as it stores), ``fused_parity_conv_plain`` for CPU tensors.
    Under ``--remat-policy convs`` a block's recomputation takes the
    forward's output back and launches nothing (``ops/remat.py::reuse``)."""
    _check(x, w_raw, cout, mode, bias)
    return reuse(lambda: _merged_tap_conv(x, w_raw, cout, mode, bias))


def _merged_tap_conv(x, w_raw, cout, mode, bias):
    if x.device.type == "cpu":
        return fused_parity_conv_plain(x, w_raw, cout, mode, bias)
    if x.device.type != "cuda":
        raise ValueError(f"merged_tap_conv runs on cuda or cpu, not {x.device}")
    b, h, w, ci = x.shape
    x = x.contiguous()
    # (4*cout, Ci, 2, 2) OIHW -> (2, 2, Ci, 4*cout), the kernel's layout,
    # float32 holding the taps rounded to x's dtype
    w2 = _pack2(w_raw.detach(), mode).to(x.dtype).float()
    w2 = w2.permute(2, 3, 1, 0).contiguous()
    bias = None if bias is None else bias.detach().contiguous()
    out = torch.empty((b, h, w, 4 * cout), dtype=x.dtype, device=x.device)
    fn = build.load(_LIBRARY[x.dtype]).tt_parity_conv
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w2.data_ptr(),
                 None if bias is None else bias.data_ptr(), out.data_ptr(),
                 b, h, w, ci, cout, int(mode == "full"), _DTYPES[x.dtype],
                 stream)
    if err != 0:
        raise RuntimeError(f"parity_conv kernel launch failed: cudaError {err}")
    tracing.count_launch(merged_tap_conv, x.dtype)
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
        return merged_tap_conv(x, w_raw, cout, mode, bias=b)

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
