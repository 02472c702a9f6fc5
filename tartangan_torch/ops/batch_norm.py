"""Train-mode BatchNorm in the activations' own dtype: the CUDA kernels
``csrc/batch_norm.cu`` and their plain PyTorch versions.

It replaces no TPU kernel: the JAX package leaves flax's ``BatchNorm`` to
XLA. On the card cuDNN's train-mode BatchNorm takes float32 NCHW, so a
bfloat16 activation was cast to float32 and back around it (two casts
forward, two backward), and its spatial kernels reduce each channel on a
few CTAs, which leaves most SMs idle where C is small. The kernels read the
activations in their own dtype, reduce each channel over a split grid that
fills the card, and round the result once (``csrc/batch_norm.cu``'s note).

``batch_norm(x, w, b, eps, running, momentum)`` over all dims but dim 1:
the batch mean and biased variance; ``running`` (the running mean and
variance, or None) are updated as ``ra = momentum ra + (1 - momentum)
batch`` outside autograd. Statistics and normalisation are float32 (the
plain version's float64 for float64) and y is rounded once to x's dtype.

- CPU tensors take ``batch_norm_plain``, the float32 arithmetic the layer
  has always had (``torch.var_mean`` and ``F.batch_norm``), which autograd
  differentiates itself. A caller that wants it for a tensor on the card (a
  float64 witness) calls it itself (``BatchNorm.use_kernel = False``).
- Other tensors take the kernels (float32 or bfloat16 x with at least 2
  dims, float32 parameters): they launch or raise. While a graph is built
  or the statistics update, through ``_BatchNorm``: its forward launches
  the statistics, merge (with the running update) and normalisation
  kernels; its backward is ``_BatchNormBackward(dy, x, w, mean, rstd)``,
  whose forward launches the backward's sum, merge and dx kernels and whose
  backward (R1's second-order terms) is ATen's ``batchnorm_double_backward``
  in plain float32 ops. Otherwise (serving, sampling) through the custom op
  ``tartangan::batch_norm``, so ``torch.export`` records it by name.

``batch_norm.launches`` counts the C calls (``utils/tracing.py::
count_launch``): one a forward, one a backward, each launching its three
kernels.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ..utils import tracing
from ..utils.precision import wide
from . import build
from .conv import _graph

MOMENTUM = 0.9  # flax's convention: ra = momentum * ra + (1 - m) * batch
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the split grid (``csrc/batch_norm.cu``): a channel's values are cut into
# runs of at least RUN_MIN values, enough for RUNS_PER_SM CTAs an SM over
# all channels
RUN_MIN, RUNS_PER_SM = 4096, 16


def _dims(x):
    return [d for d in range(x.dim()) if d != 1]


def batch_norm_plain(x, w, b, eps, running=None, momentum=MOMENTUM):
    """``batch_norm``'s function in plain torch ops, differentiable by
    autograd: (y, mean, biased var, rstd), the statistics detached."""
    x32 = x.to(wide(x.dtype))
    var, mean = torch.var_mean(x32.detach(), dim=_dims(x), correction=0)
    if running is not None:
        with torch.no_grad():
            for ra, batch in zip(running, (mean, var)):
                ra.mul_(momentum).add_(batch, alpha=1 - momentum)
    y = F.batch_norm(x32, None, None, w, b, training=True, eps=eps)
    return y.to(x.dtype), mean, var, torch.rsqrt(var + eps)


def batch_norm_backward_plain(dy, x, w, mean, rstd):
    """(dx, dw, db) of ``batch_norm`` at x, in plain torch ops: ATen's
    first-order backward in float32 (float64 for float64), dx rounded to
    x's dtype."""
    wt = wide(x.dtype)
    dx, dw, db = torch.ops.aten.native_batch_norm_backward(
        dy.to(wt), x.to(wt), w, None, None, mean, rstd, True, 0.0,
        [True, True, True])
    return dx.to(x.dtype), dw, db


def batch_norm_double_backward(ggx, ggw, ggb, dy, x, w, mean, rstd):
    """The derivatives (of dy, x, w) of ``<ggx, dx> + <ggw, dw> + <ggb,
    db>``, (dx, dw, db) the backward at (dy, x, w): ATen's train-mode
    ``batchnorm_double_backward`` in float32 (float64 for float64), each
    result in its input's dtype. ``ggx``, ``ggw``, ``ggb`` may be None.
    Its terms are gathered into per-channel coefficients of dy, x - mean
    and ggx, so each full-size result is one pass and few full-size
    temporaries are alive at once (R1 runs it at the largest
    activations). Autograd through ATen's ``native_batch_norm_backward``
    gives the same numbers, but a '512thin' step with R1 at B 64 on an H100
    took 75 ms more of device time and 3.0 GiB more memory that way."""
    wt = wide(x.dtype)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    dims = _dims(x)
    m = x.numel() // x.shape[1]

    def csum(t):
        return t.sum(dims, keepdim=True)

    g = dy.to(wt)
    xmu = x.to(wt) - mean.view(shape)
    r = rstd.view(shape)
    r3 = r * r * r
    wv = w.to(wt).view(shape)
    g_sum, gxmu_sum = csum(g), csum(g * xmu)
    # gx = kx (x - mean) + kg gc + ki ggc and gdy = dxm (x - mean) + di ggc
    # + ggb, gc and ggc dy and ggx centred per channel (as ATen's terms
    # are), the k's and d's per channel; gw from per-channel sums
    kx = kg = ki = dxm = di = gw = None
    if ggx is not None:
        ggi = ggx.to(wt)
        ggi_sum, ggixmu_sum = csum(ggi), csum(ggi * xmu)
        g_ggi_sum = csum(g * ggi)
        all_sub = (ggi_sum * g_sum / m - g_ggi_sum
                   + r * r * gxmu_sum * ggixmu_sum * (3.0 / m))
        kx = wv * r3 * all_sub / m
        kg = -wv * ggixmu_sum * r3 / m
        ki = -wv * gxmu_sum * r3 / m
        gw = (r * g_ggi_sum - r / m * g_sum * ggi_sum
              - r3 / m * gxmu_sum * ggixmu_sum).view(-1)
        di = wv * r
        dxm = -wv * r3 / m * ggixmu_sum
        ggc = ggi - ggi_sum / m
        del ggi
    if ggw is not None:
        ggw_ = ggw.to(wt).view(shape)
        kg = ggw_ * r if kg is None else kg + ggw_ * r
        kx = (-ggw_ * r3 * gxmu_sum / m if kx is None
              else kx - ggw_ * r3 * gxmu_sum / m)
        dxm = ggw_ * r if dxm is None else dxm + ggw_ * r
    gx = gdy = None
    if kx is not None:
        gx = xmu * kx
        gx.addcmul_(g - g_sum / m, kg)
        if ki is not None:
            gx.addcmul_(ggc, ki)
        gx = gx.to(x.dtype)
    if dxm is not None:
        gdy = xmu * dxm
        if di is not None:
            gdy.addcmul_(ggc, di)
    if ggb is not None:
        ggb_ = ggb.to(wt).view(shape)
        gdy = ggb_.expand_as(g).clone() if gdy is None else gdy.add_(ggb_)
    if gdy is not None:
        gdy = gdy.to(dy.dtype)
    return gdy, gx, None if gw is None else gw.to(w.dtype)


@tracing.counted
def batch_norm(x, w, b, eps=1e-5, running=None, momentum=MOMENTUM):
    """Train-mode BatchNorm of ``x`` over all dims but dim 1 with the
    per-channel scale ``w`` and offset ``b``, updating ``running`` (the
    running mean and variance) if given; ``batch_norm_plain`` for CPU
    tensors, else the kernels (float32 and bfloat16), which launch or
    raise."""
    if x.device.type == "cpu":
        return batch_norm_plain(x, w, b, eps, running, momentum)[0]
    if running is None and not _graph(x, w, b):
        return batch_norm_op(x, w, b, eps)
    rm, rv = (None, None) if running is None else running
    return _BatchNorm.apply(x, w, b, eps, rm, rv, momentum)


def _forward(x, w, b, eps, running_mean, running_var, momentum):
    """(y, mean, var, rstd): the kernels, or for CPU tensors the plain
    version."""
    if x.device.type == "cpu":
        running = None if running_mean is None else (running_mean,
                                                      running_var)
        return batch_norm_plain(x, w, b, eps, running, momentum)
    return _forward_kernel(x, w, b, eps, running_mean, running_var, momentum)


def _backward(dy, x, w, mean, rstd):
    """(dx, dw, db): the kernels, or for CPU tensors the plain version."""
    if x.device.type == "cpu":
        return batch_norm_backward_plain(dy, x, w, mean, rstd)
    return _backward_kernel(dy, x, w, mean, rstd)


class _BatchNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, eps, running_mean, running_var, momentum):
        y, mean, _, rstd = _forward(x, w, b, eps, running_mean, running_var,
                                    momentum)
        ctx.save_for_backward(x, w, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        dx, dw, db = _BatchNormBackward.apply(dy, *ctx.saved_tensors)
        return dx, dw, db, None, None, None, None


class _BatchNormBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dy, x, w, mean, rstd):
        ctx.save_for_backward(dy, x, w, mean, rstd)
        ctx.set_materialize_grads(False)
        return _backward(dy, x, w, mean, rstd)

    @staticmethod
    def backward(ctx, ggx, ggw, ggb):
        gdy, gx, gw = batch_norm_double_backward(ggx, ggw, ggb,
                                                 *ctx.saved_tensors)
        return gdy, gx, gw, None, None


@torch.library.custom_op("tartangan::batch_norm", mutates_args=(),
                         device_types="cuda")
def batch_norm_op(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """Train-mode BatchNorm without a gradient or a statistics update."""
    return _forward_kernel(x, w, b, eps, None, None, MOMENTUM)[0]


@batch_norm_op.register_kernel("cpu")
def _batch_norm_op_cpu(x, w, b, eps):
    return batch_norm_plain(x, w, b, eps)[0]


@batch_norm_op.register_fake
def _batch_norm_op_fake(x, w, b, eps):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


# ---------------------------------------------------------------- kernels
def splits(m: int, c: int, sms: int) -> int:
    """The runs each of ``c`` channels of ``m`` values is cut into: at
    least ``RUN_MIN`` values a run, and enough runs over all channels for
    ``RUNS_PER_SM`` CTAs on each of ``sms`` SMs."""
    return max(1, min(-(-m // RUN_MIN), -(-sms * RUNS_PER_SM // c)))


@functools.lru_cache(maxsize=None)
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _shape(x, *params):
    """(n, c, hw) of what the kernels take; raises on anything else: x
    float32 or bfloat16 on a CUDA device with at least 2 dims, at least one
    value a channel and fewer than 2**31, float32 (c,) parameters on the
    same device."""
    if x.device.type != "cuda":
        raise ValueError(f"the BatchNorm kernels run on cuda, not {x.device}")
    if x.dtype not in _DTYPES or any(p.dtype != torch.float32
                                     for p in params):
        raise TypeError("the BatchNorm kernels take float32 or bfloat16 x "
                        "and float32 parameters, got "
                        f"{[str(t.dtype) for t in (x, *params)]}")
    if x.dim() < 2:
        raise ValueError(f"BatchNorm takes (N, C, ...) x, got "
                         f"{tuple(x.shape)}")
    n, c = x.shape[:2]
    hw = math.prod(x.shape[2:])
    if not 0 < n * hw < 2 ** 31 or c > 65535:
        raise ValueError(f"the BatchNorm kernels take 1 to 2**31 - 1 values "
                         f"a channel and up to 65535 channels, got "
                         f"{tuple(x.shape)}")
    if any(p.shape != (c,) or p.device != x.device for p in params):
        raise ValueError(f"BatchNorm's parameters must be ({c},) on "
                         f"{x.device}, got {[tuple(p.shape) for p in params]}")
    return n, c, hw


def _call(fn, *args):
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"BatchNorm kernel launch failed: cudaError {err}")


def _forward_kernel(x, w, b, eps, running_mean, running_var, momentum):
    """(y, mean, var, rstd) by the forward kernels, the running statistics
    updated in place if given."""
    running = () if running_mean is None else (running_mean, running_var)
    n, c, hw = _shape(x, w, b, *running)
    x, w, b = x.contiguous(), w.contiguous(), b.contiguous()
    if not all(t.is_contiguous() for t in running):
        raise ValueError("the running statistics must be contiguous")
    s = splits(n * hw, c, _sms(x.device))
    y = torch.empty_like(x)
    buf = torch.empty(3 * c + 2 * c * s + 3 * c, dtype=torch.float32,
                      device=x.device)
    mean, var, rstd = buf[:3 * c].view(3, c)
    rm, rv = (None, None) if not running else (running_mean.data_ptr(),
                                               running_var.data_ptr())
    with torch.cuda.device(x.device):
        _call(build.load("batch_norm").tt_batch_norm_fwd,
              x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
              mean.data_ptr(), var.data_ptr(), rstd.data_ptr(), rm, rv,
              buf[3 * c:].data_ptr(), n, c, hw, s, eps, momentum,
              _DTYPES[x.dtype], torch.cuda.current_stream().cuda_stream)
    tracing.count_launch(batch_norm, x.dtype)
    return y, mean, var, rstd


def _backward_kernel(dy, x, w, mean, rstd):
    """(dx, dw, db) by the backward kernels."""
    n, c, hw = _shape(x, w, mean, rstd)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must be {tuple(x.shape)} of {x.dtype} on "
                         f"{x.device}, got {tuple(dy.shape)} of {dy.dtype} "
                         f"on {dy.device}")
    dy, x, w = dy.contiguous(), x.contiguous(), w.contiguous()
    s = splits(n * hw, c, _sms(x.device))
    dx = torch.empty_like(x)
    dw, db = torch.empty((2, c), dtype=torch.float32, device=x.device)
    work = torch.empty(2 * c * s + 3 * c, dtype=torch.float32,
                       device=x.device)
    with torch.cuda.device(x.device):
        _call(build.load("batch_norm").tt_batch_norm_bwd,
              dy.data_ptr(), x.data_ptr(), w.data_ptr(), mean.data_ptr(),
              rstd.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
              work.data_ptr(), n, c, hw, s, _DTYPES[x.dtype],
              torch.cuda.current_stream().cuda_stream)
    tracing.count_launch(batch_norm, x.dtype)
    return dx, dw, db
