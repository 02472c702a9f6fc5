"""Fused residual generator up-block in the parity domain: the CUDA kernels
``csrc/gblock.cu`` (K4 ``gblock_a``, K5 ``gblock_b``) and their plain
PyTorch versions.

Counterpart of ``tartangan_tpu/ops/pallas/gblock.py``: ``fused_gblock``
(:406), ``_fused_gblock_fwd_impl`` (:275) with ``_kernel_a`` (:196) and
``_kernel_b`` (:234), and ``_gblock_reference`` (:358). The block, in the
training configuration of every G tower block (pre-activation, nearest-2x
upsample, BatchNorm with batch statistics, leaky-relu 0.2):

    h   = act(bn1(x))
    out = conv3(act(bn2(conv3(up2(h), w1) + b1)), w2) + b2 + up2(x) @ wp + bp

computed without the upsampled tensors: K4 gives conv1 as a parity stack
y1p (B, H, W, 4*Cout) and the sums of y1p and y1p^2 for bn2's statistics;
K5 gives the output as a parity stack, shortcut and biases included; one
``depth_to_space`` restores the layout.

Layout is the reference's NHWC for x and the outputs; the weights are the
port's: ``w1`` (Cout, Cin, 3, 3) and ``w2`` (Cout, Cout, 3, 3) OIHW, ``wp``
(Cin, Cout) as the reference's ``x @ wp`` (the identity when Cin == Cout),
``b1``, ``b2``, ``bp``, ``s1``/``o1`` (Cin) and ``s2``/``o2`` (Cout)
BatchNorm scales and offsets, all float32.

``fused_gblock`` is a ``torch.autograd.Function``: the forward runs
``_moments`` -> K4 -> the statistics folded over the parity axis -> K5 ->
``depth_to_space``; the backward is the vector-Jacobian product of
``_gblock_reference``, recomputed (first order only, so G-side only). For
CUDA tensors ``gblock_a``/``gblock_b`` launch the kernels or raise; for CPU
tensors they run ``gblock_a_plain``/``gblock_b_plain``. ``gblock_a.launches``
and ``gblock_b.launches`` count kernel launches.
"""
from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from . import build
from .parity import (
    conv2d,
    conv_parity2,
    depth_to_space,
    pack_full_conv2,
    pack_up_conv2,
)
from .resize import upsample_nearest_2x

BN_EPS = 1e-5
PARAMS = ("w1", "b1", "w2", "b2", "wp", "bp", "s1", "o1", "s2", "o2")
_COUNT_LOCK = threading.Lock()


def _act(x):
    """leaky-relu(0.2), what this codebase's 'relu' means."""
    return F.leaky_relu(x, 0.2)


def _moments(x):
    """Biased per-channel mean and variance over all but the last axis,
    float32, as ``mean(x^2) - mean^2`` (the reference's ``_moments``)."""
    x32 = x.float().reshape(-1, x.shape[-1])
    mean = x32.mean(0)
    return mean, x32.square().mean(0) - mean.square()


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


def gblock_a_plain(x, m1, v1, s1, o1, w1, b1):
    """K4's function in plain torch ops: y1p = parity-up conv1(act(bn1(x)))
    + tile(b1, 4), NHWC (B, H, W, 4*Cout), and (2, 4*Cout) float32 sums of
    y1p and y1p^2 over (B, H, W)."""
    cout = w1.shape[0]
    h = _act((x.float() - m1) * (torch.rsqrt(v1 + BN_EPS) * s1) + o1)
    y1p = _nhwc(conv_parity2(_nchw(h), pack_up_conv2(w1), cout,
                             b1.repeat(4)))
    y32 = y1p.reshape(-1, 4 * cout)
    return y1p, torch.stack([y32.sum(0), y32.square().sum(0)])


def gblock_b_plain(y1p, x, m2, v2, s2, o2, w2, b2, wp, bp):
    """K5's function in plain torch ops: out_p = full-res parity
    conv2(act(bn2(y1p))) + tile(b2, 4) + x @ tile(wp, 4) + tile(bp, 4),
    NHWC (B, H, W, 4*Cout). The statistics m2, v2 are per Cout channel."""
    cout = w2.shape[0]
    inv = torch.rsqrt(v2 + BN_EPS) * s2
    h = _act((y1p - m2.repeat(4)) * inv.repeat(4) + o2.repeat(4))
    y = _nhwc(conv_parity2(_nchw(h), pack_full_conv2(w2), cout,
                           b2.repeat(4)))
    return y + x @ wp.repeat(1, 4) + bp.repeat(4)


def _count(fn):
    with _COUNT_LOCK:
        fn.launches += 1


def _check(name, x, w, *ts):
    """What both kernels take: NHWC x, a (Cout, Ci, 3, 3) weight, float32
    tensors on one device (cpu or cuda)."""
    if x.dim() != 4 or w.dim() != 4 or w.shape[2:] != (3, 3):
        raise ValueError(f"{name} takes NHWC x and a (Cout, Ci, 3, 3) weight,"
                         f" got {tuple(x.shape)}, {tuple(w.shape)}")
    ts = (x, w) + ts
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"{name} takes float32 tensors, got "
                        f"{sorted({str(t.dtype) for t in ts})}")
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"{name}: all tensors must be on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def gblock_a(x, m1, v1, s1, o1, w1, b1):
    """K4 for CUDA tensors, ``gblock_a_plain`` for CPU tensors: (y1p,
    (2, 4*Cout) sums)."""
    _check("gblock_a", x, w1, m1, v1, s1, o1, b1)
    if w1.shape[1] != x.shape[3]:
        raise ValueError(f"gblock_a: x {tuple(x.shape)} does not fit the "
                         f"weight {tuple(w1.shape)}")
    if x.device.type == "cpu":
        return gblock_a_plain(x, m1, v1, s1, o1, w1, b1)
    b, h, w, cin = x.shape
    cout = w1.shape[0]
    x = x.contiguous()
    w1p = pack_up_conv2(w1).permute(2, 3, 1, 0).contiguous()
    bias = b1.repeat(4).contiguous()
    mul = (torch.rsqrt(v1 + BN_EPS) * s1).contiguous()
    mean, add = m1.contiguous(), o1.contiguous()
    y1p = torch.empty((b, h, w, 4 * cout), dtype=x.dtype, device=x.device)
    lib = build.load("gblock")
    lib.tt_gblock_partial_rows.argtypes = [ctypes.c_int] * 4
    lib.tt_gblock_partial_rows.restype = ctypes.c_longlong
    rows = lib.tt_gblock_partial_rows(b, h, w, cout)
    partial = torch.empty((rows, 2, 4 * cout), dtype=torch.float32,
                          device=x.device)
    stats = torch.empty((2, 4 * cout), dtype=torch.float32, device=x.device)
    fn = lib.tt_gblock_a
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong]
                   + [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w1p.data_ptr(), bias.data_ptr(),
                 mean.data_ptr(), mul.data_ptr(), add.data_ptr(),
                 y1p.data_ptr(), partial.data_ptr(), rows, stats.data_ptr(),
                 b, h, w, cin, cout, _stream(x.device))
    if err != 0:
        raise RuntimeError(f"gblock_a kernel launch failed: cudaError {err}")
    _count(gblock_a)
    return y1p, stats


def gblock_b(y1p, x, m2, v2, s2, o2, w2, b2, wp, bp):
    """K5 for CUDA tensors, ``gblock_b_plain`` for CPU tensors: out_p."""
    _check("gblock_b", x, w2, y1p, m2, v2, s2, o2, b2, wp, bp)
    cout = w2.shape[0]
    if y1p.shape != x.shape[:3] + (4 * cout,) or w2.shape[1] != cout \
            or wp.shape != (x.shape[3], cout):
        raise ValueError(f"gblock_b: y1p {tuple(y1p.shape)}, x "
                         f"{tuple(x.shape)}, w2 {tuple(w2.shape)} and wp "
                         f"{tuple(wp.shape)} do not fit")
    if x.device.type == "cpu":
        return gblock_b_plain(y1p, x, m2, v2, s2, o2, w2, b2, wp, bp)
    b, h, w, cin = x.shape
    y1p, x = y1p.contiguous(), x.contiguous()
    w2p = pack_full_conv2(w2).permute(2, 3, 1, 0).contiguous()
    wp = wp.contiguous()
    bias = (b2 + bp).repeat(4).contiguous()
    mean = m2.repeat(4).contiguous()
    mul = (torch.rsqrt(v2 + BN_EPS) * s2).repeat(4).contiguous()
    add = o2.repeat(4).contiguous()
    out = torch.empty((b, h, w, 4 * cout), dtype=x.dtype, device=x.device)
    fn = build.load("gblock").tt_gblock_b
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(y1p.data_ptr(), x.data_ptr(), w2p.data_ptr(), wp.data_ptr(),
                 bias.data_ptr(), mean.data_ptr(), mul.data_ptr(),
                 add.data_ptr(), out.data_ptr(), b, h, w, cin, cout,
                 _stream(x.device))
    if err != 0:
        raise RuntimeError(f"gblock_b kernel launch failed: cudaError {err}")
    _count(gblock_b)
    return out


def _fused_forward(x, p, use_kernel=True):
    """The fused forward: (out NHWC, (m1, v1, m2, v2)), through
    ``gblock_a``/``gblock_b`` or, with ``use_kernel=False``, their plain
    versions on any device (then differentiable by autograd)."""
    fa, fb = (gblock_a, gblock_b) if use_kernel else (gblock_a_plain,
                                                       gblock_b_plain)
    b, h, w, _ = x.shape
    cout = p["w1"].shape[0]
    m1, v1 = _moments(x)
    y1p, stats = fa(x, m1, v1, p["s1"], p["o1"], p["w1"], p["b1"])
    # every position of y1 appears once among the four parity blocks: fold
    # the parity axis into the reduction before finishing the moments
    npix = b * 4 * h * w
    s4 = stats.reshape(2, 4, cout).sum(1)
    m2 = s4[0] / npix
    v2 = s4[1] / npix - m2.square()
    out_p = fb(y1p, x, m2, v2, p["s2"], p["o2"], p["w2"], p["b2"], p["wp"],
               p["bp"])
    return _nhwc(depth_to_space(_nchw(out_p), cout)), (m1, v1, m2, v2)


def _gblock_reference(x, params, stats=None):
    """Plain torch forward with the same semantics, at full resolution
    (the reference's ``_gblock_reference``): the backward differentiates
    it, and eval mode runs it with ``stats`` = the running (m1, v1, m2,
    v2). Returns (out NHWC, (m1, v1, m2, v2))."""
    p = params
    m1, v1 = _moments(x) if stats is None else stats[:2]
    h = _act((x.float() - m1) * torch.rsqrt(v1 + BN_EPS) * p["s1"] + p["o1"])
    y1 = _nhwc(conv2d(upsample_nearest_2x(_nchw(h)), p["w1"], p["b1"],
                      padding=1))
    m2, v2 = _moments(y1) if stats is None else stats[2:]
    h2 = _act((y1 - m2) * torch.rsqrt(v2 + BN_EPS) * p["s2"] + p["o2"])
    y2 = _nhwc(conv2d(_nchw(h2), p["w2"], p["b2"], padding=1))
    out = y2 + _nhwc(upsample_nearest_2x(_nchw(x))) @ p["wp"] + p["bp"]
    return out, (m1, v1, m2, v2)


class _FusedGBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *values):
        ctx.save_for_backward(x, *values)
        out, stats = _fused_forward(x, dict(zip(PARAMS, values)))
        ctx.mark_non_differentiable(*stats)
        return (out, *stats)

    @staticmethod
    def backward(ctx, d_out, *_d_stats):
        # the statistics feed the running averages only (zero cotangent);
        # the block differentiates through its batch statistics, so the
        # reference forward is recomputed with them
        def f(x, *values):
            return _gblock_reference(x, dict(zip(PARAMS, values)))[0]
        _, vjp = torch.func.vjp(f, *ctx.saved_tensors)
        return vjp(d_out.contiguous())


def fused_gblock(x, params, use_kernel=True):
    """The fused block's forward on NHWC ``x``, differentiable once:
    returns (out (B, 2H, 2W, Cout), (m1, v1, m2, v2)); the statistics are
    for the running averages and carry no gradient. ``use_kernel=False``
    runs the plain versions of K4/K5 under autograd instead, on any
    device."""
    if not use_kernel:
        out, stats = _fused_forward(x, params, use_kernel=False)
        return out, tuple(s.detach() for s in stats)
    out, *stats = _FusedGBlock.apply(x, *(params[k] for k in PARAMS))
    return out, tuple(stats)


gblock_a.launches = 0
gblock_b.launches = 0
