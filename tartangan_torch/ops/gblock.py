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
(Cin, Cout) and ``bp`` as the reference's ``x @ wp + bp``, or both None for
the identity shortcut (Cin == Cout; the reference's ``jnp.eye`` projection
computes the same), ``b1``, ``b2``, ``s1``/``o1`` (Cin) and ``s2``/``o2``
(Cout) BatchNorm scales and offsets, all float32. The kernels take these raw
tensors and the raw statistics: the weight packing (merged taps, the TF32
split) runs on the card, inside the same C call.

x, y1p and out_p are float32 or bfloat16 (the compute dtype); the
statistics are float32. In bfloat16 the kernels round where the TPU kernels
do (``_kernel_a`` :196, ``_kernel_b`` :234): BatchNorm in float32, its
result rounded to bfloat16 before the activation (``_act_from_f32``), the
packed weights summed in float32 and rounded to bfloat16, products
accumulated in float32, the biases added in float32 and the result rounded
once as it is stored; K4's sums are taken of the stored (rounded) y1p, in
float32. The plain versions round at the same points. ``_gblock_reference``
(the backward's function) rounds where the JAX package's does, in the
compute dtype.

``fused_gblock`` is a ``torch.autograd.Function``: the forward runs
``_moments`` -> K4 -> the statistics folded over the parity axis -> K5 ->
``depth_to_space``; the backward is the vector-Jacobian product of
``_gblock_reference``, recomputed (first order only, so G-side only). For
CUDA tensors ``gblock_a``/``gblock_b`` launch the kernels or raise; for CPU
tensors they run ``gblock_a_plain``/``gblock_b_plain``. ``gblock_a.launches``
and ``gblock_b.launches`` count kernel launches.
"""
from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from ..parallel import collectives as C
from ..utils.precision import rounded, wide
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
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the library of each dtype's instances (``ops/build.py``)
_LIBRARY = {torch.float32: "gblock", torch.bfloat16: "gblock_bf16"}
_COUNT_LOCK = threading.Lock()


def _act(x):
    """leaky-relu(0.2), what this codebase's 'relu' means, with the slope
    rounded to ``x``'s dtype (``models/layers.py::leaky_relu``)."""
    return F.leaky_relu(x, rounded(0.2, x.dtype))


def _moments(x):
    """Biased per-channel mean and variance over all but the last axis,
    float32 (float64 for float64), as ``mean(x^2) - mean^2`` (the
    reference's ``_moments``); over the global batch under a data mesh."""
    return C.batch_moments(x.to(wide(x.dtype)).reshape(-1, x.shape[-1]))


def _bn_act(x, mean, mul, offset):
    """act(bn(x)) as the kernels take it: the BatchNorm in float32 (float64
    for float64), rounded to ``x``'s dtype before the activation."""
    return _act(((x.to(wide(x.dtype)) - mean) * mul + offset).to(x.dtype))


def _rounded_weight(w, dtype):
    """Packed float32 weights rounded to ``dtype``, in float32 (float64)."""
    return w.to(dtype).to(wide(dtype))


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


def gblock_a_plain(x, m1, v1, s1, o1, w1, b1):
    """K4's function in plain torch ops: y1p = parity-up conv1(act(bn1(x)))
    + tile(b1, 4), NHWC (B, H, W, 4*Cout) in x's dtype, and (2, 4*Cout)
    float32 sums of the stored y1p and y1p^2 over (B, H, W). The conv and
    the bias in float32, rounded once."""
    cout = w1.shape[0]
    dt, wt = x.dtype, wide(x.dtype)
    h = _bn_act(x, m1, torch.rsqrt(v1 + BN_EPS) * s1, o1)
    y1p = _nhwc(conv_parity2(_nchw(h.to(wt)),
                             _rounded_weight(pack_up_conv2(w1), dt), cout,
                             b1.repeat(4))).to(dt)
    y32 = y1p.to(wt).reshape(-1, 4 * cout)
    return y1p, torch.stack([y32.sum(0), y32.square().sum(0)])


def _shortcut(x, wp, bp):
    """x @ wp + bp in x's dtype, or x itself for the identity (``wp`` and
    ``bp`` None)."""
    return x if wp is None else x @ wp.to(x.dtype) + bp.to(x.dtype)


def gblock_b_plain(y1p, x, m2, v2, s2, o2, w2, b2, wp, bp):
    """K5's function in plain torch ops: out_p = full-res parity
    conv2(act(bn2(y1p))) + tile(b2, 4) + tile(x @ wp + bp, 4), NHWC
    (B, H, W, 4*Cout) in y1p's dtype; ``wp = bp = None`` is the identity
    shortcut. The statistics m2, v2 are per Cout channel. The convs, the
    shortcut and the biases in float32, rounded once."""
    cout = w2.shape[0]
    dt, wt = y1p.dtype, wide(y1p.dtype)
    inv = torch.rsqrt(v2 + BN_EPS) * s2
    h = _bn_act(y1p, m2.repeat(4), inv.repeat(4), o2.repeat(4))
    y = _nhwc(conv_parity2(_nchw(h.to(wt)),
                           _rounded_weight(pack_full_conv2(w2), dt), cout,
                           b2.repeat(4)))
    sc = _shortcut(x.to(wt), None if wp is None else _rounded_weight(wp, dt),
                   bp)
    return (y + sc.repeat(1, 1, 1, 4)).to(dt)


def _count(fn, dtype):
    """One launch of ``fn``'s kernel, in ``dtype``: ``fn.launches`` counts
    them all, ``fn.launches_by_dtype`` each dtype's."""
    with _COUNT_LOCK:
        fn.launches += 1
        fn.launches_by_dtype[dtype] = fn.launches_by_dtype.get(dtype, 0) + 1


def _check(name, x, w, vectors, *ts, acts=()):
    """What both kernels take: NHWC x, a (Cout, Ci, 3, 3) weight, vectors
    of the given lengths, on one device (cpu or cuda); x and ``acts`` float32
    or bfloat16, of one dtype, the weights and vectors float32."""
    if x.dim() != 4 or w.dim() != 4 or w.shape[2:] != (3, 3):
        raise ValueError(f"{name} takes NHWC x and a (Cout, Ci, 3, 3) weight,"
                         f" got {tuple(x.shape)}, {tuple(w.shape)}")
    for t, n in vectors:
        if t.shape != (n,):
            raise ValueError(f"{name}: a vector is {tuple(t.shape)}, not "
                             f"({n},)")
    params = (w,) + tuple(t for t, _ in vectors) + ts
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in acts) \
            or any(t.dtype != torch.float32 for t in params):
        raise TypeError(f"{name} takes float32 or bfloat16 activations of "
                        "one dtype and float32 weights and vectors, got "
                        f"{[str(t.dtype) for t in (x, *acts)]} and "
                        f"{sorted({str(t.dtype) for t in params})}")
    ts = (x, *acts) + params
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"{name}: all tensors must be on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")


def _check_contiguous(name, *ts):
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: the kernel takes contiguous tensors, got "
                         f"strides {[t.stride() for t in ts]}")


# csrc/gblock.cu's tiling: a CTA owns an 8 x 8 tile of positions and 64
# channels of each output parity, and stages input channels 8 at a time
TILE, SLICE, CHUNK = 8, 64, 8


def partial_rows(b, h, w):
    """The rows of K4's partial sums: one per tile (``gb::layout``'s
    ``rows``)."""
    return b * -(-h // TILE) * -(-w // TILE)


def workspace_floats(full, b, h, w, cin, cout):
    """The float32 scratch that K4 (``full`` False) or K5 (True) takes, as
    ``csrc/gblock.cu``'s ``tt_gblock_workspace`` computes it: the packed
    weights (hi and lo: 16 merged-tap or 9 raw-tap blocks x 64 channels
    x 8, for every channel slice and chunk), bn's three per-channel
    vectors (padded to a chunk) and K4's (rows, 2, 4*Cout) partial sums."""
    nch = -(-(cout if full else cin) // CHUNK)
    packed = (9 if full else 16) * SLICE * CHUNK * nch * -(-cout // SLICE)
    rows = 0 if full else partial_rows(b, h, w)
    return 2 * packed + 3 * CHUNK * nch + rows * 2 * 4 * cout


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def gblock_a(x, m1, v1, s1, o1, w1, b1):
    """K4 for CUDA tensors (pack, main and reduce launches in one C call),
    ``gblock_a_plain`` for CPU tensors: (y1p, (2, 4*Cout) sums)."""
    cin, cout = x.shape[-1], w1.shape[0]
    _check("gblock_a", x, w1, [(t, cin) for t in (m1, v1, s1, o1)]
           + [(b1, cout)])
    if w1.shape[1] != cin:
        raise ValueError(f"gblock_a: x {tuple(x.shape)} does not fit the "
                         f"weight {tuple(w1.shape)}")
    if x.device.type == "cpu":
        return gblock_a_plain(x, m1, v1, s1, o1, w1, b1)
    _check_contiguous("gblock_a", x, m1, v1, s1, o1, w1, b1)
    b, h, w, _ = x.shape
    y1p = torch.empty((b, h, w, 4 * cout), dtype=x.dtype, device=x.device)
    # the sums and the scratch are float32 in either dtype
    stats = torch.empty((2, 4 * cout), dtype=torch.float32, device=x.device)
    nwork = workspace_floats(False, b, h, w, cin, cout)
    work = torch.empty(nwork, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = build.load(_LIBRARY[x.dtype]).tt_gblock_a(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), m1.data_ptr(),
            v1.data_ptr(), s1.data_ptr(), o1.data_ptr(), y1p.data_ptr(),
            stats.data_ptr(), work.data_ptr(), nwork, b, h, w, cin, cout,
            _DTYPES[x.dtype], _stream(x.device))
    if err != 0:
        raise RuntimeError(f"gblock_a kernel launch failed: cudaError {err}")
    _count(gblock_a, x.dtype)
    return y1p, stats


def gblock_b(y1p, x, m2, v2, s2, o2, w2, b2, wp, bp):
    """K5 for CUDA tensors (pack and main launches in one C call),
    ``gblock_b_plain`` for CPU tensors: out_p. ``wp = bp = None`` is the
    identity shortcut (Cin == Cout), added as x."""
    cin, cout = x.shape[-1], w2.shape[0]
    if (wp is None) != (bp is None):
        raise ValueError("gblock_b: give both wp and bp, or neither")
    proj = () if wp is None else (wp,)
    _check("gblock_b", x, w2, [(t, cout) for t in (m2, v2, s2, o2, b2)]
           + ([] if bp is None else [(bp, cout)]), *proj, acts=(y1p,))
    if y1p.shape != x.shape[:3] + (4 * cout,) or w2.shape[1] != cout \
            or (wp is None and cin != cout) \
            or (wp is not None and wp.shape != (cin, cout)):
        raise ValueError(f"gblock_b: y1p {tuple(y1p.shape)}, x "
                         f"{tuple(x.shape)}, w2 {tuple(w2.shape)} and wp "
                         f"{None if wp is None else tuple(wp.shape)} do not "
                         f"fit")
    if x.device.type == "cpu":
        return gblock_b_plain(y1p, x, m2, v2, s2, o2, w2, b2, wp, bp)
    _check_contiguous("gblock_b", y1p, x, m2, v2, s2, o2, w2, b2, *proj,
                      *(() if bp is None else (bp,)))
    b, h, w, _ = x.shape
    out = torch.empty((b, h, w, 4 * cout), dtype=x.dtype, device=x.device)
    nwork = workspace_floats(True, b, h, w, cin, cout)
    work = torch.empty(nwork, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = build.load(_LIBRARY[x.dtype]).tt_gblock_b(
            y1p.data_ptr(), x.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            None if wp is None else wp.data_ptr(),
            None if bp is None else bp.data_ptr(), m2.data_ptr(),
            v2.data_ptr(), s2.data_ptr(), o2.data_ptr(), out.data_ptr(),
            work.data_ptr(), nwork, b, h, w, cin, cout, _DTYPES[x.dtype],
            _stream(x.device))
    if err != 0:
        raise RuntimeError(f"gblock_b kernel launch failed: cudaError {err}")
    _count(gblock_b, x.dtype)
    return out


def _fused_forward(x, p, use_kernel=True):
    """The fused forward: (out NHWC, (m1, v1, m2, v2)), through
    ``gblock_a``/``gblock_b`` or, with ``use_kernel=False``, their plain
    versions on any device (then differentiable by autograd)."""
    fa, fb = (gblock_a, gblock_b) if use_kernel else (gblock_a_plain,
                                                       gblock_b_plain)
    # the kernels take contiguous tensors (a no-op for those that are)
    x = x.contiguous()
    p = {k: None if v is None else v.contiguous() for k, v in p.items()}
    b, h, w, _ = x.shape
    cout = p["w1"].shape[0]
    m1, v1 = _moments(x)
    y1p, stats = fa(x, m1, v1, p["s1"], p["o1"], p["w1"], p["b1"])
    # every position of y1 appears once among the four parity blocks: fold
    # the parity axis into the reduction before finishing the moments;
    # under a data mesh K4's sums are all-reduced first
    npix = b * 4 * h * w * C.data_size()
    s4 = C.data_sum(stats.reshape(2, 4, cout).sum(1))
    m2 = s4[0] / npix
    v2 = s4[1] / npix - m2.square()
    out_p = fb(y1p, x, m2, v2, p["s2"], p["o2"], p["w2"], p["b2"],
               p.get("wp"), p.get("bp"))
    return _nhwc(depth_to_space(_nchw(out_p), cout)), (m1, v1, m2, v2)


def _gblock_reference(x, params, stats=None):
    """Plain torch forward with the same semantics, at full resolution
    (the reference's ``_gblock_reference``): the backward differentiates
    it, and eval mode runs it with ``stats`` = the running (m1, v1, m2,
    v2). ``wp``/``bp`` None (or absent) is the identity shortcut. Returns
    (out NHWC, (m1, v1, m2, v2)). It computes in x's dtype and rounds
    where the reference does (``gblock.py:358-397``): the BatchNorms in
    float32, rounded before the activations; each conv rounded, then its
    bias added in x's dtype (``ops/parity.py::conv2d``); the shortcut's
    projection likewise."""
    p = params
    dt, wt = x.dtype, wide(x.dtype)
    m1, v1 = _moments(x) if stats is None else stats[:2]
    h = _act(((x.to(wt) - m1) * torch.rsqrt(v1 + BN_EPS) * p["s1"]
              + p["o1"]).to(dt))
    y1 = _nhwc(conv2d(upsample_nearest_2x(_nchw(h)), p["w1"], p["b1"],
                      padding=1))
    m2, v2 = _moments(y1) if stats is None else stats[2:]
    h2 = _act(((y1.to(wt) - m2) * torch.rsqrt(v2 + BN_EPS) * p["s2"]
               + p["o2"]).to(dt))
    y2 = _nhwc(conv2d(_nchw(h2), p["w2"], p["b2"], padding=1))
    x_up = _nhwc(upsample_nearest_2x(_nchw(x)))
    return y2 + _shortcut(x_up, p.get("wp"), p.get("bp")), (m1, v1, m2, v2)


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
        # reference forward is recomputed with them. An identity shortcut
        # (wp, bp None) is closed over, not differentiated
        x, *values = ctx.saved_tensors
        given = [i for i, v in enumerate(values) if v is not None]

        def f(x, *ts):
            vals = list(values)
            for i, t in zip(given, ts):
                vals[i] = t
            return _gblock_reference(x, dict(zip(PARAMS, vals)))[0]
        _, vjp = torch.func.vjp(f, x, *(values[i] for i in given))
        dx, *dts = vjp(d_out.contiguous())
        grads = [None] * len(values)
        for i, g in zip(given, dts):
            grads[i] = g
        return (dx, *grads)


def fused_gblock(x, params, use_kernel=True):
    """The fused block's forward on NHWC ``x``, differentiable once:
    returns (out (B, 2H, 2W, Cout), (m1, v1, m2, v2)); the statistics are
    for the running averages and carry no gradient. ``params`` without
    ``wp``/``bp`` (or with them None) has the identity shortcut.
    ``use_kernel=False`` runs the plain versions of K4/K5 under autograd
    instead, on any device."""
    if not use_kernel:
        out, stats = _fused_forward(x, params, use_kernel=False)
        return out, tuple(s.detach() for s in stats)
    out, *stats = _FusedGBlock.apply(x, *(params.get(k) for k in PARAMS))
    return out, tuple(stats)


gblock_a.launches = 0
gblock_a.launches_by_dtype = {}
gblock_b.launches = 0
gblock_b.launches_by_dtype = {}
