"""Parity-domain (sub-pixel / space-to-depth) convolution rewrites, NCHW.

Counterpart of ``tartangan_tpu/ops/parity.py``. A parity stack of a
full-resolution (B, C, 2H, 2W) tensor is the (B, 4C, H, W) tensor whose
channel block ``q = 2*qy + qx`` holds the pixels (2i + qy, 2j + qx): channel
``q*C + c``, as in the reference. The identities it rests on:

- ``conv3x3(up2_nearest(h), w) == depth_to_space(conv3x3(h, pack_up_conv(w)))``;
- a full-resolution ``conv3x3`` over a parity stack is a 3x3 conv with the
  block-structured ``pack_full_conv(w)`` weights;
- each output parity reads only two small offsets per dimension, so the
  ``*_conv2`` merged-tap forms express the same convs as 2x2 kernels plus a
  per-parity output shift (``conv_parity2``);
- ``avg_pool_2x(conv3x3(x, w)) == conv3x3(space_to_depth(x), pack_down_conv(w))``
  and its stride-2 parity-emitting form ``pack_down_parity_conv``.

The packers take the port's OIHW weights (Cout, Cin, kh, kw) and return
OIHW weights whose channel blocks are ordered as above. Each is one
``einsum`` of the weights with a constant 0/1 (or 1/4, 1/2) selection tensor
built from the reference's index rules, so it is linear in ``w`` and
differentiable to any order (the R1 penalty differentiates D's packed convs
twice).

The parity tensors are logically NCHW; ``depth_to_space`` and
``space_to_depth`` work through NHWC views and return ``torch.channels_last``
tensors, so the CUDA kernels (which take NHWC) see them without a copy.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

# The reference's module switches (``ops/parity.py:58,68``), read when a
# parity block runs: MERGED_TAP takes ``conv_parity2`` with the 2x2 packers
# instead of the 3x3 packed conv; FUSED_G takes the merged-tap kernel
# (``ops/parity_conv.py``, K3) in the generator's parity blocks.
MERGED_TAP = False
FUSED_G = False


def _pack_up_indices():
    """(tap (ky, kx), parity q, source tap (sy, sx)) of the sub-pixel conv:
    floor((q + d) / 2) == o per dimension."""
    out = []
    for qy in range(2):
        for qx in range(2):
            q = 2 * qy + qx
            for dy in range(-1, 2):
                for dx in range(-1, 2):
                    oy, ox = (qy + dy) >> 1, (qx + dx) >> 1
                    out.append(((oy + 1, ox + 1), q, (dy + 1, dx + 1)))
    return out


def _pack_full_indices():
    """(tap, input parity p, output parity q, source tap) of the
    full-resolution conv over parity stacks: d = 2o + p - q in {-1,0,1}."""
    out = []
    for qy in range(2):
        for qx in range(2):
            q = 2 * qy + qx
            for py in range(2):
                for px in range(2):
                    p = 2 * py + px
                    for oy in range(-1, 2):
                        for ox in range(-1, 2):
                            dy = 2 * oy + py - qy
                            dx = 2 * ox + px - qx
                            if abs(dy) > 1 or abs(dx) > 1:
                                continue
                            out.append(((oy + 1, ox + 1), p, q,
                                        (dy + 1, dx + 1)))
    return out


@functools.lru_cache(maxsize=None)
def _selection(kind: str) -> np.ndarray:
    """The constant selection tensor of each packer (float32 numpy)."""
    if kind == "up":          # [q, k, s]
        s = np.zeros((4, 9, 9), np.float32)
        for (ky, kx), q, (sy, sx) in _pack_up_indices():
            s[q, 3 * ky + kx, 3 * sy + sx] += 1
    elif kind == "up2":       # [q, a, s]
        s = np.zeros((4, 4, 9), np.float32)
        for qy in range(2):
            for qx in range(2):
                for dy in range(-1, 2):
                    for dx in range(-1, 2):
                        ay = ((qy + dy) >> 1) + 1 - qy
                        ax = ((qx + dx) >> 1) + 1 - qx
                        s[2 * qy + qx, 2 * ay + ax, 3 * (dy + 1) + dx + 1] += 1
    elif kind == "full":      # [q, p, k, s]
        s = np.zeros((4, 4, 9, 9), np.float32)
        for (ky, kx), p, q, (sy, sx) in _pack_full_indices():
            s[q, p, 3 * ky + kx, 3 * sy + sx] = 1
    elif kind == "full2":     # [q, p, a, s]
        s = np.zeros((4, 4, 4, 9), np.float32)
        for qy in range(2):
            for qx in range(2):
                for py in range(2):
                    for px in range(2):
                        for ay in range(2):
                            for ax in range(2):
                                dy = 2 * ay + py + qy - 2
                                dx = 2 * ax + px + qx - 2
                                if abs(dy) > 1 or abs(dx) > 1:
                                    continue
                                s[2 * qy + qx, 2 * py + px, 2 * ay + ax,
                                  3 * (dy + 1) + dx + 1] = 1
    elif kind == "down":      # [p, k, s]
        s = np.zeros((4, 9, 9), np.float32)
        for (ky, kx), p, _q, (sy, sx) in _pack_full_indices():
            s[p, 3 * ky + kx, 3 * sy + sx] += 0.25
    elif kind == "down_parity":  # per dim [a, p, q, s]
        s = np.zeros((4, 2, 2, 3), np.float32)
        for a in range(4):
            for p in range(2):
                for q in range(2):
                    for t in range(3):
                        if 2 * (a - 1) + p - 2 * q - (t - 1) in (0, 1):
                            s[a, p, q, t] = 0.5
    else:
        raise ValueError(kind)
    return s


def _sel(kind, w):
    return torch.as_tensor(_selection(kind), dtype=w.dtype, device=w.device)


def pack_up_conv(w):
    """(Cout, Cin, 3, 3) -> (4*Cout, Cin, 3, 3) sub-pixel weights:
    conv3x3(up2_nearest(h), w) == depth_to_space(conv3x3(h, out))."""
    co, ci = w.shape[:2]
    out = torch.einsum("qks,ois->qoik", _sel("up", w), w.reshape(co, ci, 9))
    return out.reshape(4 * co, ci, 3, 3)


def pack_up_conv2(w):
    """(Cout, Cin, 3, 3) -> (4*Cout, Cin, 2, 2) merged-tap sub-pixel
    weights for ``conv_parity2`` (16 MACs per Cin*Cout and small position
    instead of ``pack_up_conv``'s 36)."""
    co, ci = w.shape[:2]
    out = torch.einsum("qas,ois->qoia", _sel("up2", w), w.reshape(co, ci, 9))
    return out.reshape(4 * co, ci, 2, 2)


def pack_full_conv(w):
    """(Cout, Cin, 3, 3) -> (4*Cout, 4*Cin, 3, 3): a full-resolution 3x3
    conv over channel-stacked parity planes."""
    co, ci = w.shape[:2]
    out = torch.einsum("qpks,ois->qopik", _sel("full", w),
                       w.reshape(co, ci, 9))
    return out.reshape(4 * co, 4 * ci, 3, 3)


def pack_full_conv2(w):
    """(Cout, Cin, 3, 3) -> (4*Cout, 4*Cin, 2, 2) merged-tap form of
    ``pack_full_conv`` for ``conv_parity2`` (9 of its 16 Cin x Cout blocks
    per output parity are non-zero)."""
    co, ci = w.shape[:2]
    out = torch.einsum("qpas,ois->qopia", _sel("full2", w),
                       w.reshape(co, ci, 9))
    return out.reshape(4 * co, 4 * ci, 2, 2)


def pack_down_conv(w):
    """(Cout, Cin, 3, 3) -> (Cout, 4*Cin, 3, 3): avg_pool_2x(conv3x3(x, w))
    == conv3x3(space_to_depth(x), out), in standard layout at half
    resolution."""
    co, ci = w.shape[:2]
    out = torch.einsum("pks,ois->opik", _sel("down", w), w.reshape(co, ci, 9))
    return out.reshape(co, 4 * ci, 3, 3)


def pack_down_parity_conv(w):
    """(Cout, Cin, 3, 3) -> (4*Cout, 4*Cin, 4, 4) stride-2 kernel, padding 1,
    over a parity stack: it emits ``space_to_depth(avg_pool_2x(conv3x3(x,
    w)))``, the D block's conv2 + pool still parity-stacked."""
    co, ci = w.shape[:2]
    s = _sel("down_parity", w)
    out = torch.einsum("ypqs,xPQS,oisS->qQopPiyx", s, s, w)
    return out.reshape(4 * co, 4 * ci, 4, 4)


def pack_point_conv(w):
    """(Cout, Cin, 1, 1) -> (4*Cout, 4*Cin, 1, 1) block-diagonal weights:
    output parity q reads only input parity q."""
    co, ci = w.shape[:2]
    eye = torch.eye(4, dtype=w.dtype, device=w.device)
    out = torch.einsum("pq,oi->poqi", eye, w.reshape(co, ci))
    return out.reshape(4 * co, 4 * ci, 1, 1)


def conv2d(x, w, b=None, **kwargs):
    """``F.conv2d``, of a contiguous NCHW copy of ``x`` on the CPU. The
    parity layouts hand convolutions channels_last views; on the CPU,
    oneDNN's backward of such a convolution was measured up to 1.4 % of the
    max-abs off (input gradient, against float64) where the contiguous input
    gives 1e-6. cuDNN takes the channels_last view as it is."""
    if x.device.type == "cpu":
        x = x.contiguous()
    return F.conv2d(x, w, b, **kwargs)


def conv_parity2(x, w2, cout, b=None):
    """Apply a merged-tap 2x2 parity kernel (``pack_up_conv2`` /
    ``pack_full_conv2``) to NCHW ``x``: one conv with padding 1 gives a
    (B, 4*Cout, H+1, W+1) grid in which output parity q = 2*qy + qx lives at
    spatial offset (qy, qx); the slices realign it to the (B, 4*Cout, H, W)
    parity stack."""
    y = conv2d(x, w2.to(x.dtype), padding=1)
    h, w = x.shape[2], x.shape[3]
    parts = [y[:, q * cout:(q + 1) * cout, q // 2:h + q // 2, q % 2:w + q % 2]
             for q in range(4)]
    out = torch.cat(parts, dim=1)
    if b is not None:
        out = out + b.to(x.dtype)[None, :, None, None]
    return out


def depth_to_space(y, cout):
    """(B, 4*C, H, W) parity channels -> (B, C, 2H, 2W), channel-block index
    2*qy + qx; the result is channels_last."""
    b, _, h, w = y.shape
    t = y.permute(0, 2, 3, 1).reshape(b, h, w, 2, 2, cout)
    t = t.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, cout)
    return t.permute(0, 3, 1, 2)


def space_to_depth(x):
    """(B, C, 2H, 2W) -> (B, 4*C, H, W) parity channels (the inverse of
    ``depth_to_space``); the result is channels_last."""
    b, c, h2, w2 = x.shape
    h, w = h2 // 2, w2 // 2
    t = x.permute(0, 2, 3, 1).reshape(b, h, 2, w, 2, c)
    t = t.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, 4 * c)
    return t.permute(0, 3, 1, 2)


def folded_moments(xp, c):
    """Per-original-channel biased mean and variance of a parity stack
    (B, 4*C, H, W), float32: every full-resolution position appears once
    among the parity blocks, so folding the parity axis into the reduction
    gives the full-resolution tensor's statistics. ``mean(x^2) - mean^2``,
    as the reference computes it."""
    x32 = xp.float().permute(0, 2, 3, 1).reshape(-1, 4, c)
    mean = x32.mean(dim=(0, 1))
    var = x32.square().mean(dim=(0, 1)) - mean.square()
    return mean, var
