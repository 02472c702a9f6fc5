#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tartangan_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
printing a result:

1. device: needs CUDA (there is no CPU path); prints the card's name and
   power limit as ``nvidia-smi`` reports them.
2. build: compiles every CUDA kernel of the port from the sources in the
   checkout (``tartangan_torch/ops/build.py``), all in parallel.
3. kernels: each kernel against its plain PyTorch version on the card, at
   the serving and training paths' shapes and more, with the tolerances
   stated below; then the attention's two autograd Functions (K1 forward,
   K2 backward, the plain vector-Jacobian product beneath) against autograd
   through the plain attention, to second order, at the '512thin'
   discriminator's shape. Then the parity kernels: K3 (merged-tap parity
   conv, both modes) at the eight '512thin' G shapes and a ragged one, K4
   and K5 (the fused G block) at both fused blocks' shapes and one with a
   projection, K4's sums too, and the two parity autograd Functions'
   gradients against autograd through the plain forms. TF32 is off for
   matmuls and convolutions in the whole script, so float32 references are
   full float32.
4. serve: writes a full-width '512thin' generator (random weights from a
   seeded ``torch.Generator``, every attention ``gamma`` nonzero) as a run
   directory in the JAX trainer's layout, serves it in-process with
   ``tartangan_torch.serve``'s handler, fetches ``/meta``, ``/``,
   ``/generate`` and ``/grid``, checks the PNGs, and checks that the
   requests launched the attention kernel. Then holds the served
   generator against itself on the plain attention, and against a CPU run.
   Times the served requests (host clock, after warm-up).
5. train: writes a synthetic 512x512 tartan archive (192 images, the
   port's ``data/synthetic.py``) and trains full-width '512thin' for 3
   steps at B = 64, float32, through ``CNNTrainer.create_from_cli`` and
   ``.train()``; checks that every loss is finite, that each step launched
   K1 and K2 the expected number of times, that the final checkpoint is in
   the JAX trainer's layout, and that the port's serve app loads the run
   and generates on the card. Then holds one step with the kernels
   against one with the plain attention, from the same state, batch and
   latents (losses, gp, and the gradients as Adam's first moment).
6. times: kernel, plain version, one PyTorch library call and the bound,
   for K1 at the serving and training shapes and K2 at the training
   shapes; ``generate`` latency at B = 1 and B = 25 and the train step at
   B = 64 (kernel and plain attention), each with a profile of device time
   by kernel and the device's idle share; the train step's peak memory.
7. parity: trains full-width '512thin' for 3 steps at B = 64 with
   ``--parity-blocks on``, ``ops.parity.FUSED_G`` and the fused G blocks
   (``g_block_factory(fused=True)`` through a trainer subclass, as no CLI
   flag selects them); checks the losses, the K1-K5 launches of each step
   (5, 5, 16, 4, 4) and the checkpoint's JAX layout. Holds G's and D's
   forwards against the plain '512thin' G and D on the same weights; then
   one step from the same state, batch and latents with the kernels, with
   FUSED_G off and the fused blocks on their plain versions, and on the
   plain path, each against the plain step in float64. Times the parity
   step and the plain step in turns (and the parity step with a layout
   copy before each conv), with a profile and the peak memory; then K3, K4
   and K5 at the path's shapes (kernel, plain, ``F.conv2d`` of the
   3x3-packed form for K3, and the bound).

The last three lines of standard output are a ``{"kernels": [...]}`` JSON
line (K1-K5; K3-K5's times summed over the launches of one G forward),
the ``nvidia-smi`` name/power-limit line and the result line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import copy
import gc
import json
import shutil
import statistics
import struct
import subprocess
import sys
import threading
import time
import traceback
import urllib.request
import zlib
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
RUN_DIR = ROOT / "build" / "chip_smoke_run"

# H100 SXM data-sheet peaks (dense): float32 outside the tensor cores, and
# HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# kernel vs plain version on the card. float32: the kernel takes exp as
# exp2 of log2(e)-scaled logits and sums in another order than cuBLAS;
# bfloat16: one bf16 rounding of the output (2**-8 relative), and the
# plain version also rounds p to bf16 before p @ v
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
# the served generator, kernel vs plain attention, and card vs CPU: the
# attention difference above passes through 4 more BatchNorm'd blocks
TOL_G = dict(rtol=1e-3, atol=1e-3)
# K2 against its plain version: each gradient divided by its max-abs (a
# sum over Lq or Lk terms grows with the length), then the tolerances above
# the train step with the kernels against the plain attention: losses and
# gp relative; gradients (Adam's first moment, beta1 = 0) divided by the
# max-abs over the model's whole gradient, after five more BatchNorm'd
# blocks downstream of D's attention and R1's second order on top
TOL_STEP_LOSS = dict(rtol=1e-4, atol=1e-6)
TOL_STEP_GRAD = dict(rtol=0, atol=1e-3)

# the parity path's step against the plain step in float64 on the same
# weights, batch and latents. Gradients: the max abs error over the max-abs
# of the model's whole gradient (max), and the norm of the difference over
# the norm of the gradient (norm). A float32 step's gradient is not within
# rounding of float64's: where a pre-activation lies within rounding of 0,
# float32 may put it on the other side of leaky-relu's kink, whose slope
# jumps from 1 to 0.2, and with millions of activations some do. Which ones
# depends on the summation order, so float32 steps that differ only in it
# (the plain step, the same with channels_last weights, the parity forms
# with 3x3-packed or merged-tap convs) land 1.6e-3 to 1.3e-2 (G, norm) from
# float64 on an H100; with elu (smooth) the plain step lands 6e-6 (G) and
# 1.8e-4 (D, max: the input conv's weight gradient, a sum over 16.7M
# positions) from it, and is held within TOL_PARITY_STEP_GRAD.
# So the kernel step must be within the larger of these limits (PR 2's
# TOL_STEP_GRAD) and PARITY_WITNESS_FACTOR times the largest distance of
# those float32 steps from float64, measured in the same run; a wiring
# fault gives errors of order 1
TOL_PARITY_STEP_GRAD = {"norm": 1e-3, "max": 1e-3}
PARITY_WITNESS_FACTOR = 3

TRAIN_DIR = ROOT / "build" / "chip_smoke_train"
# launches per train step with R1: K1 in G (D step's fakes, G step) and D
# (reals, fakes, G step's fakes); K2 in G (G step) and D (R1's inner
# gradient, reals and fakes in the D step's backward, G step)
K1_PER_STEP, K2_PER_STEP = 5, 5


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters=20, reps=7):
    """Median over ``reps`` of the mean device time of ``iters`` calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def host_ms(fn, reps=10):
    """Median host-clock time of ``fn`` (which ends in a device->host copy)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def attention_bound_ms(b, lq, lk, ck, cv, itemsize, backward=False):
    """Least time for the attention on an H100: each input read once and
    each output written once, against the float32 FLOPs the JAX kernel
    does: 2*B*Lq*Lk*(Ck+Cv) forward; 2*B*Lq*Lk*(3*Ck+2*Cv) backward (s,
    dp, dq, dk, dv), with q, k, v, do in and dq, dk, dv out."""
    qkv = b * lq * ck + b * lk * ck + b * lk * cv
    if backward:
        nbytes = itemsize * (2 * qkv + b * lq * cv)
        flops = 2 * b * lq * lk * (3 * ck + 2 * cv)
    else:
        nbytes = itemsize * (qkv + b * lq * cv)
        flops = 2 * b * lq * lk * (ck + cv)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def png_size(data):
    """(width, height) of an 8-bit RGB PNG, after checking its pixel data
    inflates to the right length."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("not a PNG")
    width, height = struct.unpack(">II", data[16:24])
    pos, idat = 8, b""
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    if len(zlib.decompress(idat)) != height * (1 + 3 * width):
        raise AssertionError("PNG pixel data has the wrong length")
    return width, height


def phase_kernels(dev):
    from tartangan_torch.ops.attention import attention, attention_plain
    shapes = [("512thin G /grid", 25, 4096, 1024, 8, 32),
              ("512thin G /generate", 1, 4096, 1024, 8, 32),
              ("1024 G", 8, 4096, 1024, 32, 128),
              ("ragged", 3, 1000, 333, 7, 40)]
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = {}
    for label, b, lq, lk, ck, cv in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(b, lq, ck, device=dev, generator=gen).to(dtype)
            k = torch.randn(b, lk, ck, device=dev, generator=gen).to(dtype)
            v = torch.randn(b, lk, cv, device=dev, generator=gen).to(dtype)
            out = attention(q, k, v)
            ref = attention_plain(q, k, v)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            log(f"kernel attention_fwd {label} B{b} Lq{lq} Lk{lk} Ck{ck} "
                f"Cv{cv} {str(dtype)[6:]}: max_abs_err {err:.3e} "
                f"(tolerance {TOL[dtype]})")
            torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
            if label.startswith("512thin") and dtype == torch.float32:
                worst["attention_fwd"] = max(err, worst.get("attention_fwd", 0))
    worst["attention_bwd"] = check_attention_bwd(dev)
    check_double_backward(dev)
    return worst


def check_attention_bwd(dev):
    """K2 against attention_bwd_plain; returns the largest float32 max abs
    error at the '512thin' training shapes."""
    from tartangan_torch.ops.attention import (attention_bwd,
                                               attention_bwd_plain)
    shapes = [("512thin G train", 64, 4096, 1024, 8, 32),
              ("512thin D train", 64, 1024, 256, 8, 32),
              ("1024 G", 8, 4096, 1024, 32, 128),
              ("ragged", 3, 1000, 333, 7, 40)]
    gen = torch.Generator(device=dev).manual_seed(5)
    worst = 0.0
    for label, b, lq, lk, ck, cv in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (
                torch.randn(s, device=dev, generator=gen).to(dtype)
                for s in ((b, lq, ck), (b, lk, ck), (b, lk, cv), (b, lq, cv)))
            outs = attention_bwd(q, k, v, do)
            refs = attention_bwd_plain(q, k, v, do)
            torch.cuda.synchronize()
            errs = []
            for name, out, ref in zip(("dq", "dk", "dv"), outs, refs):
                assert out.dtype == dtype and out.shape == ref.shape
                scale = ref.float().abs().max()
                err = (out.float() - ref.float()).abs().max().item()
                errs.append(f"{name} {err:.3e} (max-abs {scale.item():.3e})")
                torch.testing.assert_close(out.float() / scale,
                                           ref.float() / scale, **TOL[dtype])
                if label.startswith("512thin") and dtype == torch.float32:
                    worst = max(worst, err)
            log(f"kernel attention_bwd {label} B{b} Lq{lq} Lk{lk} Ck{ck} "
                f"Cv{cv} {str(dtype)[6:]}: max_abs_err {', '.join(errs)} "
                f"(tolerance {TOL[dtype]} after dividing by max-abs)")
    return worst


def check_double_backward(dev):
    """First- and second-order gradients of sum(dq^2)-style scalars through
    the two Functions against autograd through attention_plain, at the
    '512thin' discriminator's training shape."""
    from tartangan_torch.ops.attention import attention, attention_plain
    b, lq, lk, ck, cv = 64, 1024, 256, 8, 32

    def grads(fn):
        gen = torch.Generator(device=dev).manual_seed(6)
        q, k, v = (torch.randn(s, device=dev, generator=gen).requires_grad_()
                   for s in ((b, lq, ck), (b, lk, ck), (b, lk, cv)))
        w = torch.randn((b, lq, cv), device=dev, generator=gen)
        g1 = torch.autograd.grad((fn(q, k, v) * w).sum(), (q, k, v),
                                 create_graph=True)
        g2 = torch.autograd.grad(sum(g.square().sum() for g in g1),
                                 (q, k, v))
        return g1 + g2

    ours, ref = grads(attention), grads(attention_plain)
    errs = []
    for name, a, r in zip(("dq", "dk", "dv", "d2q", "d2k", "d2v"), ours, ref):
        scale = r.abs().max()
        errs.append(f"{name} {((a - r).abs().max() / scale).item():.2e}")
        torch.testing.assert_close(a / scale, r / scale, rtol=1e-4, atol=1e-4)
    log(f"attention Functions vs autograd through attention_plain, B{b} "
        f"Lq{lq} Lk{lk} Ck{ck} Cv{cv} f32, first and second order, error "
        f"over max-abs: {', '.join(errs)} (tolerance 1e-4)")


# K3 at the '512thin' G parity blocks' shapes (B 64; x is (B, H, H, Ci),
# Ci = cin for 'up', 4*cin for 'full'), and a ragged one
K3_SHAPES = [("block 3 (32x32)", 64, 32, 128, 64),
             ("block 5 (64x64)", 64, 64, 64, 32),
             ("block 6 (128x128)", 64, 128, 32, 16),
             ("block 7 (256x256)", 64, 256, 16, 8),
             ("ragged", 3, 7, 5, 7)]
# K4/K5 at the '512thin' fused blocks' shapes (x (B, H, H, Cin) -> Cout),
# identity shortcut, and one with a projection
GBLOCK_SHAPES = [("block 1 (8x8)", 64, 8, 128, 128),
                 ("block 2 (16x16)", 64, 16, 128, 128),
                 ("projection", 8, 12, 96, 40)]
# the parity kernels against their plain versions on the card, float32:
# each error is divided by the plain output's max-abs (a K = 4*Ci term sum,
# up to 1024 products, in another order than cuDNN's)
TOL_PARITY = dict(rtol=0, atol=1e-4)


def _scaled_err(out, ref):
    scale = ref.abs().max()
    return ((out - ref).abs().max() / scale).item(), scale


def _assert_scaled(name, out, ref, tol=TOL_PARITY):
    scale = ref.abs().max()
    torch.testing.assert_close(out / scale, ref / scale, **tol,
                               msg=lambda m: f"{name}: {m}")


def gblock_params(cin, cout, dev, gen, scale=0.05):
    p = {"w1": torch.randn(cout, cin, 3, 3, device=dev, generator=gen),
         "b1": torch.randn(cout, device=dev, generator=gen),
         "w2": torch.randn(cout, cout, 3, 3, device=dev, generator=gen),
         "b2": torch.randn(cout, device=dev, generator=gen),
         "s1": 1 + 0.2 * torch.randn(cin, device=dev, generator=gen),
         "o1": 0.2 * torch.randn(cin, device=dev, generator=gen),
         "s2": 1 + 0.2 * torch.randn(cout, device=dev, generator=gen),
         "o2": 0.2 * torch.randn(cout, device=dev, generator=gen)}
    p["w1"] *= scale
    p["w2"] *= scale
    if cin == cout:
        p["wp"] = torch.eye(cin, device=dev)
        p["bp"] = torch.zeros(cout, device=dev)
    else:
        p["wp"] = scale * torch.randn(cin, cout, device=dev, generator=gen)
        p["bp"] = torch.randn(cout, device=dev, generator=gen)
    return p


def phase_parity_kernels(dev):
    """K3 (both modes), K4 and K5 against their plain versions, and the two
    autograd Functions' gradients against autograd through the plain forms;
    returns the largest max-abs error of each at the '512thin' shapes."""
    from tartangan_torch.ops import gblock as G
    from tartangan_torch.ops.parity_conv import (
        fused_parity_conv,
        fused_parity_conv_plain,
        merged_tap_conv,
    )
    gen = torch.Generator(device=dev).manual_seed(11)
    worst = {"parity_conv": 0.0, "gblock_a": 0.0, "gblock_b": 0.0}
    for label, b, h, cin, cout in K3_SHAPES:
        for mode in ("up", "full"):
            wcin = cin if mode == "up" else cout
            ci = wcin if mode == "up" else 4 * wcin
            x = torch.randn(b, h, h, ci, device=dev, generator=gen)
            w = 0.1 * torch.randn(cout, wcin, 3, 3, device=dev, generator=gen)
            out = merged_tap_conv(x, w, cout, mode)
            ref = fused_parity_conv_plain(x, w, cout, mode)
            torch.cuda.synchronize()
            err, scale = _scaled_err(out, ref)
            log(f"kernel parity_conv '{mode}' {label} x {tuple(x.shape)} -> "
                f"{tuple(out.shape)}: max_abs_err {err * scale:.3e}, "
                f"{err:.3e} of the plain output's max-abs (tolerance "
                f"{TOL_PARITY} on the latter)")
            _assert_scaled(f"parity_conv {mode} {label}", out, ref)
            if label != "ragged":
                worst["parity_conv"] = max(worst["parity_conv"],
                                           err * scale.item())
            del x, out, ref
    for label, b, h, cin, cout in GBLOCK_SHAPES:
        p = gblock_params(cin, cout, dev, gen)
        x = torch.randn(b, h, h, cin, device=dev, generator=gen)
        m1, v1 = G._moments(x)
        y1p, stats = G.gblock_a(x, m1, v1, p["s1"], p["o1"], p["w1"], p["b1"])
        y1r, statr = G.gblock_a_plain(x, m1, v1, p["s1"], p["o1"], p["w1"],
                                      p["b1"])
        m2 = statr.reshape(2, 4, cout).sum(1)[0] / (4 * b * h * h)
        v2 = statr.reshape(2, 4, cout).sum(1)[1] / (4 * b * h * h) - m2 ** 2
        outb = G.gblock_b(y1r, x, m2, v2, p["s2"], p["o2"], p["w2"], p["b2"],
                          p["wp"], p["bp"])
        refb = G.gblock_b_plain(y1r, x, m2, v2, p["s2"], p["o2"], p["w2"],
                                p["b2"], p["wp"], p["bp"])
        torch.cuda.synchronize()
        errs = []
        for name, out, ref in (("y1p", y1p, y1r), ("sum", stats[0], statr[0]),
                               ("sum of squares", stats[1], statr[1]),
                               ("out_p", outb, refb)):
            err, scale = _scaled_err(out, ref)
            errs.append(f"{name} {err * scale:.3e} ({err:.3e} of max-abs)")
            _assert_scaled(f"gblock {label} {name}", out, ref)
            key = "gblock_b" if name == "out_p" else "gblock_a"
            if label != "projection" and name in ("y1p", "out_p"):
                worst[key] = max(worst[key], err * scale.item())
        log(f"kernel gblock_a/gblock_b {label} x {tuple(x.shape)} Cout "
            f"{cout}: max_abs_err {', '.join(errs)} (tolerance {TOL_PARITY} "
            f"after dividing by max-abs)")
    check_parity_functions(dev)
    return worst


def check_parity_functions(dev):
    """Gradients through ``fused_parity_conv`` and ``fused_gblock`` (kernel
    forwards, recomputed plain backwards) against autograd through the plain
    forms, at '512thin' shapes (B 8 to keep it short)."""
    from tartangan_torch.ops import gblock as G
    from tartangan_torch.ops.parity_conv import (
        fused_parity_conv,
        fused_parity_conv_plain,
    )
    gen = torch.Generator(device=dev).manual_seed(12)
    errs = []
    for mode, ci, wcin, cout in (("up", 128, 128, 64), ("full", 256, 64, 64)):
        x = torch.randn(8, 32, 32, ci, device=dev, generator=gen)
        w = 0.1 * torch.randn(cout, wcin, 3, 3, device=dev, generator=gen)
        bias = torch.randn(cout, device=dev, generator=gen)
        cot = torch.randn(8, 32, 32, 4 * cout, device=dev, generator=gen)

        def grads(fn):
            leaves = [t.clone().requires_grad_() for t in (x, w, bias)]
            out = fn(*leaves)
            return (out,) + torch.autograd.grad((out * cot).sum(), leaves)

        ours = grads(lambda a, b, c: fused_parity_conv(a, b, c, cout, mode))
        ref = grads(lambda a, b, c: fused_parity_conv_plain(a, b, cout, mode)
                    + c.repeat(4))
        for name, a, r in zip(("out", "dx", "dw", "db"), ours, ref):
            errs.append(f"parity_conv {mode} {name} "
                        f"{_scaled_err(a, r)[0]:.2e}")
            _assert_scaled(f"fused_parity_conv {mode} {name}", a, r)
    p = gblock_params(128, 128, dev, gen)
    x = torch.randn(8, 16, 16, 128, device=dev, generator=gen)
    cot = torch.randn(8, 32, 32, 128, device=dev, generator=gen)
    names = ["x"] + list(G.PARAMS)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in [x] +
                  [p[k] for k in G.PARAMS]]
        out = fn(leaves[0], dict(zip(G.PARAMS, leaves[1:])))
        return (out,) + torch.autograd.grad((out * cot).sum(), leaves)

    ours = grads(lambda a, q: G.fused_gblock(a, q)[0])
    ref = grads(lambda a, q: G.fused_gblock(a, q, use_kernel=False)[0])
    errs.append(f"gblock out {_scaled_err(ours[0], ref[0])[0]:.2e}")
    _assert_scaled("fused_gblock out", ours[0], ref[0])
    # over the max-abs of all the gradients: conv1's bias, before a
    # train-mode BatchNorm, has a gradient of 0 up to rounding
    scale = max(r.abs().max() for r in ref[1:])
    for name, a, r in zip(names, ours[1:], ref[1:]):
        errs.append(f"gblock d{name} {((a - r).abs().max() / scale):.2e}")
        torch.testing.assert_close(a / scale, r / scale, **TOL_PARITY)
    log(f"parity Functions vs autograd through the plain forms, error over "
        f"max-abs: {', '.join(errs)} (tolerance {TOL_PARITY})")


def make_run_dir():
    from tartangan_torch.configs import GAN_CONFIGS
    from tartangan_torch.convert import to_flax
    from tartangan_torch.models import factories as F
    from tartangan_torch.models.attention import SelfAttention2d
    from tartangan_torch.models.pluggan import Generator
    from tartangan_torch.ops.init import init_module_
    from tartangan_torch.utils import msgpack

    g = Generator(GAN_CONFIGS["512thin"],
                  input_factory=F.g_input_factory("mlp", "relu"),
                  block_factory=F.g_block_factory("bn", "relu"),
                  output_factory=F.g_output_factory("bn", "relu"))
    init_module_(g, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for m in g.modules():
            if isinstance(m, SelfAttention2d):
                m.gamma.fill_(0.5)  # at its init value 0 attention is inert
    tree = to_flax(g)
    ckpt = RUN_DIR / "checkpoints" / "1"
    ckpt.mkdir(parents=True, exist_ok=True)
    (RUN_DIR / "config.args").write_text("--config\n512thin\n")
    (ckpt / "g.msgpack").write_bytes(msgpack.dumps(tree))
    (ckpt / "g_target.msgpack").write_bytes(
        msgpack.dumps({"params": tree["params"]}))


def phase_serve():
    from tartangan_torch import serve
    from tartangan_torch.ops.attention import attention

    make_run_dir()
    app = serve._ServeApp(serve._ServeApp.parse_cli_args([str(RUN_DIR)]))
    app.load_generator()
    size = app.gan_config.max_size
    assert size == 512 and app.gan_config.blocks == (128, 128, 128, 64, 32,
                                                     16, 8)
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(app))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        attention.launches = 0
        meta = json.loads(urllib.request.urlopen(base + "/meta",
                                                 timeout=300).read())
        page = urllib.request.urlopen(base + "/", timeout=300).read()
        one = urllib.request.urlopen(base + "/generate?seed=7",
                                     timeout=300).read()
        grid = urllib.request.urlopen(base + "/grid?n=5&seed=3",
                                      timeout=300).read()
        launches = attention.launches
        request_ms = {
            path: host_ms(lambda: urllib.request.urlopen(
                base + path, timeout=300).read(), reps=reps)
            for path, reps in (("/generate?seed=7", 9),
                               ("/grid?n=5&seed=3", 5))}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    assert meta == {"latent_dims": 256, "image_size": 512, "data_dims": 3}
    assert b"tartangan-tpu generator" in page
    assert png_size(one) == (size + 2, size + 2), png_size(one)
    assert png_size(grid) == (5 * size + 6, 5 * size + 6), png_size(grid)
    log(f"serve: /meta {meta}; /generate {len(one)} B PNG; /grid n=5 "
        f"{len(grid)} B PNG; attention_fwd launches during the requests: "
        f"{launches}")
    for path, ms in request_ms.items():
        log(f"time GET {path} (host clock, request to last byte): {ms:.3f} ms")
    time_png(app)
    if launches < 2:
        raise AssertionError("the served requests did not launch the "
                             f"attention kernel (count {launches})")
    return app, {"attention_fwd": launches}


def time_png(app):
    """Host time of the served PNG encoding (grid + zlib) for one image and
    a 5x5 grid of this generator's images."""
    from tartangan_torch.utils.imaging import encode_png, make_grid, to_uint8
    z = np.random.default_rng(4).standard_normal((25, 256)).astype(np.float32)
    imgs = app.generate(z)
    for n, nrow in ((1, 1), (25, 5)):
        ms = host_ms(lambda: encode_png(make_grid(to_uint8(imgs[:n]),
                                                  nrow=nrow, padding=1)),
                     reps=5)
        log(f"time PNG encode of {n} image(s) (host clock): {ms:.3f} ms")


def check_generator(app):
    """The served generator against itself on the plain attention (card)
    and against a CPU copy (plain attention), same latents."""
    from tartangan_torch.models.attention import SelfAttention2d
    z = np.random.default_rng(1).standard_normal((25, 256)).astype(np.float32)
    out = app.generate(z)
    assert out.shape == (25, 512, 512, 3) and np.isfinite(out).all()
    assert np.abs(out).max() <= 1.0
    attn = [m for m in app.g.modules() if isinstance(m, SelfAttention2d)]
    assert len(attn) == 1 and app.g.blocks[4] is attn[0]
    for m in attn:
        m.use_kernel = False
    try:
        plain = app.generate(z)
    finally:
        for m in attn:
            m.use_kernel = True
    err = float(np.abs(out - plain).max())
    log(f"generate B25 kernel vs plain attention on the card: max_abs_err "
        f"{err:.3e} (tolerance {TOL_G})")
    np.testing.assert_allclose(out, plain, **TOL_G)

    g_cpu = copy.deepcopy(app.g).cpu()
    small = z[:2]
    with torch.inference_mode():
        ref = g_cpu(torch.from_numpy(small), train=True)
    ref = ref.permute(0, 2, 3, 1).numpy()
    on_card = app.generate(small)
    err_cpu = float(np.abs(on_card - ref).max())
    log(f"generate B2 card vs CPU: max_abs_err {err_cpu:.3e} "
        f"(tolerance {TOL_G})")
    np.testing.assert_allclose(on_card, ref, **TOL_G)
    # attention matters: without it the images move
    attn[0].gamma.data.zero_()
    try:
        moved = float(np.abs(app.generate(z) - out).max())
    finally:
        attn[0].gamma.data.fill_(0.5)
    assert moved > 1e-3, moved


def phase_times(app, dev):
    import torch.nn.functional as F

    from tartangan_torch.ops.attention import attention, attention_plain
    b, lq, lk, ck, cv = 25, 4096, 1024, 8, 32
    gen = torch.Generator(device=dev).manual_seed(2)
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(b, lq, ck, device=dev, generator=gen).to(dtype)
        k = torch.randn(b, lk, ck, device=dev, generator=gen).to(dtype)
        v = torch.randn(b, lk, cv, device=dev, generator=gen).to(dtype)
        ms_plain_a = cuda_ms(lambda: attention_plain(q, k, v))
        ms_kernel_a = cuda_ms(lambda: attention(q, k, v))
        ms_kernel_b = cuda_ms(lambda: attention(q, k, v))
        ms_plain_b = cuda_ms(lambda: attention_plain(q, k, v))
        ms_lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                                scale=1.0))
        bound, bound_by = attention_bound_ms(b, lq, lk, ck, cv,
                                             q.element_size())
        log(f"time attention_fwd B{b} Lq{lq} Lk{lk} Ck{ck} Cv{cv} "
            f"{str(dtype)[6:]}: kernel {ms_kernel_a:.4f}/{ms_kernel_b:.4f} ms,"
            f" plain {ms_plain_a:.4f}/{ms_plain_b:.4f} ms, sdpa {ms_lib:.4f} "
            f"ms, bound {bound:.4f} ms ({bound_by})")

    from tartangan_torch.models.attention import SelfAttention2d
    attn = [m for m in app.g.modules() if isinstance(m, SelfAttention2d)]
    rng = np.random.default_rng(3)
    for n in (1, 25):
        z = rng.standard_normal((n, 256)).astype(np.float32)
        ms = host_ms(lambda: app.generate(z))
        for m in attn:
            m.use_kernel = False
        try:
            ms_plain = host_ms(lambda: app.generate(z))
        finally:
            for m in attn:
                m.use_kernel = True
        log(f"time generate B{n} (host clock, z in to images on the host): "
            f"{ms:.3f} ms with the kernel, {ms_plain:.3f} ms with the plain "
            f"attention")
        profile_generate(app, z)


def profile_generate(app, z):
    """Device time by kernel for one ``generate`` call, and the device's
    idle share of its host-clock time."""
    app.generate(z)
    profile_call(f"generate B{len(z)}", lambda: app.generate(z))


def profile_call(label, fn):
    """Device time by kernel for one call of ``fn`` (which ends in a
    synchronization), and the device's idle share of its host-clock time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, copies); the aten ops that launch
    # them carry the same device time again
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    busy_us = sum(e.self_device_time_total for e in rows)
    if not busy_us:
        log(f"profile {label}: device time not measured")
        return
    log(f"profile {label}: host {wall_us / 1e3:.3f} ms, device "
        f"busy {busy_us / 1e3:.3f} ms, idle share "
        f"{1 - busy_us / wall_us:.3f}")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:4d}x "
            f"{e.key[:90]}")


def set_attention_kernel(trainer, use_kernel):
    from tartangan_torch.models.attention import SelfAttention2d
    for model in (trainer.state.g, trainer.state.d):
        for m in model.modules():
            if isinstance(m, SelfAttention2d):
                m.use_kernel = use_kernel


def phase_train(dev):
    """Train full-width '512thin' for 3 steps through the trainer's entry
    points; B 64, or B 32 if B 64 does not fit."""
    from tartangan_torch.data.synthetic import make_archive
    TRAIN_DIR.mkdir(parents=True, exist_ok=True)
    archive = TRAIN_DIR / "tartans512.npy"
    t0 = time.perf_counter()
    images = make_archive(192, 512, seed=0)
    np.save(archive, images)
    log(f"train: wrote a {images.shape} uint8 synthetic tartan archive "
        f"({images.nbytes / 1e6:.0f} MB) in {time.perf_counter() - t0:.1f} s")
    del images
    try:
        return run_training(archive, 64)
    except torch.cuda.OutOfMemoryError:
        log("train: '512thin' at B 64 float32 does NOT fit in device "
            "memory; running B 32 instead")
    gc.collect()
    torch.cuda.empty_cache()
    return run_training(archive, 32)


def run_training(archive, batch_size):
    from tartangan_torch import serve
    from tartangan_torch.ops.attention import attention, attention_bwd
    from tartangan_torch.train.cnn import CNNTrainer
    from tartangan_torch.utils import msgpack
    run_id = f"b{batch_size}"
    out_root = TRAIN_DIR / "out"
    shutil.rmtree(out_root / run_id, ignore_errors=True)
    trainer = CNNTrainer.create_from_cli([
        str(archive), "--config", "512thin", "--batch-size", str(batch_size),
        "--epochs", "1", "--dtype", "f32", "--device", "cuda", "--run-id",
        run_id, "--output", str(out_root), "--log-iters", "1",
        "--log-progress-newlines"])
    per_step = []
    train_batch = trainer.train_batch

    def counted(batch):
        before = (attention.launches, attention_bwd.launches)
        metrics = train_batch(batch)
        per_step.append((attention.launches - before[0],
                         attention_bwd.launches - before[1]))
        return metrics
    trainer.train_batch = counted

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attention.launches = attention_bwd.launches = 0
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"attention_fwd": attention.launches,
                "attention_bwd": attention_bwd.launches}
    peak = torch.cuda.max_memory_allocated()

    steps = 192 // batch_size
    assert trainer.gan_config.blocks == (128, 128, 128, 64, 32, 16, 8)
    assert trainer.steps == steps, trainer.steps
    losses = {k: [float(v) for v in trainer.logs[k]]
              for k in ("g_loss", "d_loss", "gp")}
    log(f"train: '512thin' B{batch_size} float32, {steps} steps in "
        f"{wall:.1f} s (host clock, sampling and checkpoints included); "
        f"losses {losses}; K1/K2 launches per step {per_step}; in the "
        f"whole run {launches}; peak device memory "
        f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)")
    for k, vals in losses.items():
        assert len(vals) == steps and all(np.isfinite(vals)), (k, vals)
    if per_step != [(K1_PER_STEP, K2_PER_STEP)] * steps:
        raise AssertionError(f"expected ({K1_PER_STEP}, {K2_PER_STEP}) "
                             f"K1/K2 launches per step, got {per_step}")
    run_dir = out_root / run_id
    ckpt = run_dir / "checkpoints" / str(steps)
    for name in ("g", "g_target", "d", "opt_g", "opt_d"):
        assert (ckpt / f"{name}.msgpack").is_file(), name
    opt_d = msgpack.loads((ckpt / "opt_d.msgpack").read_bytes())
    assert sorted(opt_d) == ["0", "1"] and int(opt_d["0"]["count"]) == steps
    assert json.loads((ckpt / "trainer.json").read_text())["steps"] == steps
    assert (run_dir / "samples" / f"grid_sample_{steps}.png").is_file()

    app = serve._ServeApp(serve._ServeApp.parse_cli_args([str(run_dir)]))
    app.load_generator()
    z = np.random.default_rng(8).standard_normal((2, 256)).astype(np.float32)
    imgs = app.generate(z)
    assert imgs.shape == (2, 512, 512, 3) and np.isfinite(imgs).all()
    log(f"train: the port's serve app loaded {ckpt} and generated "
        f"{imgs.shape} on the card")
    return trainer, launches, peak


def hold_step(trainer, dev):
    """One step with the kernels against one with the plain attention,
    from the same fresh state, batch and latents. D's learning rate is 0
    in both: Adam's first step (beta1 = 0) moves each weight by about
    +-lr*sign(g), so a gradient near 0 may flip its sign between two
    correct runs and hand the G step two D's 2*lr apart; with lr 0 the G
    step sees one D, and the comparison is of gradients, not weights."""
    b = trainer.args.batch_size
    batch = torch.from_numpy(trainer.dataset.images[:b]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    latent = trainer.gan_config.latent_dims
    z_d = torch.randn((1, b, latent), generator=gen, device=dev)
    z_g = torch.randn((b, latent), generator=gen, device=dev)
    results = []
    for use_kernel in (True, False):
        trainer.build_models()  # the same seeded init each time
        for group in trainer.state.opt_d.param_groups:
            group["lr"] = 0.0
        set_attention_kernel(trainer, use_kernel)
        metrics = trainer._train_step(trainer.state, batch, z_d, z_g)
        s = trainer.state
        grads = {name: [opt.state[p]["exp_avg"] for p in model.parameters()]
                 for name, model, opt in (("g", s.g, s.opt_g),
                                          ("d", s.d, s.opt_d))}
        results.append(({k: float(v) for k, v in metrics.items()}, grads))
    set_attention_kernel(trainer, True)
    (m_k, g_k), (m_p, g_p) = results
    log(f"hold step B{b}: kernel {m_k}, plain attention {m_p} "
        f"(tolerance {TOL_STEP_LOSS})")
    for k in m_k:
        np.testing.assert_allclose(m_k[k], m_p[k], **TOL_STEP_LOSS)
    for name in ("g", "d"):
        scale = max(t.abs().max().item() for t in g_p[name])
        err = max((a - r).abs().max().item()
                  for a, r in zip(g_k[name], g_p[name])) / scale
        log(f"hold step B{b}: {name} gradients (Adam mu), max abs error "
            f"over the max-abs {scale:.3e}: {err:.3e} "
            f"(tolerance {TOL_STEP_GRAD})")
        for a, r in zip(g_k[name], g_p[name]):
            torch.testing.assert_close(a / scale, r / scale, **TOL_STEP_GRAD)
    return batch, z_d, z_g


def time_train(trainer, batch, z_d, z_g):
    """The train step's host-clock time, kernel and plain attention in
    turns, synchronized; a profile of one step; its peak memory."""
    def step():
        trainer._train_step(trainer.state, batch, z_d, z_g)
        torch.cuda.synchronize()

    def once(use_kernel):
        set_attention_kernel(trainer, use_kernel)
        t0 = time.perf_counter()
        step()
        return (time.perf_counter() - t0) * 1e3

    once(True)
    once(False)
    kernel, plain = [], []
    for _ in range(4):
        kernel.append(once(True))
        plain.append(once(False))
    set_attention_kernel(trainer, True)
    b = batch.shape[0]
    log(f"time train step '512thin' B{b} float32 (host clock, synchronized, "
        f"4 each in turns after warm-up): kernel median "
        f"{statistics.median(kernel):.3f} ms {[round(t, 3) for t in kernel]}"
        f"; plain attention median {statistics.median(plain):.3f} ms "
        f"{[round(t, 3) for t in plain]}")
    torch.cuda.reset_peak_memory_stats()
    step()
    log(f"train step B{b} peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_call(f"train step B{b}", step)
    return statistics.median(kernel)


# launches per train step on the parity path with R1: each G forward (the
# D step's fakes, the G step) runs K3 twice in each of the 4 parity blocks
# and K4 and K5 once in each of the 2 fused blocks; the backward of all
# three is the plain vector-Jacobian product
K3_PER_STEP, K4_PER_STEP, K5_PER_STEP = 16, 4, 4
PARITY_DIR = ROOT / "build" / "chip_smoke_parity"


def parity_trainer(argv, fused=True):
    """A ``CNNTrainer`` whose G takes the fused blocks as well
    (``g_block_factory(fused=True)``), as benchmarks/probe_parity_step.py
    builds its variants: the CLI has no flag for them."""
    from tartangan_torch.models import factories as F
    from tartangan_torch.models.pluggan import Generator
    from tartangan_torch.train.cnn import CNNTrainer

    class FusedGTrainer(CNNTrainer):
        def build_generator(self):
            a = self.args
            return Generator(
                self.gan_config,
                input_factory=F.g_input_factory(a.g_base, a.activation),
                block_factory=F.g_block_factory(
                    a.norm, a.activation, fused=fused,
                    parity=F.resolve_parity(a.parity_blocks)),
                output_factory=F.g_output_factory(a.norm, a.activation))

    return FusedGTrainer.create_from_cli(argv)


def parity_counters():
    from tartangan_torch.ops.attention import attention, attention_bwd
    from tartangan_torch.ops.gblock import gblock_a, gblock_b
    from tartangan_torch.ops.parity_conv import merged_tap_conv
    return {"attention_fwd": attention, "attention_bwd": attention_bwd,
            "parity_conv": merged_tap_conv, "gblock_a": gblock_a,
            "gblock_b": gblock_b}


def phase_parity_train(archive):
    """Train full-width '512thin' at B 64 with --parity-blocks on,
    ``FUSED_G`` and the fused G blocks for 3 steps through the trainer's
    entry points; check the losses, the launches per step and the
    checkpoint's layout."""
    from tartangan_torch.models.blocks import (
        FusedResidualGeneratorBlock,
        ParityResidualDiscriminatorBlock,
        ParityResidualGeneratorBlock,
    )
    from tartangan_torch.ops import parity as P
    from tartangan_torch.utils import msgpack
    P.FUSED_G = True
    out_root = PARITY_DIR / "out"
    shutil.rmtree(out_root, ignore_errors=True)
    trainer = parity_trainer([
        str(archive), "--config", "512thin", "--parity-blocks", "on",
        "--batch-size", "64", "--epochs", "1", "--dtype", "f32", "--device",
        "cuda", "--run-id", "parity", "--output", str(out_root),
        "--log-iters", "1", "--log-progress-newlines"])
    counters = parity_counters()
    per_step = []
    train_batch = trainer.train_batch

    def counted(batch):
        before = {k: f.launches for k, f in counters.items()}
        metrics = train_batch(batch)
        per_step.append({k: f.launches - before[k]
                         for k, f in counters.items()})
        return metrics
    trainer.train_batch = counted

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f in counters.values():
        f.launches = 0
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    peak = torch.cuda.max_memory_allocated()

    g, d = trainer.state.g, trainer.state.d
    kinds = [type(b).__name__ for b in g.blocks]
    assert kinds == ["ResidualGeneratorBlock"] + \
        ["FusedResidualGeneratorBlock"] * 2 + \
        ["ParityResidualGeneratorBlock", "SelfAttention2d"] + \
        ["ParityResidualGeneratorBlock"] * 3, kinds
    assert sum(isinstance(b, ParityResidualDiscriminatorBlock)
               for b in d.blocks) == 4
    assert isinstance(g.blocks[1], FusedResidualGeneratorBlock)
    assert isinstance(g.blocks[-1], ParityResidualGeneratorBlock)
    steps = 192 // 64
    losses = {k: [float(v) for v in trainer.logs[k]]
              for k in ("g_loss", "d_loss", "gp")}
    log(f"parity train: '512thin' B64 float32 --parity-blocks on, FUSED_G, "
        f"fused G blocks; G blocks {kinds}; {steps} steps in {wall:.1f} s "
        f"(host clock, sampling and checkpoints included); losses {losses}; "
        f"launches per step {per_step}; in the whole run {launches}; peak "
        f"device memory {peak / 2**30:.2f} GiB")
    for k, vals in losses.items():
        assert len(vals) == steps and all(np.isfinite(vals)), (k, vals)
    want = {"attention_fwd": K1_PER_STEP, "attention_bwd": K2_PER_STEP,
            "parity_conv": K3_PER_STEP, "gblock_a": K4_PER_STEP,
            "gblock_b": K5_PER_STEP}
    if per_step != [want] * steps:
        raise AssertionError(f"expected {want} launches per step, got "
                             f"{per_step}")
    ckpt = out_root / "parity" / "checkpoints" / str(steps)
    tree = msgpack.loads((ckpt / "g.msgpack").read_bytes())
    fused = tree["params"]["blocks_1"]
    assert np.shape(fused["conv1_kernel"]) == (3, 3, 128, 128)
    assert sorted(tree["batch_stats"]["blocks_1"]) == [
        "bn1_mean", "bn1_var", "bn2_mean", "bn2_var"]
    par = tree["params"]["blocks_3"]
    assert np.shape(par["Conv_0"]["kernel"]) == (3, 3, 128, 64)
    assert "scale" in par["NormAct_1"]["BatchNorm_0"]["BatchNorm_0"]
    opt_g = msgpack.loads((ckpt / "opt_g.msgpack").read_bytes())
    assert np.shape(opt_g["0"]["mu"]["blocks_2"]["conv2_kernel"]) == \
        (3, 3, 128, 128)
    assert int(opt_g["0"]["count"]) == steps
    log(f"parity train: checkpoint {ckpt} is in the JAX layout (fused "
        f"blocks' flat HWIO kernels and bn*_mean/var, parity blocks' plain "
        f"trees, optax Adam state)")
    return trainer, {k: launches[k] for k in ("parity_conv", "gblock_a",
                                              "gblock_b")}, per_step


def plain_state_from_fused(state):
    """A generator state_dict with fused blocks -> the plain blocks' names
    (the fused block's flat tree is the plain block's, renamed)."""
    names = {"conv1_kernel": "Conv_0.weight", "conv1_bias": "Conv_0.bias",
             "conv2_kernel": "Conv_1.weight", "conv2_bias": "Conv_1.bias",
             "bn1_scale": "NormAct_0.BatchNorm_0.weight",
             "bn1_bias": "NormAct_0.BatchNorm_0.bias",
             "bn1_mean": "NormAct_0.BatchNorm_0.running_mean",
             "bn1_var": "NormAct_0.BatchNorm_0.running_var",
             "bn2_scale": "NormAct_1.BatchNorm_0.weight",
             "bn2_bias": "NormAct_1.BatchNorm_0.bias",
             "bn2_mean": "NormAct_1.BatchNorm_0.running_mean",
             "bn2_var": "NormAct_1.BatchNorm_0.running_var",
             "project_kernel": "project_input.weight",
             "project_bias": "project_input.bias"}
    out = {}
    for key, value in state.items():
        head, _, leaf = key.rpartition(".")
        out[f"{head}.{names[leaf]}" if leaf in names else key] = value
    return out


def set_fused_kernels(trainer, use_kernel):
    from tartangan_torch.models.blocks import FusedResidualGeneratorBlock
    from tartangan_torch.ops import parity as P
    P.FUSED_G = use_kernel
    for m in trainer.state.g.modules():
        if isinstance(m, FusedResidualGeneratorBlock):
            m.use_kernel = use_kernel


def _step_grads(trainer, batch, z_d, z_g, plain_names=False):
    """One step from the trainer's current fresh state with D's learning
    rate 0; (metrics, {name: gradient as Adam's mu})."""
    for group in trainer.state.opt_d.param_groups:
        group["lr"] = 0.0
    metrics = trainer._train_step(trainer.state, batch, z_d, z_g)
    s = trainer.state
    grads = {}
    for tag, model, opt in (("g", s.g, s.opt_g), ("d", s.d, s.opt_d)):
        named = {f"{tag}.{n}": opt.state[p]["exp_avg"]
                 for n, p in model.named_parameters()}
        grads.update(plain_state_from_fused(named) if plain_names else named)
    return {k: float(v) for k, v in metrics.items()}, grads


def _hold(label, a, b, witness=None):
    """Log one step against another: the losses are held at
    TOL_STEP_LOSS, and with ``witness`` (errors of other steps against the
    same reference) the gradients too (see TOL_PARITY_STEP_GRAD).
    Returns ({"g"/"d": {"max": ..., "norm": ...}}, [what failed])."""
    (m_a, g_a), (m_b, g_b) = a, b
    failed = []
    log(f"hold {label}: {m_a} vs {m_b} (tolerance {TOL_STEP_LOSS})")
    for k in m_a:
        if not np.isclose(m_a[k], m_b[k], **TOL_STEP_LOSS):
            failed.append(f"{label}: {k}")
    assert sorted(g_a) == sorted(g_b)
    errs = {}
    for tag in ("g", "d"):
        keys = [k for k in g_b if k.startswith(tag + ".")]
        scale = max(g_b[k].abs().max().item() for k in keys)
        by_key = {k: (g_a[k] - g_b[k]).abs().max().item() / scale
                  for k in keys}
        diff2 = sum((g_a[k] - g_b[k]).square().sum().item() for k in keys)
        norm2 = sum(g_b[k].square().sum().item() for k in keys)
        errs[tag] = {"max": max(by_key.values()),
                     "norm": (diff2 / norm2) ** 0.5}
        tol = None if witness is None else {
            k: max(v, PARITY_WITNESS_FACTOR * witness[tag][k])
            for k, v in TOL_PARITY_STEP_GRAD.items()}
        worst = sorted(by_key, key=by_key.get)[-3:][::-1]
        log(f"hold {label}: {tag} gradients (Adam mu), max-abs {scale:.3e}:"
            f" max abs error over it {errs[tag]['max']:.3e}, norm of the "
            f"difference over the norm {errs[tag]['norm']:.3e} (tolerance "
            f"{tol if tol else 'none: logged'}); largest in "
            + ", ".join(f"{k} {by_key[k]:.2e}" for k in worst))
        if tol and any(errs[tag][k] > tol[k] for k in tol):
            failed.append(f"{label}: {tag} gradients")
    return errs, failed


def merged_tap_in_g(trainer):
    """Hooks that turn ``ops.parity.MERGED_TAP`` on for G's forwards only
    (autograd records the form, so G's backward follows it); returns the
    handles to remove."""
    from tartangan_torch.ops import parity as P

    def on(*_):
        P.MERGED_TAP = True

    def off(*_):
        P.MERGED_TAP = False
    g = trainer.state.g
    return [g.register_forward_pre_hook(on), g.register_forward_hook(off)]


@contextlib.contextmanager
def layout_copies():
    """Within the block ``ops.parity.conv2d`` (and its users' imports of
    it) copies its input to contiguous NCHW on the card too, as it does on
    the CPU."""
    import torch.nn.functional as F

    from tartangan_torch.ops import gblock as G
    from tartangan_torch.ops import parity as P
    from tartangan_torch.ops import parity_conv as PC
    conv2d = P.conv2d

    def copying_conv2d(x, w, b=None, **kwargs):
        return F.conv2d(x.contiguous(), w, b, **kwargs)
    for mod in (P, G, PC):
        mod.conv2d = copying_conv2d
    try:
        yield
    finally:
        for mod in (P, G, PC):
            mod.conv2d = conv2d


FORMS = "parity, FUSED_G off and plain K4/K5"
MERGED = FORMS + ", G's parity convs merged-tap"


def _step_grads_f64(plain, batch, z_d, z_g):
    """The plain trainer's step in float64 from its current fresh state:
    the witness. The attention runs its plain version, whose softmax stays
    float32; at init its gamma is 0, so that reaches no other gradient."""
    from tartangan_torch.train.cnn import make_cnn_train_step
    set_attention_kernel(plain, False)
    s, a = plain.state, plain.args
    for model in (s.g, s.g_target, s.d):
        model.double()
    plain._train_step = make_cnn_train_step(
        grad_penalty=a.grad_penalty, ema_factor=a.lr_target_g,
        dtype=torch.float64, iters_d=a.iters_d, r1_interval=a.r1_interval)
    return _step_grads(plain, batch, z_d.double(), z_g.double())


def hold_parity(trainer, dev, batch, z_d, z_g):
    """G's and D's forwards on the parity path against the plain ones on
    the same weights, and each against the plain G in float64; then one
    step each from the same state, batch and latents: the parity path with
    the kernels, the same with FUSED_G off and the fused blocks on their
    plain versions (and with merged-tap convs in G), the plain '512thin'
    step (and with channels_last weights), each against the plain step in
    float64 (see TOL_PARITY_STEP_GRAD). Returns the plain trainer."""
    from tartangan_torch.train.cnn import CNNTrainer
    trainer.build_models()
    init = {k: copy.deepcopy(m.state_dict()) for k, m in
            (("g", trainer.state.g), ("d", trainer.state.d))}
    steps = {}
    set_fused_kernels(trainer, True)
    steps["parity, kernels"] = _step_grads(trainer, batch, z_d, z_g,
                                           plain_names=True)
    for label in (FORMS, MERGED):
        trainer.build_models()
        set_fused_kernels(trainer, False)
        hooks = merged_tap_in_g(trainer) if label == MERGED else []
        steps[label] = _step_grads(trainer, batch, z_d, z_g,
                                   plain_names=True)
        for hook in hooks:
            hook.remove()
    set_fused_kernels(trainer, True)

    plain = CNNTrainer.create_from_cli([
        str(TRAIN_DIR / "tartans512.npy"),
        "--config", "512thin", "--parity-blocks", "off", "--batch-size",
        str(batch.shape[0]), "--dtype", "f32", "--device", "cuda",
        "--run-id", "plain", "--output", str(PARITY_DIR / "out")])

    def load_plain():
        plain.build_models()
        plain.state.g.load_state_dict(plain_state_from_fused(init["g"]))
        plain.state.d.load_state_dict(init["d"])

    load_plain()
    trainer.build_models()
    z = torch.randn((16, 256), generator=torch.Generator(device=dev)
                    .manual_seed(13), device=dev)
    with torch.no_grad():
        out_par = trainer.state.g(z, train=True)
        out_plain = plain.state.g(z, train=True)
        logit_par = trainer.state.d(out_plain, train=True)
        logit_plain = plain.state.d(out_plain, train=True)
    torch.cuda.synchronize()
    err = (out_par - out_plain).abs().max().item()
    err_d = (logit_par - logit_plain).abs().max().item()
    log(f"hold parity G (kernels) vs plain G, same weights, B16 forward: "
        f"max_abs_err {err:.3e}; parity D vs plain D logits: max_abs_err "
        f"{err_d:.3e} over max-abs {logit_plain.abs().max().item():.3e} "
        f"(tolerance {TOL_G})")
    torch.testing.assert_close(out_par, out_plain, **TOL_G)
    torch.testing.assert_close(logit_par / logit_plain.abs().max(),
                               logit_plain / logit_plain.abs().max(), **TOL_G)
    # the same forward in float64 on the plain G, and each variant against
    # it (logged)
    outs = {"parity, kernels": out_par, "plain": out_plain}
    for label in (FORMS, MERGED):
        trainer.build_models()
        set_fused_kernels(trainer, False)
        hooks = merged_tap_in_g(trainer) if label == MERGED else []
        with torch.no_grad():
            outs[label] = trainer.state.g(z, train=True)
        for hook in hooks:
            hook.remove()
    set_fused_kernels(trainer, True)
    set_attention_kernel(plain, False)
    plain.state.g.double()
    with torch.no_grad():
        out64 = plain.state.g(z.double(), train=True)
    for label, out in outs.items():
        diff = out.double() - out64
        log(f"G forward B16, {label} vs float64: max abs {diff.abs().max():.3e}"
            f", mean abs {diff.abs().mean():.3e}, mean {diff.mean():.3e}")
    del outs, out64
    load_plain()
    steps["plain"] = _step_grads(plain, batch, z_d, z_g)
    load_plain()
    for model in (plain.state.g, plain.state.d):
        model.to(memory_format=torch.channels_last)  # other cuDNN kernels
    steps["plain, channels_last weights"] = _step_grads(plain, batch, z_d,
                                                        z_g)
    load_plain()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    exact = _step_grads_f64(plain, batch, z_d, z_g)
    log(f"the plain step in float64 took {time.perf_counter() - t0:.1f} s, "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB")
    load_plain()
    # the float32 steps without the kernels against float64: their spread
    witnesses, failed = {}, []
    for label, step in steps.items():
        if label != "parity, kernels":
            witnesses[label], f = _hold(f"witness: {label} vs float64",
                                        step, exact)
            failed += f
    spread = {tag: {k: max(w[tag][k] for w in witnesses.values())
                    for k in ("max", "norm")} for tag in ("g", "d")}
    failed += _hold("parity, kernels vs float64", steps["parity, kernels"],
                    exact, spread)[1]
    # the direct comparisons, logged (held through float64 above) but for
    # the losses
    for label in (FORMS, "plain"):
        failed += _hold(f"parity, kernels vs {label}",
                        steps["parity, kernels"], steps[label])[1]
    failed += hold_smooth_step(batch, z_d, z_g)
    if failed:
        raise AssertionError(f"parity holds failed: {failed}")
    return plain


def hold_smooth_step(batch, z_d, z_g):
    """The plain '512thin' step with a smooth activation (elu), float32
    against float64: without leaky-relu's kink the float32 step is held
    within TOL_PARITY_STEP_GRAD of float64. Returns what failed."""
    from tartangan_torch.train.cnn import CNNTrainer
    smooth = CNNTrainer.create_from_cli([
        str(TRAIN_DIR / "tartans512.npy"),
        "--config", "512thin", "--activation", "elu", "--batch-size",
        str(batch.shape[0]), "--dtype", "f32", "--device", "cuda",
        "--run-id", "elu", "--output", str(PARITY_DIR / "out")])
    smooth.build_models()
    step32 = _step_grads(smooth, batch, z_d, z_g)
    smooth.build_models()
    step64 = _step_grads_f64(smooth, batch, z_d, z_g)
    zero = {tag: {"max": 0.0, "norm": 0.0} for tag in ("g", "d")}
    return _hold("plain step with elu, float32 vs float64", step32, step64,
                 zero)[1]


def time_parity_step(trainer, plain, batch, z_d, z_g):
    """The parity step and the plain step, in turns (host clock,
    synchronized), and a third turn of the parity step with the layout
    copies that ``ops.parity.conv2d`` makes on the CPU made on the card as
    well (its cost); the parity step's peak memory and profile."""
    def once(t, copies=False):
        with layout_copies() if copies else contextlib.nullcontext():
            t0 = time.perf_counter()
            t._train_step(t.state, batch, z_d, z_g)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

    once(trainer)
    once(trainer, copies=True)
    once(plain)
    par, pl, cp = [], [], []
    for _ in range(3):
        pl.append(once(plain))
        par.append(once(trainer))
        cp.append(once(trainer, copies=True))
    log(f"time train step '512thin' B{batch.shape[0]} float32 (host clock, "
        f"synchronized, 3 each in turns after warm-up): parity path "
        f"(--parity-blocks on, FUSED_G, fused G blocks) median "
        f"{statistics.median(par):.3f} ms {[round(t, 3) for t in par]}; "
        f"plain path median {statistics.median(pl):.3f} ms "
        f"{[round(t, 3) for t in pl]}; parity path with a contiguous NCHW "
        f"copy before each of its convs median {statistics.median(cp):.3f} "
        f"ms {[round(t, 3) for t in cp]}")
    torch.cuda.reset_peak_memory_stats()
    once(trainer)
    log(f"parity train step peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_call("parity train step B64", lambda: once(trainer))


def _conv_bound_ms(macs, nbytes):
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, 2 * macs / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def time_parity_kernels(dev, launches, errs):
    """K3 at the eight shapes of one '512thin' G forward and K4/K5 at the
    two fused blocks' shapes: kernel, plain version, the library call (K3:
    ``F.conv2d`` of the 3x3-packed form) and the bound; each summed over the
    launches of one G forward for the kernels line."""
    import torch.nn.functional as F

    from tartangan_torch.ops import gblock as G
    from tartangan_torch.ops import parity as P
    from tartangan_torch.ops.parity_conv import (
        fused_parity_conv_plain,
        merged_tap_conv,
    )
    gen = torch.Generator(device=dev).manual_seed(14)
    # per kernel: kernel ms, plain ms, library ms, GFLOP, bytes
    totals = {k: [0.0] * 5 for k in ("parity_conv", "gblock_a", "gblock_b")}

    def add_times(name, t, macs, nbytes, lib=0.0):
        tot = totals[name]
        tot[0] += statistics.median([t[1], t[2]])
        tot[1] += statistics.median([t[0], t[3]])
        tot[2] += lib
        tot[3] += macs
        tot[4] += nbytes
    for label, b, h, cin, cout in K3_SHAPES[:4]:
        for mode in ("up", "full"):
            wcin = cin if mode == "up" else cout
            ci = wcin if mode == "up" else 4 * wcin
            x = torch.randn(b, h, h, ci, device=dev, generator=gen)
            w = 0.1 * torch.randn(cout, wcin, 3, 3, device=dev, generator=gen)
            w3 = (P.pack_up_conv if mode == "up" else P.pack_full_conv)(w)
            xc = x.permute(0, 3, 1, 2)
            it = 5 if h >= 128 else 20
            t = [cuda_ms(lambda: fused_parity_conv_plain(x, w, cout, mode),
                         iters=it),
                 cuda_ms(lambda: merged_tap_conv(x, w, cout, mode), iters=it),
                 cuda_ms(lambda: merged_tap_conv(x, w, cout, mode), iters=it),
                 cuda_ms(lambda: fused_parity_conv_plain(x, w, cout, mode),
                         iters=it)]
            lib = cuda_ms(lambda: F.conv2d(xc, w3, padding=1), iters=it)
            taps = 16 * wcin if mode == "up" else 36 * wcin
            macs = b * h * h * taps * cout
            nbytes = 4 * (x.numel() + b * h * h * 4 * cout + w.numel())
            bound = _conv_bound_ms(macs, nbytes)
            log(f"time parity_conv '{mode}' {label} x {tuple(x.shape)}: "
                f"kernel {t[1]:.4f}/{t[2]:.4f} ms, plain {t[0]:.4f}/{t[3]:.4f}"
                f" ms, F.conv2d 3x3-packed {lib:.4f} ms, bound {bound[0]:.4f} "
                f"ms ({bound[1]}, {2 * macs / 1e9:.2f} GFLOP)")
            add_times("parity_conv", t, macs, nbytes, lib)
            del x, xc
    for label, b, h, cin, cout in GBLOCK_SHAPES[:2]:
        p = gblock_params(cin, cout, dev, gen)
        x = torch.randn(b, h, h, cin, device=dev, generator=gen)
        m1, v1 = G._moments(x)
        y1p, st = G.gblock_a_plain(x, m1, v1, p["s1"], p["o1"], p["w1"],
                                   p["b1"])
        n = 4 * b * h * h
        m2 = st.reshape(2, 4, cout).sum(1)[0] / n
        v2 = st.reshape(2, 4, cout).sum(1)[1] / n - m2 ** 2
        args_a = (x, m1, v1, p["s1"], p["o1"], p["w1"], p["b1"])
        args_b = (y1p, x, m2, v2, p["s2"], p["o2"], p["w2"], p["b2"],
                  p["wp"], p["bp"])
        pos = b * h * h
        # the shortcut's 4*Cin*Cout MACs a position count only with a
        # projection; the identity (both fused blocks) is an add of x, whose
        # bytes are counted
        short = 0 if torch.equal(p["wp"], torch.eye(cin, device=dev)) \
            else 4 * cin
        for name, kern, plain, args, macs, nbytes in (
                ("gblock_a", G.gblock_a, G.gblock_a_plain, args_a,
                 pos * 16 * cin * cout, 4 * (x.numel() + y1p.numel())),
                ("gblock_b", G.gblock_b, G.gblock_b_plain, args_b,
                 pos * (36 * cout + short) * cout,
                 4 * (2 * y1p.numel() + x.numel()))):
            t = [cuda_ms(lambda: plain(*args)), cuda_ms(lambda: kern(*args)),
                 cuda_ms(lambda: kern(*args)), cuda_ms(lambda: plain(*args))]
            bound = _conv_bound_ms(macs, nbytes)
            log(f"time {name} {label} x {tuple(x.shape)} Cout {cout}: kernel "
                f"{t[1]:.4f}/{t[2]:.4f} ms, plain {t[0]:.4f}/{t[3]:.4f} ms, "
                f"bound {bound[0]:.4f} ms ({bound[1]}, {2 * macs / 1e9:.2f} "
                f"GFLOP)")
            add_times(name, t, macs, nbytes)
    records = []
    for name, src, replaces in (
            ("parity_conv", "parity_conv.cu",
             "tartangan_tpu/ops/pallas/parity_conv.py:99"),
            ("gblock_a", "gblock.cu", "tartangan_tpu/ops/pallas/gblock.py:196"),
            ("gblock_b", "gblock.cu",
             "tartangan_tpu/ops/pallas/gblock.py:234")):
        ms, plain_ms, lib, macs, nbytes = totals[name]
        bound_ms, bound_by = _conv_bound_ms(macs, nbytes)
        records.append({
            "name": name, "route": "cuda",
            "source": f"tartangan_torch/csrc/{src}", "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": lib if name == "parity_conv" else None})
        log(f"kernels line {name}: summed over the launches of one G "
            f"forward: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms" + (f", F.conv2d {lib:.4f} ms"
                                    if name == "parity_conv" else ""))
    return records


def time_attention(dev, launches, errs):
    """K1 and K2 at the training shapes: kernel, plain version, the
    library call and the bound; the records of the kernels line."""
    import torch.nn.functional as F

    from tartangan_torch.ops.attention import (attention, attention_bwd,
                                               attention_bwd_plain,
                                               attention_plain)
    gen = torch.Generator(device=dev).manual_seed(9)
    records = {}
    for label, b, lq, lk, ck, cv in (("G", 64, 4096, 1024, 8, 32),
                                     ("D", 64, 1024, 256, 8, 32)):
        q, k, v, do = (torch.randn(s, device=dev, generator=gen)
                       for s in ((b, lq, ck), (b, lk, ck), (b, lk, cv),
                                 (b, lq, cv)))
        shape = f"{label} train B{b} Lq{lq} Lk{lk} Ck{ck} Cv{cv} float32"
        fwd = [cuda_ms(lambda: attention_plain(q, k, v)),
               cuda_ms(lambda: attention(q, k, v)),
               cuda_ms(lambda: attention(q, k, v)),
               cuda_ms(lambda: attention_plain(q, k, v))]
        fwd_lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=1.0))
        fwd_bound = attention_bound_ms(b, lq, lk, ck, cv, 4)
        log(f"time attention_fwd {shape}: kernel {fwd[1]:.4f}/{fwd[2]:.4f} "
            f"ms, plain {fwd[0]:.4f}/{fwd[3]:.4f} ms, sdpa {fwd_lib:.4f} ms,"
            f" bound {fwd_bound[0]:.4f} ms ({fwd_bound[1]})")
        bwd = [cuda_ms(lambda: attention_bwd_plain(q, k, v, do), iters=5),
               cuda_ms(lambda: attention_bwd(q, k, v, do), iters=5),
               cuda_ms(lambda: attention_bwd(q, k, v, do), iters=5),
               cuda_ms(lambda: attention_bwd_plain(q, k, v, do), iters=5)]
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, scale=1.0)
        bwd_lib = cuda_ms(lambda: torch.autograd.grad(
            out, leaves, do, retain_graph=True), iters=5)
        bwd_bound = attention_bound_ms(b, lq, lk, ck, cv, 4, backward=True)
        log(f"time attention_bwd {shape}: kernel {bwd[1]:.4f}/{bwd[2]:.4f} "
            f"ms, plain {bwd[0]:.4f}/{bwd[3]:.4f} ms, sdpa backward "
            f"{bwd_lib:.4f} ms, bound {bwd_bound[0]:.4f} ms ({bwd_bound[1]})")
        if label == "G":
            for name, src, line, t, lib, bound in (
                    ("attention_fwd", "attention_fwd.cu", 41, fwd, fwd_lib,
                     fwd_bound),
                    ("attention_bwd", "attention_bwd.cu", 164, bwd, bwd_lib,
                     bwd_bound)):
                records[name] = {
                    "name": name, "route": "cuda",
                    "source": f"tartangan_torch/csrc/{src}",
                    "replaces": f"tartangan_tpu/ops/pallas/attention.py:{line}",
                    "launches": launches[name], "max_abs_err": errs[name],
                    "ms": statistics.median([t[1], t[2]]),
                    "plain_ms": statistics.median([t[0], t[3]]),
                    "bound_ms": bound[0], "bound_by": bound[1],
                    "library_ms": lib,
                }
        del q, k, v, do, leaves, out
    return [records["attention_fwd"], records["attention_bwd"]]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    try:
        from tartangan_torch.ops import build
    except ImportError as e:
        print(f"chip_smoke: the tartangan_torch package is missing ({e})",
              file=sys.stderr)
        return 1
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda")
        smi = nvidia_smi_line()
        log(f"device: {torch.cuda.get_device_name(0)} x "
            f"{torch.cuda.device_count()}; nvidia-smi: {smi}; torch "
            f"{torch.__version__}, CUDA {torch.version.cuda}")

        t0 = time.perf_counter()
        logs = build.build()
        log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs)}")
        for name, text in logs.items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")

        errs = phase_kernels(dev)
        perrs = phase_parity_kernels(dev)
        app, serve_launches = phase_serve()
        check_generator(app)
        phase_times(app, dev)
        del app
        trainer, launches, _ = phase_train(dev)
        log(f"serve path launches {serve_launches}; train path launches "
            f"{launches} (the kernels line counts the train path)")
        batch, z_d, z_g = hold_step(trainer, dev)
        time_train(trainer, batch, z_d, z_g)
        del trainer, batch
        gc.collect()
        torch.cuda.empty_cache()
        records = time_attention(dev, launches, errs)

        par, par_launches, _ = phase_parity_train(TRAIN_DIR / "tartans512.npy")
        log(f"parity path launches {par_launches} (the kernels line counts "
            f"K3-K5 on this path)")
        batch = torch.from_numpy(par.dataset.images[:64]).to(dev)
        gen = torch.Generator(device=dev).manual_seed(7)
        z_d = torch.randn((1, 64, 256), generator=gen, device=dev)
        z_g = torch.randn((64, 256), generator=gen, device=dev)
        plain = hold_parity(par, dev, batch, z_d, z_g)
        time_parity_step(par, plain, batch, z_d, z_g)
        del par, plain, batch
        gc.collect()
        torch.cuda.empty_cache()
        records += time_parity_kernels(dev, par_launches, perrs)
    except Exception:  # report the failing phase, then exit non-zero
        traceback.print_exc()
        return 1
    print(json.dumps({"kernels": records}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
