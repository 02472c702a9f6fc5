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
   discriminator's shape. TF32 is off for matmuls and convolutions in the
   whole script, so float32 references are full float32.
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

The last three lines of standard output are a ``{"kernels": [...]}`` JSON
line, the ``nvidia-smi`` name/power-limit line and the result line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

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
