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
   the serving path's shapes and more, with the tolerances stated below.
   TF32 is off for matmuls and convolutions in the whole script, so float32
   references are full float32.
4. serve: writes a full-width '512thin' generator (random weights from a
   seeded ``torch.Generator``, every attention ``gamma`` nonzero) as a run
   directory in the JAX trainer's layout, serves it in-process with
   ``tartangan_torch.serve``'s handler, fetches ``/meta``, ``/``,
   ``/generate`` and ``/grid``, checks the PNGs, and checks that the
   requests launched the attention kernel. Then holds the served
   generator against itself on the plain attention, and against a CPU run.
   Times the served requests (host clock, after warm-up).
5. times: kernel, plain version, one PyTorch library call and the bound, at
   the serving shape; ``generate`` latency at B = 1 and B = 25, each with a
   profile of device time by kernel and the device's idle share.

The last three lines of standard output are a ``{"kernels": [...]}`` JSON
line, the ``nvidia-smi`` name/power-limit line and the result line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import copy
import json
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


def attention_bound_ms(b, lq, lk, ck, cv, itemsize):
    """Least time for the attention on an H100: each input read once and the
    output written once, against 2*B*Lq*Lk*(Ck+Cv) float32 FLOPs."""
    nbytes = itemsize * (b * lq * ck + b * lk * ck + b * lk * cv + b * lq * cv)
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
    return worst


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


def phase_times(app, dev, launches, errs):
    import torch.nn.functional as F

    from tartangan_torch.ops.attention import attention, attention_plain
    records = []
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
        ms_kernel = statistics.median([ms_kernel_a, ms_kernel_b])
        ms_plain = statistics.median([ms_plain_a, ms_plain_b])
        log(f"time attention_fwd B{b} Lq{lq} Lk{lk} Ck{ck} Cv{cv} "
            f"{str(dtype)[6:]}: kernel {ms_kernel_a:.4f}/{ms_kernel_b:.4f} ms,"
            f" plain {ms_plain_a:.4f}/{ms_plain_b:.4f} ms, sdpa {ms_lib:.4f} "
            f"ms, bound {bound:.4f} ms ({bound_by})")
        if dtype == torch.float32:
            records.append({
                "name": "attention_fwd", "route": "cuda",
                "source": "tartangan_torch/csrc/attention_fwd.cu",
                "replaces": "tartangan_tpu/ops/pallas/attention.py:41",
                "launches": launches["attention_fwd"],
                "max_abs_err": errs["attention_fwd"],
                "ms": ms_kernel, "plain_ms": ms_plain, "bound_ms": bound,
                "bound_by": bound_by, "library_ms": ms_lib,
            })

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
    return records


def profile_generate(app, z):
    """Device time by kernel for one ``generate`` call, and the device's
    idle share of its host-clock time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    app.generate(z)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        app.generate(z)
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, copies); the aten ops that launch
    # them carry the same device time again
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    busy_us = sum(e.self_device_time_total for e in rows)
    if not busy_us:
        log(f"profile generate B{len(z)}: device time not measured")
        return
    log(f"profile generate B{len(z)}: host {wall_us / 1e3:.3f} ms, device "
        f"busy {busy_us / 1e3:.3f} ms, idle share "
        f"{1 - busy_us / wall_us:.3f}")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:4d}x "
            f"{e.key[:90]}")


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
        app, launches = phase_serve()
        check_generator(app)
        records = phase_times(app, dev, launches, errs)
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
