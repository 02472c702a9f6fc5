#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tartangan_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --k1-ab OTHER/attention_fwd.cu [...]
    python3 chip_smoke.py --gblock-ab OTHER_DIR [...]

The second form only builds the kernels and times K1 built from each given
source (the same C entry point, e.g. a parent commit's) against the
checkout's at K1's four main-path shapes (and at G with logits large
enough for many lazy rescales), in turns on the same inputs. The third
does the same for K4 and K5 built from ``gblock.cu`` in each OTHER_DIR (a
source with the checkout's C arguments, or one of the parent commit's,
which took packed weights: its packing then runs in PyTorch as its wrapper
did), at the two '512thin' fused blocks' shapes, with each one's error
against the plain version in float32 and float64; it also measures the
card's TF32 ``mma.sync`` rate, K4/K5's yardstick.

Every kernel time is the kernel's own device time, read from
``torch.profiler`` (the durations of its device events over 20 launches);
the wrapper's time a call (CUDA events around 20 calls: the host's work
between launches and any packing of weights included) stands beside it as
``call_ms``.

Phases, in order; any failure raises and the script exits non-zero without
printing a result:

1. device: needs CUDA (there is no CPU path); prints the card's name and
   power limit as ``nvidia-smi`` reports them.
2. build: compiles every CUDA kernel of the port from the sources in the
   checkout (``tartangan_torch/ops/build.py``), all in parallel.
3. kernels: each kernel against its plain PyTorch version on the card, at
   the serving and training paths' shapes and more, with the tolerances
   stated below (K2 fed from K1's o and lse, as the train step runs it,
   and K1's lse against the plain forward's); then the attention's two
   autograd Functions (K1 forward, K2 backward, the plain vector-Jacobian
   product beneath) against autograd through the plain attention, to
   second order, at the '512thin' discriminator's shape. Then the parity kernels: K3 (merged-tap parity
   conv, both modes, with the bias) at the eight '512thin' G shapes and
   two ragged ones (one non-square across both tile edges), K4
   and K5 (the fused G block) at both fused blocks' shapes (the identity
   shortcut), with a projection and at two ragged shapes, K4's sums too,
   each also against float64 and launched twice for the same bits, and the
   two parity autograd Functions' gradients against autograd through the
   plain forms. K1 also at its
   edges (ragged Lq and Lk, Lk 1, Ck and Cv not multiples of 4, B 1 with
   its keys split over CTAs, logits large enough for many lazy rescales),
   and two launches bit-identical. TF32 is off
   for matmuls and convolutions in the whole script, so float32 references
   are full float32. Then K3, K4 and K5 in bfloat16 (``--dtype bf16``)
   against their bfloat16 plain versions at the same shapes
   (TOL_PARITY_BF16), K4's float32 sums against those of the y1p it
   stored. Then the no-sync check: a forward and backward of
   '512thin''s G and D parity blocks, a fused G block and the attention,
   with K1-K5 on, under ``torch.cuda.set_sync_debug_mode("error")`` after
   a warm-up call.
4. kernel times, before the train phases (after the train steps' long
   profiles the profiler was seen to drop kernel events): device time and
   the wrapper's call, plain version, one PyTorch library call and the
   bound, for K1 at both training shapes (storing lse) and the serving
   shapes (B 25 and B 1), K2 at both training shapes (given o and lse, its
   delta launch included), with the SM clock under K1 and K2 at G; then K3,
   K4 and K5 at the parity path's shapes (``F.conv2d`` of the 3x3-packed
   form with the bias as K3's library call; for K3 also the share of the
   bound and the ratio to ``F.conv2d``; for K4 and K5 the bound of their
   3xTF32 tensor-core products beside the FMA bound, and ``F.conv2d`` of
   the 3x3-packed conv alone as ``conv_only_ms``). Then K1-K5 in
   bfloat16 at the same shapes: device time, plain version, library call
   (SDPA and its backward in bfloat16; ``F.conv2d`` in bfloat16 for K3) and
   the bound against the bfloat16 tensor-core peak.
5. serve: writes a full-width '512thin' generator (random weights from a
   seeded ``torch.Generator``, every attention ``gamma`` nonzero) as a run
   directory in the JAX trainer's layout, serves it in-process with
   ``tartangan_torch.serve``'s handler, fetches ``/meta``, ``/``,
   ``/generate`` and ``/grid``, checks the PNGs, and checks that the
   requests launched the attention kernel. Then holds the served
   generator against itself on the plain attention, and against a CPU run.
   Times the served requests (host clock, after warm-up), and ``generate``
   at B = 1 and B = 25 with a profile each.
6. train: writes a synthetic 512x512 tartan archive (192 images, the
   port's ``data/synthetic.py``) and trains full-width '512thin' for 3
   steps at B = 64, float32, through ``CNNTrainer.create_from_cli`` and
   ``.train()``; checks that every loss is finite, that each step launched
   K1 and K2 the expected number of times, that the final checkpoint is in
   the JAX trainer's layout, and that the port's serve app loads the run
   and generates on the card. Then holds one step with the kernels
   against one with the plain attention, from the same state, batch and
   latents (losses, gp, and the gradients as Adam's first moment), and
   times the step (kernel and plain attention) with a profile of device
   time by kernel and the device's idle share, and its peak memory.
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
   copy before each conv, and with its constants made anew at each call
   as before they were cached), with profiles and the peak memory.
8. parity, bfloat16: the same 3 steps with ``--dtype bf16``; every K1-K5
   launch in bfloat16, as many as in float32; parameters, running
   statistics, Adam's state and the EMA target float32. One step from the
   parity step's state, batch and latents with the kernels, held against
   the plain step in float64 within PARITY_WITNESS_FACTOR times the
   farthest bfloat16 step without the kernels (the parity forms with
   FUSED_G off and the plain K4/K5 and attention; the plain path), losses
   and gradients. The float32 and bfloat16 parity steps timed in turns,
   with images/s, peak memory and a profile each.
9. config '128' (the JAX package's main path, plain blocks, no
   attention) at B 128 in float32 and in bfloat16: 3 steps each through
   the trainer's entry points, finite losses, then the two steps timed in
   turns with images/s, peak memory and a profile each.
10. eval (no TPU kernel on this path: cuDNN and cuBLAS in IEEE float32):
   the port's Inception v3 on the card against the JAX package's output on
   the crc32-keyed fixture weights (``tests/fixtures/
   inception_port_expected.npz``, TOL_INCEPTION_FIXTURE), and on the seed-0
   template with the calibrated statistics against the port's CPU forward
   at B 8 (TOL_INCEPTION_CPU); ``python -m tartangan_torch.eval.moments``
   over 2176 synthetic 128x128 tartans (full-rank covariance); Inception's
   forward at B 128 timed (images/s by device time and host clock, the
   share of its float32 FMA bound from the multiply-adds of its conv
   shapes); then '128' at B 128 for 3 steps with ``--fid --fid-freq 2
   --n-inception-imgs 4096 --metrics-collector tensorboard`` in float32 and
   in bfloat16: the FID finite and >= 0 and read back from the event file;
   the FID closure's wall; 4096 images G -> Inception -> moment sums under
   ``torch.cuda.set_sync_debug_mode("error")`` after a warm-up batch until
   the one readback; the Newton-Schulz FID on the card against the float64
   ``eigh`` form on the same mu and sigma (TOL_FID_NS); the closure's
   parts (G sampling, Inception, moments, Newton-Schulz, IS) timed apart.
11. dispatch (``--device-data``, ``--steps-per-call K`` replayed from
   captured CUDA graphs, ``--profile-dir``/``--timing``, ``--activation
   selu``): '128' at B 128 on the 512x512 archive repeated to 1024 rows
   (128x128 crops gathered on the card), through ``create_from_cli`` and
   ``.train()``: 2 calls of 4 steps in float32 and in bfloat16, each
   trainer's own graph then replayed against the same 4 steps run eagerly
   from one state and one set of draws (``hold_graph``): at the training
   rates bit for bit where eager reproduces itself (bfloat16), else the
   losses and each parameter group's change in norm within
   TOL_GRAPH_TRAINED; with both rates 0 (device tensors the graph reads)
   the losses TOL_STEP_LOSS, the statistics, the EMA target and Adam's
   moments TOL_STEP_GRAD; the losses of the rates-0 run farther than
   TOL_GRAPH_TRAINED from the trained run's; ``make_adam``'s capturable
   Adam against Adam with ``capturable=False``
   over 3 steps on G's parameters (TOL_ADAM); 2 calls of 3 steps with
   ``--r1-interval 2``, R1 (gp > 0) on exactly steps 0, 2 and 4, from 2
   graphs; one call after the capture under
   ``set_sync_debug_mode("error")`` and a profiled one with no
   host-to-device copy. Then '128' timed three ways in bfloat16 (the
   host archive at K = 1 with its pinned copy, ``--device-data`` at K = 1,
   and at K = 4 replayed, twice in turns; float32, timed so in PRs 11-14,
   cut for phase 15's time): per
   step, images/s, and from one more unit the peak memory with the
   graph's pool and the idle share (eager: a profile, with host launch
   calls; a replay: CUDA events). Then the '512thin' parity path of phase
   7 at B 64 with
   ``--device-data --steps-per-call 2`` in float32 and bfloat16: K1-K5's
   device events in one replay twice phase 7's per step, and the replay
   held against eager as above; the bfloat16 path timed at K = 1 against
   K = 2 replayed. Then a
   '128' run with ``--profile-dir --timing --timing-freq 2`` (a trace with
   device kernels, three ``images_per_sec``) and one step with
   ``--activation selu``.

12. remat, '1024', IQN and InfoGAN. With phase 4: K1 and K2 at config
   '1024''s attention shapes (G: B 16, Lq 4096, Lk 1024, Ck 32, Cv 128;
   D: Lq 1024, Lk 256), float32 and bfloat16, held against their plain
   versions with phase 3's tolerances, K1's lse too, the two Functions to
   second order at the D shape, and timed as phase 4 times them. After
   phase 11: '1024' at full width, B 16, ``--dtype bf16``, R1 every step,
   on a synthetic 1024x1024 archive of 64 tartans, 2 steps each through
   ``create_from_cli`` and ``.train()`` (interrupted after the second, as
   Ctrl-C ends a run) without remat and with ``--remat`` under 'full' and
   'convs', and one step under 'dots' (depth cut for phase 15's time):
   finite losses, K1/K2 launches a step (the counts
   set to 0 before each run), peak memory, step time, images/s, and the
   first step's losses within TOL_REMAT_LOSS of the run without remat
   (only the run without remat writes sample PNGs);
   then the largest batch of {32, 48, 64} that 'convs' is reckoned to fit
   from its B 16 peak (FIT_SHARE of the card), 2 steps at it. Then
   ``--remat`` with K3 inside ('512thin', the parity path of phase 7,
   float32, B 64): a step without remat twice (the witness), with
   'convs' and with 'full', from one state, batch and latents: losses,
   gp and gradients held as phase 7 holds them, running statistics equal
   bit for bit, K3 16 launches a step under 'convs' as without remat and
   more under 'full'; then ``--remat convs --steps-per-call 2
   --device-data`` in bfloat16, its graph held against eager
   (``hold_graph``). Then the IQN and InfoGAN trainers, '512thin' B 64
   bfloat16, 3 steps each through the entry points: finite losses (and
   code losses), K1/K2 launches a step, the checkpoint's JAX layout, the
   serve app on the IQN run; the bfloat16 step timed; a float32 step with
   the kernels held against one with the plain attention (phase 6's
   tolerances); one IQN call of 2 steps replayed (taus drawn outside the
   graph) and held against eager.

13. the shared-filter, scene and text trainers. With phase 4: K1 and K2
   at the scene generator's attention ('512thin' with --scene-size 16: the
   fourth block of config.blocks[2:], 256x256 with 16 channels: B 64, Lq
   65536, Lk 16384, Ck 2, Cv 8), float32 and bfloat16: held against their
   plain versions at B 1 (the plain logits take 4 GiB an image) and on the
   last image of a B 64 launch with phase 3's tolerances, K1's lse too,
   two K2 launches equal bit for bit, both also against the same math in
   float64 (logged); timed at B 64 as phase 4 times them, the plain
   version and SDPA at B 1 beside them (SDPA's fused backends, the only
   ones that fit at B 64, take no head of width 2). After phase 12: the
   shared CNN and IQN trainers and the scene trainer with --patch-noise,
   '512thin' B 64 bfloat16, R1 every step, 2 steps each through the entry
   points: finite losses, K1/K2 launches a step, step times, peak memory,
   the checkpoint's JAX layout, a profile of a scene step; a float32 scene
   step at B 2 with the kernels held against one with the plain attention
   (phase 6's tolerances); one scene call of 2 steps replayed and held
   against eager (``hold_graph``). Then the text GAN at config '128' (1-D),
   --embedding-dims 64, B 128, on a seeded corpus the script writes: 4
   steps, the first 2 pretraining the embedding, finite losses, a sample
   file, the checkpoint's ``embedding`` and ``opt_emb``.
14. apps and export, at '512thin' full width on phase 6's run (float32)
   and phase 12's InfoGAN run, through the apps' classes: render_tour and
   continuous_interp (--output-size 256) write their PNGs with one K1
   launch a ``generate`` call; find_image with Adam, B 2, 20 steps on
   G's own image of a seeded latent (the array method: no Pillow on the
   card): the loss falls and K1 (with its lse) and K2 launch once a step;
   one step's loss and gradient w.r.t. z held against the plain
   attention's (phase 6's tolerances); a step timed; L-BFGS for 5 steps
   (K1 and K2 once for the step and once a line-search trial) and --vgg
   (Inception forward and backward at 299) for 3, finite, timed;
   info_encode: one B 32 batch of seeded arrays through the InfoGAN D,
   codes held against the plain attention's, K1 at D's shape, --recon
   written; export.web --onnx at B 1: the ``.pt2`` loaded and run on the
   card launches K1 once and matches ``generate``, the ONNX graph through
   the numpy interpreter matches G's eval-mode output; sizes and times.
   The attention's gamma is set to 0.5 where a held comparison needs it
   to count (3 training steps leave it near its init value, 0).
15. the device mesh, the calibration and the native crop. '512thin' at full
   width, float32 (TF32 off), R1 every step, on 8 of phase 6's tartans:
   the trainer's CLI with --num-devices 1 in a process of its own, 2
   steps; then one step of the global batch of 8 in this process (the
   reference: the trainer's build, its components' train begin and its
   step, the draws of the entry points), on 2 gloo ranks sharing the card
   (``parallel.mesh.launch``, dp 2, through ``.train()``), on the same 2
   ranks re-grouped with --tp 2, and through the mesh path on an NCCL
   group of one in this process: each held against the reference at
   TOL_MESH (the JAX package's mesh tolerances, and both towers'
   gradients against the reference's), every rank launching K1
   and K2 as the reference's step does (counted in the step), the step and
   one more timed (tp 2: the step); a one-process trainer resumes the dp-2
   run's checkpoint bit for bit. Then ``eval.calibrate`` on phase
   10's 2176 128px tartans at B 16, every level, and its CLI with
   --validate --validate-n 256 (the three FIDs finite and ordered, the
   seconds); then the native crop batcher against numpy, byte for byte,
   and its host time for a B 64 batch of 512x512 (and 384x384) crops.

The last three lines of standard output are a ``{"kernels": [...]}`` JSON
line (K1-K5; K1/K2's launches in phase 14's find_image run under
``launches_find``; K1/K2 at the G shape with the D shape's times under
``shape_d``, K1's serving shapes under ``shape_serve``, config '1024''s
shapes in both dtypes under ``shape_1024``, the scene generator's under
``shape_scene`` and K1/K2's launches per rank in phase 15's steps under
``launches_mesh`` (``plain_b1_ms`` and ``library_b1_ms`` at B 1, where the
plain version and SDPA fit); K3-K5's times
summed over the launches of one G forward; each record's ``dtypes`` and,
under ``bf16``, its bfloat16 numbers and the bfloat16 parity path's
launches),
the ``nvidia-smi`` name/power-limit line and the result line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import copy
import ctypes
import faulthandler
import gc
import json
import os
import re
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
# TF32 on the tensor cores (dense); K4 and K5 do each float32 product as
# three TF32 products (3xTF32)
PEAK_TF32_FLOPS = 495e12
# bfloat16 on the tensor cores (dense): the bound of every kernel's
# bfloat16 form (--dtype bf16)
PEAK_BF16_FLOPS = 989e12

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
# a graph replay of K train steps at the training rates against the same
# steps eager, where eager does not reproduce itself (float32's atomic
# sums): the losses relative, and each group of parameters' change over
# the call in norm (``hold_graph``). Two eager runs of 4 '128' steps were
# seen up to 5.5e-4 apart in a loss, the replay up to 1.6e-3 from eager and
# 4.6e-4 in a norm (NVIDIA H100); rates 0 move a loss 0.45-0.7 from them
TOL_GRAPH_TRAINED = 1e-2
# capturable Adam against Adam with capturable=False: parameters and
# moments within a few float32 ulps (rtol), parameters also within a
# thousandth of the learning rate (atol x lr)
TOL_ADAM = dict(rtol=1e-6, atol=1e-3)

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
# bfloat16 (--dtype bf16): K3-K5 against their plain versions, which round
# at the same points, each error over the plain output's max-abs: where the
# float32 sums before a rounding differ in their last bits, a value lands
# one bfloat16 ulp away, at most 2^-7 of the max-abs
TOL_PARITY_BF16 = dict(rtol=0, atol=2 ** -7)

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


def cuda_ms(fn, iters=20, reps=3):
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


def kernel_names(*names):
    """Substrings that pick out the device events of the named kernels in
    a profile, as the profiler names them demangled (``ns::name<...>``,
    ``ns::name(...)``) or mangled (length and name)."""
    return tuple(p for n in names
                 for p in (f"::{n}<", f"::{n}(", f"{len(n)}{n}"))


# each kernel's device events, and how many of them one wrapper call makes
K1_EVENTS = (kernel_names("attention_fwd_kernel"), 1)
K2_EVENTS = (kernel_names("delta_kernel", "dq_kernel", "dkdv_kernel"), 3)
K3_EVENTS = (kernel_names("tile_kernel"), 1)
K4_EVENTS = (kernel_names("pack_weights", "conv_kernel", "reduce_partials"), 3)
K5_EVENTS = (kernel_names("pack_weights", "conv_kernel"), 2)
# the parent commit's K4/K5 (``--gblock-ab``): one GEMM launch each, K4's
# reduce beside it; their weight packing ran as PyTorch ops
K4_EVENTS_PARENT = (kernel_names("gemm_kernel", "reduce_partials"), 2)
K5_EVENTS_PARENT = (kernel_names("gemm_kernel"), 1)


def device_ms(fn, events, iters=20):
    """A kernel's own device time a call, from ``torch.profiler``: ``fn``,
    one wrapper call on inputs (and weights) made beforehand, is called
    once to warm up, then ``iters`` times under the profiler; for each
    kernel that ``events`` (patterns, kernels a call) picks out, the mean
    duration of its device events, summed over the call's kernels. The
    wrapper's own work (packing weights, allocating) and the host's time
    between launches are not in it. The profiler drops device events that
    end near the close of its window (seen on an H100: the last 7-8 of 20
    0.9 ms launches), so the window stays open 0.1 s past the last launch,
    and each kernel's mean is over the events it did record (at least half
    of them, or this raises)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    patterns, per_call = events
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.02)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.1)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and \
                any(p in e.name for p in patterns):
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    counts = [len(t) for t in by_name.values()]
    if len(by_name) != per_call or min(counts) < iters // 2:
        raise RuntimeError(f"the profiler showed {counts} events of "
                           f"{sorted(by_name)} for {per_call} kernel(s) x "
                           f"{iters} calls matching {patterns[0]}")
    if min(counts) < iters:
        log(f"device_ms: the profiler recorded {counts} of {iters} launches "
            f"of {[n[:60] for n in by_name]}")
    return sum(statistics.mean(t) for t in by_name.values()) / 1e3


def host_ms(fn, reps=10):
    """Median host-clock time of ``fn`` (which ends in a device->host copy)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def clocks_during(fn, seconds=1.5):
    """nvidia-smi's SM clock (MHz) and power draw (W), sampled every 100 ms
    while ``fn`` is called back to back for ``seconds`` (the launch queue
    keeps the card busy until the sampler stops): (median clock, min clock,
    median power, samples), or None without samples."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
    finally:
        smi.terminate()
        out = smi.communicate(timeout=60)[0]
    torch.cuda.synchronize()
    rows = [[float(x) for x in line.split(",")]
            for line in out.strip().splitlines() if line.strip()]
    if not rows:
        return None
    clocks, power = [r[0] for r in rows], [r[1] for r in rows]
    return (statistics.median(clocks), min(clocks), statistics.median(power),
            len(rows))


def ptxas_usage(text):
    """(kernel, registers and shared memory, spills) of each entry function
    in ``nvcc -Xptxas -v`` output; the kernel named by its mangled template
    name (e.g. ``dkdv_kernelIfLi8ELi32E...``: float, Ck 8, Cv 32)."""
    kernel, spill = "?", ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
            m = re.search(r"([a-z_]*kernel[A-Za-z0-9_]*?)EvP", name)
            kernel = m.group(1) if m else name[:60]
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            yield kernel, line.split(":", 1)[-1].strip(), spill


def attention_bound_ms(b, lq, lk, ck, cv, itemsize, backward=False,
                       with_lse=True, peak=PEAK_F32_FLOPS):
    """Least time for the attention on an H100: each input read once and
    each output written once, against the float32 FLOPs the JAX kernel
    does: 2*B*Lq*Lk*(Ck+Cv) forward, with q, k, v in and o and (when
    training, ``with_lse``) the f32 lse out; 2*B*Lq*Lk*(3*Ck+2*Cv) backward
    (s, dp, dq, dk, dv), with q, k, v, do, o and lse in and dq, dk, dv
    out; the FLOPs at ``peak``."""
    qkv = b * lq * ck + b * lk * ck + b * lk * cv
    if backward:
        nbytes = itemsize * (2 * qkv + 2 * b * lq * cv) + 4 * b * lq
        flops = 2 * b * lq * lk * (3 * ck + 2 * cv)
    else:
        nbytes = itemsize * (qkv + b * lq * cv) + 4 * b * lq * with_lse
        flops = 2 * b * lq * lk * (ck + cv)
    return _bound(nbytes, flops, peak)


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
    check_attention_edges(dev)
    worst["attention_bwd"] = check_attention_bwd(dev)
    check_double_backward(dev)
    return worst


# K1 at its edges (B, Lq, Lk, Ck, Cv, scale of q): Lq not a multiple of any
# CTA's rows, Lk of one key, under one tile and ragged, Ck and Cv not
# multiples of 4 (the 4-byte copies), B 1 at the G shape (the small grid,
# keys split over a cluster of CTAs), and large logits (q scaled by 6: many
# lazy rescales)
K1_EDGES = [(2, 1, 1024, 8, 32, 1), (3, 257, 37, 8, 32, 1),
            (2, 1000, 333, 8, 32, 1), (4, 1000, 1, 8, 32, 1),
            (2, 257, 333, 5, 3, 1), (1, 4096, 1024, 8, 32, 1),
            (64, 1024, 256, 8, 32, 1), (1, 4096, 1024, 32, 128, 1),
            (64, 4096, 1024, 8, 32, 6), (1, 4096, 1024, 8, 32, 6),
            (3, 1000, 333, 7, 40, 6)]


def check_attention_edges(dev):
    """K1's output and lse against the plain versions at ``K1_EDGES``, in
    float32 and bfloat16; and two launches bit-identical at the G training
    shape and at B 1 (no atomics, one summation order)."""
    from tartangan_torch.ops.attention import (_fwd, attention_lse_plain,
                                               attention_plain)
    gen = torch.Generator(device=dev).manual_seed(16)
    worst = {}
    for b, lq, lk, ck, cv, scale in K1_EDGES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(s, device=dev, generator=gen).to(dtype)
                       for s in ((b, lq, ck), (b, lk, ck), (b, lk, cv)))
            q = (q.float() * scale).to(dtype)
            out, lse = _fwd(q, k, v, with_lse=True)
            ref, lse_ref = attention_plain(q, k, v), attention_lse_plain(q, k)
            torch.cuda.synchronize()
            assert out.dtype == dtype and out.shape == (b, lq, cv)
            torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
            torch.testing.assert_close(lse, lse_ref, **TOL[torch.float32])
            key = str(dtype)[6:]
            worst[key] = max(worst.get(key, 0.0),
                             (out.float() - ref.float()).abs().max().item(),
                             (lse - lse_ref).abs().max().item())
    log(f"kernel attention_fwd at its edges {K1_EDGES}: output and lse "
        f"within {TOL[torch.float32]} (f32, largest error "
        f"{worst['float32']:.3e}) and {TOL[torch.bfloat16]} (bf16 output, "
        f"largest error {worst['bfloat16']:.3e})")
    for b, lq, lk in ((64, 4096, 1024), (1, 4096, 1024)):
        q, k, v = (torch.randn(s, device=dev, generator=gen)
                   for s in ((b, lq, 8), (b, lk, 8), (b, lk, 32)))
        first, second = _fwd(q, k, v, True), _fwd(q, k, v, True)
        if not all(torch.equal(x, y) for x, y in zip(first, second)):
            raise AssertionError(f"K1 at B{b} Lq{lq} Lk{lk}: two launches "
                                 "differ")
    log("kernel attention_fwd: two launches bit-identical (o and lse) at "
        "B64 and B1, Lq4096 Lk1024")


def check_attention_bwd(dev):
    """K2 fed from K1's (o, lse), as the train step runs it, against
    attention_bwd_plain; K1's lse against the plain forward's. Returns the
    largest float32 max abs error of K2 at the '512thin' training shapes."""
    from tartangan_torch.ops.attention import (_bwd, _fwd, attention,
                                               attention_bwd,
                                               attention_bwd_plain,
                                               attention_lse_plain)
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
            before = (attention.launches, attention_bwd.launches)
            o, lse = _fwd(q, k, v, with_lse=True)
            outs = _bwd(q, k, v, do, o, lse)
            refs = attention_bwd_plain(q, k, v, do)
            lse_ref = attention_lse_plain(q, k)
            torch.cuda.synchronize()
            if (attention.launches - before[0],
                    attention_bwd.launches - before[1]) != (1, 1):
                raise AssertionError("K1 then K2: expected one launch each")
            lse_err = (lse - lse_ref).abs().max().item()
            torch.testing.assert_close(lse, lse_ref, **TOL[torch.float32])
            del o, lse, lse_ref
            errs = [f"lse {lse_err:.3e}"]
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


def check_double_backward(dev, shape=(64, 1024, 256, 8, 32)):
    """First- and second-order gradients of sum(dq^2)-style scalars through
    the two Functions against autograd through attention_plain, at a
    discriminator's training shape (B, Lq, Lk, Ck, Cv): '512thin''s, or
    '1024''s (phase 12)."""
    from tartangan_torch.ops.attention import attention, attention_plain
    b, lq, lk, ck, cv = shape

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


# K3 at the '512thin' G parity blocks' shapes (B, H, W, cin, cout; x is
# (B, H, W, Ci), Ci = cin for 'up', 4*cin for 'full'), then ragged ones:
# smaller than a tile, and non-square across both tile edges with a cout
# that is not a multiple of 4
K3_SHAPES = [("block 3 (32x32)", 64, 32, 32, 128, 64),
             ("block 5 (64x64)", 64, 64, 64, 64, 32),
             ("block 6 (128x128)", 64, 128, 128, 32, 16),
             ("block 7 (256x256)", 64, 256, 256, 16, 8),
             ("ragged", 3, 7, 7, 5, 7),
             ("ragged non-square", 2, 37, 19, 5, 7)]
# K4/K5 at the '512thin' fused blocks' shapes (x (B, H, H, Cin) -> Cout),
# identity shortcut, and one with a projection
GBLOCK_SHAPES = [("block 1 (8x8)", 64, 8, 128, 128),
                 ("block 2 (16x16)", 64, 16, 128, 128),
                 ("projection", 8, 12, 96, 40),
                 ("ragged identity", 2, 11, 6, 6),
                 ("ragged projection", 3, 9, 5, 7)]
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
    if cin == cout:  # the identity shortcut, as the model passes it
        p["wp"] = p["bp"] = None
    else:
        p["wp"] = scale * torch.randn(cin, cout, device=dev, generator=gen)
        p["bp"] = torch.randn(cout, device=dev, generator=gen)
    return p


def gblock_f64_errors(G, x, p, m1, v1, y1r, m2, v2, outs):
    """K4's y1p and K5's out_p (``outs``) against their plain versions in
    float64 on the same float32 inputs (K5 fed the plain float32 y1p and
    statistics): (K4 error, K5 error), each absolute."""
    def f64(*ts):
        return [None if t is None else t.double() for t in ts]
    y64, _ = G.gblock_a_plain(*f64(x, m1, v1, p["s1"], p["o1"], p["w1"],
                                   p["b1"]))
    o64 = G.gblock_b_plain(*f64(y1r, x, m2, v2, p["s2"], p["o2"], p["w2"],
                                p["b2"], p["wp"], p["bp"]))
    return tuple((a.double() - r).abs().max().item()
                 for a, r in zip(outs, (y64, o64)))


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
    for label, b, h, wd, cin, cout in K3_SHAPES:
        for mode in ("up", "full"):
            wcin = cin if mode == "up" else cout
            ci = wcin if mode == "up" else 4 * wcin
            x = torch.randn(b, h, wd, ci, device=dev, generator=gen)
            w = 0.1 * torch.randn(cout, wcin, 3, 3, device=dev, generator=gen)
            bias = torch.randn(cout, device=dev, generator=gen)
            out = merged_tap_conv(x, w, cout, mode, bias=bias)
            ref = fused_parity_conv_plain(x, w, cout, mode, bias)
            torch.cuda.synchronize()
            err, scale = _scaled_err(out, ref)
            log(f"kernel parity_conv '{mode}' {label} x {tuple(x.shape)} -> "
                f"{tuple(out.shape)}: max_abs_err {err * scale:.3e}, "
                f"{err:.3e} of the plain output's max-abs (tolerance "
                f"{TOL_PARITY} on the latter)")
            _assert_scaled(f"parity_conv {mode} {label}", out, ref)
            if not label.startswith("ragged"):
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
            if label.startswith("block") and name in ("y1p", "out_p"):
                worst[key] = max(worst[key], err * scale.item())
        log(f"kernel gblock_a/gblock_b {label} x {tuple(x.shape)} Cout "
            f"{cout}: max_abs_err {', '.join(errs)} (tolerance {TOL_PARITY} "
            f"after dividing by max-abs); against float64: "
            f"{gblock_f64_errors(G, x, p, m1, v1, y1r, m2, v2, (y1p, outb))}")
        # no float atomics: a second launch gives the same bits
        again = G.gblock_a(x, m1, v1, p["s1"], p["o1"], p["w1"], p["b1"])
        againb = G.gblock_b(y1r, x, m2, v2, p["s2"], p["o2"], p["w2"],
                            p["b2"], p["wp"], p["bp"])
        if not (torch.equal(again[0], y1p) and torch.equal(again[1], stats)
                and torch.equal(againb, outb)):
            raise AssertionError(f"gblock {label}: two launches differ")
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
    # the identity shortcut (wp, bp None) has no gradient of its own
    names = ["x"] + [k for k in G.PARAMS if p[k] is not None]

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in [x] +
                  [p[k] for k in names[1:]]]
        out = fn(leaves[0], dict(zip(names[1:], leaves[1:])))
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


def phase_times(app):
    """``generate`` at B 1 and B 25 with the kernel and with the plain
    attention (host clock), each with a profile."""
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
    synchronization), and the device's idle share of its host-clock time.
    Returns the idle share (None where no device time was seen) and the
    profile."""
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
        return None, prof
    # busy: the union of the device events' intervals, so that kernels
    # that overlap (on other streams) count once; their sum beside it
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA
                   and e.duration_ns() > 0)
    union_ns, end = 0, None
    for start, stop in spans:
        if end is None or start > end:
            union_ns += stop - start
            end = stop
        elif stop > end:
            union_ns += stop - end
            end = stop
    log(f"profile {label}: host {wall_us / 1e3:.3f} ms, device "
        f"busy {union_ns / 1e6:.3f} ms (union of its events; their sum "
        f"{busy_us / 1e3:.3f} ms), idle share "
        f"{1 - union_ns / 1e3 / wall_us:.3f}")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:4d}x "
            f"{e.key[:90]}")
    return 1 - union_ns / 1e3 / wall_us, prof


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


def hold_step(trainer, dev, batch=None):
    """One step with the kernels against one with the plain attention,
    from the same fresh state, batch and draws (the latents, and a
    subclass's ``extra_draws``: the IQN trainer's taus). D's learning rate
    is 0 in both: Adam's first step (beta1 = 0) moves each weight by about
    +-lr*sign(g), so a gradient near 0 may flip its sign between two
    correct runs and hand the G step two D's 2*lr apart; with lr 0 the G
    step sees one D, and the comparison is of gradients, not weights.
    Returns the batch, the latents and the extra draws."""
    b = trainer.args.batch_size
    if batch is None:
        batch = torch.from_numpy(trainer.dataset.images[:b]).to(dev)
    if getattr(trainer, "state", None) is None:
        trainer.build_models()
    trainer.z_gen.manual_seed(7)
    z_d = trainer.draw_z((1, b))
    z_g = trainer.draw_z((b,))
    extra = trainer.extra_draws((), b)
    results = []
    for use_kernel in (True, False):
        trainer.build_models()  # the same seeded init each time
        for group in trainer.state.opt_d.param_groups:
            group["lr"] = 0.0
        set_attention_kernel(trainer, use_kernel)
        metrics = trainer._train_step(trainer.state, batch, z_d, z_g,
                                      **extra)
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
    return batch, z_d, z_g, extra


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
    # once in turns after the warm-up: the whole smoke keeps its time limit
    kernel.append(once(True))
    plain.append(once(False))
    set_attention_kernel(trainer, True)
    b = batch.shape[0]
    log(f"time train step '512thin' B{b} float32 (host clock, synchronized, "
        f"once each in turns after warm-up): kernel median "
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
                    parity=F.resolve_parity(a.parity_blocks),
                    remat=a.remat, remat_policy_name=a.remat_policy),
                output_factory=F.g_output_factory(a.norm, a.activation),
                dtype=self.dtype)

    return FusedGTrainer.create_from_cli(argv)


def parity_counters():
    from tartangan_torch.ops.attention import attention, attention_bwd
    from tartangan_torch.ops.gblock import gblock_a, gblock_b
    from tartangan_torch.ops.parity_conv import merged_tap_conv
    return {"attention_fwd": attention, "attention_bwd": attention_bwd,
            "parity_conv": merged_tap_conv, "gblock_a": gblock_a,
            "gblock_b": gblock_b}


def phase_parity_train(archive, dtype="f32"):
    """Train full-width '512thin' at B 64 with --parity-blocks on,
    ``FUSED_G`` and the fused G blocks for 3 steps through the trainer's
    entry points, in ``dtype`` (``--dtype``); check the losses, the launches
    per step (every launch in the compute dtype), the checkpoint's layout,
    and that parameters, running statistics, Adam's state and the EMA
    target stay float32."""
    from tartangan_torch.models.blocks import (
        FusedResidualGeneratorBlock,
        ParityResidualDiscriminatorBlock,
        ParityResidualGeneratorBlock,
    )
    from tartangan_torch.ops import parity as P
    from tartangan_torch.utils import msgpack
    P.FUSED_G = True
    out_root = PARITY_DIR / "out"
    run_id = "parity" if dtype == "f32" else f"parity_{dtype}"
    shutil.rmtree(out_root / run_id, ignore_errors=True)
    trainer = parity_trainer([
        str(archive), "--config", "512thin", "--parity-blocks", "on",
        "--batch-size", "64", "--epochs", "1", "--dtype", dtype, "--device",
        "cuda", "--run-id", run_id, "--output", str(out_root),
        "--log-iters", "1", "--log-progress-newlines"])
    compute = trainer.dtype
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
        f.launches_by_dtype = {}
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    by_dtype = {k: {str(t)[6:]: n for t, n in f.launches_by_dtype.items()}
                for k, f in counters.items()}
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
    log(f"parity train: '512thin' B64 {str(compute)[6:]} --parity-blocks "
        f"on, FUSED_G, fused G blocks; G blocks {kinds}; {steps} steps in "
        f"{wall:.1f} s (host clock, sampling and checkpoints included); "
        f"losses {losses}; launches per step {per_step}; in the whole run "
        f"{launches}, by dtype {by_dtype}; peak device memory "
        f"{peak / 2**30:.2f} GiB")
    for k, f in counters.items():
        if f.launches_by_dtype != {compute: launches[k]}:
            raise AssertionError(f"{k}: launches by dtype {by_dtype[k]}, "
                                 f"not all {compute}")
    s = trainer.state
    kept = [t.dtype for m in (s.g, s.g_target, s.d) for t in
            list(m.parameters()) + list(m.buffers())]
    kept += [v.dtype for opt in (s.opt_g, s.opt_d)
             for st in opt.state.values() for v in st.values()
             if torch.is_tensor(v) and v.dim()]
    if set(kept) != {torch.float32}:
        raise AssertionError(f"parameters, statistics, Adam or the target "
                             f"not float32: {set(kept)}")
    for k, vals in losses.items():
        assert len(vals) == steps and all(np.isfinite(vals)), (k, vals)
    want = {"attention_fwd": K1_PER_STEP, "attention_bwd": K2_PER_STEP,
            "parity_conv": K3_PER_STEP, "gblock_a": K4_PER_STEP,
            "gblock_b": K5_PER_STEP}
    if per_step != [want] * steps:
        raise AssertionError(f"expected {want} launches per step, got "
                             f"{per_step}")
    ckpt = out_root / run_id / "checkpoints" / str(steps)
    tree = msgpack.loads((ckpt / "g.msgpack").read_bytes())
    fused = tree["params"]["blocks_1"]
    assert np.shape(fused["conv1_kernel"]) == (3, 3, 128, 128)
    assert np.asarray(fused["conv1_kernel"]).dtype == np.float32
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
        f"trees, optax Adam state), float32")
    return trainer, launches, per_step


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


def _hold(label, a, b, witness=None, losses=True):
    """Log one step against another: the losses are held at
    TOL_STEP_LOSS (logged only without ``losses``), and with ``witness``
    (errors of other steps against the same reference) the gradients too
    (see TOL_PARITY_STEP_GRAD). Returns ({"g"/"d": {"max": ...,
    "norm": ...}}, [what failed])."""
    (m_a, g_a), (m_b, g_b) = a, b
    failed = []
    log(f"hold {label}: {m_a} vs {m_b} (tolerance "
        f"{TOL_STEP_LOSS if losses else 'none: logged'})")
    for k in m_a:
        if losses and not np.isclose(m_a[k], m_b[k], **TOL_STEP_LOSS):
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


def to_float64(model):
    """The model's parameters and its compute dtype in float64 (the
    trainer builds G and D with its float32 or bfloat16 compute dtype)."""
    model.double()
    model.dtype = torch.float64


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
        to_float64(model)
    plain._train_step = make_cnn_train_step(
        grad_penalty=a.grad_penalty, ema_factor=a.lr_target_g,
        dtype=torch.float64, iters_d=a.iters_d, r1_interval=a.r1_interval)
    return _step_grads(plain, batch, z_d.double(), z_g.double())


def hold_parity(trainer, dev, batch, z_d, z_g, par16=None):
    """G's and D's forwards on the parity path against the plain ones on
    the same weights, and each against the plain G in float64; then one
    step each from the same state, batch and latents: the parity path with
    the kernels, the same with FUSED_G off and the fused blocks on their
    plain versions (and with merged-tap convs in G), the plain '512thin'
    step (and with channels_last weights), each against the plain step in
    float64 (see TOL_PARITY_STEP_GRAD); with ``par16``, the bfloat16 parity
    trainer, its step against the same float64 step
    (``hold_parity_bf16``). Returns the plain trainer."""
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
    to_float64(plain.state.g)
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
    if par16 is not None:
        failed += hold_parity_bf16(par16, init, batch, z_d, z_g, exact)
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


@contextlib.contextmanager
def uncached_constants():
    """Within the block every constant of the packers and the parity
    downsamplers is made anew from numpy at each call, as before
    ``ops/consts.py`` cached them: a pageable host-to-device copy, which
    synchronizes the stream, each."""
    from tartangan_torch.ops import consts
    cached = consts.device_constant

    def fresh(key, make_numpy, dtype, device):
        return torch.as_tensor(make_numpy(), dtype=dtype, device=device)
    consts.device_constant = fresh
    try:
        yield
    finally:
        consts.device_constant = cached


def time_parity_step(trainer, plain, batch, z_d, z_g):
    """The parity step and the plain step, in turns (host clock,
    synchronized), with two more turns of the parity step: with the layout
    copies that ``ops.parity.conv2d`` makes on the CPU made on the card as
    well (their cost), and with the constants made anew at every call (the
    stream syncs the cache removed); the parity step's peak memory, and a
    profile with and without the cache."""
    def once(t, copies=False, uncached=False):
        with contextlib.ExitStack() as stack:
            if copies:
                stack.enter_context(layout_copies())
            if uncached:
                stack.enter_context(uncached_constants())
            t0 = time.perf_counter()
            t._train_step(t.state, batch, z_d, z_g)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

    once(trainer)
    once(trainer, copies=True)
    once(trainer, uncached=True)
    once(plain)
    par, pl, cp, unc = [], [], [], []
    # once in turns after the warm-up: the whole smoke keeps its time limit
    pl.append(once(plain))
    par.append(once(trainer))
    cp.append(once(trainer, copies=True))
    unc.append(once(trainer, uncached=True))
    log(f"time train step '512thin' B{batch.shape[0]} float32 (host clock, "
        f"synchronized, once each in turns after warm-up): parity path "
        f"(--parity-blocks on, FUSED_G, fused G blocks) median "
        f"{statistics.median(par):.3f} ms {[round(t, 3) for t in par]}; "
        f"plain path median {statistics.median(pl):.3f} ms "
        f"{[round(t, 3) for t in pl]}; parity path with a contiguous NCHW "
        f"copy before each of its convs median {statistics.median(cp):.3f} "
        f"ms {[round(t, 3) for t in cp]}; parity path with its constants "
        f"made anew at each call (before the cache) median "
        f"{statistics.median(unc):.3f} ms {[round(t, 3) for t in unc]}")
    torch.cuda.reset_peak_memory_stats()
    once(trainer)
    log(f"parity train step peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_call("parity train step B64", lambda: once(trainer))
    profile_call("parity train step B64, constants made anew at each call",
                 lambda: once(trainer, uncached=True))


def phase_no_sync(dev):
    """One forward and backward of '512thin''s parity blocks and attention
    at B 8 with the kernels on (a G parity block on K3, a fused G block on
    K4/K5, D parity blocks through both parity downsamplers and the packers,
    K1 and K2), after one warm-up call, under
    ``torch.cuda.set_sync_debug_mode("error")``: any call that synchronizes
    the stream with the host raises."""
    from tartangan_torch.models.blocks import (
        FusedResidualGeneratorBlock,
        ParityResidualDiscriminatorBlock,
        ParityResidualGeneratorBlock,
    )
    from tartangan_torch.ops import parity as P
    from tartangan_torch.ops.attention import attention
    torch.manual_seed(15)
    gen = torch.Generator(device=dev).manual_seed(15)
    d_to_parity = ParityResidualDiscriminatorBlock(
        16, 32, accept_parity=True, emit_parity=True)
    d_to_plain = ParityResidualDiscriminatorBlock(
        32, 64, accept_parity=True, emit_parity=False)
    blocks = [(ParityResidualGeneratorBlock(128, 64), (8, 128, 32, 32)),
              (FusedResidualGeneratorBlock(128, 128), (8, 128, 8, 8)),
              (d_to_parity, (8, 64, 64, 64))]
    blocks = [(m.to(dev), torch.randn(s, device=dev, generator=gen)
               .requires_grad_()) for m, s in blocks]
    d_to_plain.to(dev)
    qkv = [torch.randn(s, device=dev, generator=gen).requires_grad_()
           for s in ((8, 1024, 8), (8, 256, 8), (8, 256, 32))]
    counters = parity_counters()

    def run():
        outs = [m(x, train=True) for m, x in blocks]
        outs.append(d_to_plain(outs[-1], train=True))
        outs.append(attention(*qkv))
        loss = sum(o.float().square().mean() for o in outs)
        loss.backward()

    fused_g = P.FUSED_G
    P.FUSED_G = True
    try:
        run()
        torch.cuda.synchronize()
        before = {k: f.launches for k, f in counters.items()}
        torch.cuda.set_sync_debug_mode("error")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    finally:
        P.FUSED_G = fused_g
    launched = {k: f.launches - before[k] for k, f in counters.items()}
    want = {"attention_fwd": 1, "attention_bwd": 1, "parity_conv": 2,
            "gblock_a": 1, "gblock_b": 1}
    if launched != want:
        raise AssertionError(f"no-sync check: expected launches {want}, "
                             f"got {launched}")
    log(f"no sync: a forward and backward of a G parity block (K3), a "
        f"fused G block (K4/K5), two D parity blocks (both parity "
        f"downsamplers, every D packer) and the attention (K1/K2), B 8, ran "
        f"under torch.cuda.set_sync_debug_mode('error') after a warm-up "
        f"call; launches {launched}")


def _bound(nbytes, flops, peak):
    """(least ms, what bounds it): the bytes at PEAK_BYTES against the
    operations at ``peak``."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def _conv_bound_ms(macs, nbytes):
    return _bound(nbytes, 2 * macs, PEAK_F32_FLOPS)


def _tf32x3_bound_ms(macs, nbytes):
    """The bound of ``macs`` float32 products done as three TF32 products
    each on the tensor cores, against the bytes."""
    return _bound(nbytes, 3 * 2 * macs, PEAK_TF32_FLOPS)


def time_parity_kernels(dev, errs):
    """K3 at the eight shapes of one '512thin' G forward and K4/K5 at the
    two fused blocks' shapes: the kernel's device time (profiler; K4's
    includes its pack and reduce launches, K5's its pack launch), the
    wrapper's time a call (CUDA events), plain version, the library call
    (K3: ``F.conv2d`` of the 3x3-packed form with the bias, as K3 adds it)
    and the bound; each summed over the launches of one G forward for the
    kernels line (whose launches, the parity path's, ``main`` fills in)."""
    import torch.nn.functional as F

    from tartangan_torch.ops import gblock as G
    from tartangan_torch.ops import parity as P
    from tartangan_torch.ops.parity_conv import (
        fused_parity_conv_plain,
        merged_tap_conv,
    )
    gen = torch.Generator(device=dev).manual_seed(14)
    # per kernel: device ms, plain ms, library ms, MACs, bytes, call ms
    totals = {k: [0.0] * 6 for k in ("parity_conv", "gblock_a", "gblock_b")}

    def add_times(name, t, t_dev, macs, nbytes, lib=0.0):
        tot = totals[name]
        tot[0] += statistics.median(t_dev)
        tot[1] += statistics.median([t[0], t[3]])
        tot[2] += lib
        tot[3] += macs
        tot[4] += nbytes
        tot[5] += statistics.median([t[1], t[2]])
    for label, b, h, wd, cin, cout in K3_SHAPES[:4]:
        for mode in ("up", "full"):
            wcin = cin if mode == "up" else cout
            ci = wcin if mode == "up" else 4 * wcin
            x = torch.randn(b, h, wd, ci, device=dev, generator=gen)
            w = 0.1 * torch.randn(cout, wcin, 3, 3, device=dev, generator=gen)
            bias = torch.randn(cout, device=dev, generator=gen)
            w3 = (P.pack_up_conv if mode == "up" else P.pack_full_conv)(w)
            b4 = bias.repeat(4)
            xc = x.permute(0, 3, 1, 2)
            it = 5 if h >= 128 else 20

            def kern():
                return merged_tap_conv(x, w, cout, mode, bias=bias)

            def plain():
                return fused_parity_conv_plain(x, w, cout, mode, bias)
            t = [cuda_ms(plain, iters=it), cuda_ms(kern, iters=it),
                 cuda_ms(kern, iters=it), cuda_ms(plain, iters=it)]
            t_dev = [device_ms(kern, K3_EVENTS), device_ms(kern, K3_EVENTS)]
            lib = cuda_ms(lambda: F.conv2d(xc, w3, b4, padding=1), iters=it)
            taps = 16 * wcin if mode == "up" else 36 * wcin
            macs = b * h * wd * taps * cout
            nbytes = 4 * (x.numel() + b * h * wd * 4 * cout + w.numel()
                          + cout)
            bound = _conv_bound_ms(macs, nbytes)
            ms = statistics.median(t_dev)
            log(f"time parity_conv '{mode}' {label} x {tuple(x.shape)}: "
                f"kernel device {t_dev[0]:.4f}/{t_dev[1]:.4f} ms (profiler), "
                f"call {t[1]:.4f}/{t[2]:.4f} ms (CUDA events), plain "
                f"{t[0]:.4f}/{t[3]:.4f} ms, F.conv2d 3x3-packed + bias "
                f"{lib:.4f} ms, bound "
                f"{bound[0]:.4f} ms ({bound[1]}, {2 * macs / 1e9:.2f} GFLOP);"
                f" kernel at {100 * bound[0] / ms:.1f} % of the bound, "
                f"{ms / lib:.3f}x F.conv2d's time")
            add_times("parity_conv", t, t_dev, macs, nbytes, lib)
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
        short = 0 if p["wp"] is None else 4 * cin
        # conv_only: F.conv2d of the 3x3-packed conv alone, on an input of
        # the same shape (no BatchNorm, statistics or shortcut): a yardstick
        # of less work, used nowhere in the port
        xa = x.permute(0, 3, 1, 2)
        xb = y1p.permute(0, 3, 1, 2)
        wa, wb = P.pack_up_conv(p["w1"]), P.pack_full_conv(p["w2"])
        for name, kern, plain, args, events, macs, nbytes, conv in (
                ("gblock_a", G.gblock_a, G.gblock_a_plain, args_a, K4_EVENTS,
                 pos * 16 * cin * cout, 4 * (x.numel() + y1p.numel()),
                 lambda: F.conv2d(xa, wa, padding=1)),
                ("gblock_b", G.gblock_b, G.gblock_b_plain, args_b, K5_EVENTS,
                 pos * (36 * cout + short) * cout,
                 4 * (2 * y1p.numel() + x.numel()),
                 lambda: F.conv2d(xb, wb, padding=1))):
            t = [cuda_ms(lambda: plain(*args)), cuda_ms(lambda: kern(*args)),
                 cuda_ms(lambda: kern(*args)), cuda_ms(lambda: plain(*args))]
            t_dev = [device_ms(lambda: kern(*args), events),
                     device_ms(lambda: kern(*args), events)]
            conv_ms = cuda_ms(conv)
            fma = _conv_bound_ms(macs, nbytes)
            tc = _tf32x3_bound_ms(macs, nbytes)
            ms = statistics.median(t_dev)
            log(f"time {name} {label} x {tuple(x.shape)} Cout {cout}: kernel "
                f"device {t_dev[0]:.4f}/{t_dev[1]:.4f} ms (profiler), call "
                f"{t[1]:.4f}/{t[2]:.4f} ms (CUDA events), plain "
                f"{t[0]:.4f}/{t[3]:.4f} ms, conv only {conv_ms:.4f} ms; "
                f"bounds ({2 * macs / 1e9:.2f} GFLOP): FMA {fma[0]:.4f} ms "
                f"({fma[1]}), 3xTF32 {tc[0]:.4f} ms ({tc[1]}); kernel at "
                f"{100 * fma[0] / ms:.1f} % / {100 * tc[0] / ms:.1f} % of "
                f"them")
            add_times(name, t, t_dev, macs, nbytes, conv_ms)
    records = []
    for name, src, replaces in (
            ("parity_conv", "parity_conv.cu",
             "tartangan_tpu/ops/pallas/parity_conv.py:99"),
            ("gblock_a", "gblock.cu", "tartangan_tpu/ops/pallas/gblock.py:196"),
            ("gblock_b", "gblock.cu",
             "tartangan_tpu/ops/pallas/gblock.py:234")):
        ms, plain_ms, lib, macs, nbytes, call_ms = totals[name]
        k3 = name == "parity_conv"
        # K3 multiplies on the FMA pipe; K4/K5 as 3xTF32 on the tensor
        # cores, with their FMA bound beside it
        bound_ms, bound_by = (_conv_bound_ms if k3 else _tf32x3_bound_ms)(
            macs, nbytes)
        rec = {
            "name": name, "route": "cuda",
            "source": f"tartangan_torch/csrc/{src}", "replaces": replaces,
            "launches": None, "max_abs_err": errs[name],
            "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib if k3 else None}
        if not k3:
            rec["bound_fma_ms"] = _conv_bound_ms(macs, nbytes)[0]
            rec["conv_only_ms"] = lib
        records.append(rec)
        log(f"kernels line {name}: summed over the launches of one G "
            f"forward: kernel device {ms:.4f} ms, call {call_ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms"
            + (f", F.conv2d {lib:.4f} ms" if k3 else
               f" (FMA {rec['bound_fma_ms']:.4f} ms), conv only "
               f"{lib:.4f} ms"))
    return records


def time_attention_serve(dev):
    """K1 at the serving shapes (the '512thin' G attention at B 25 for
    ``/grid`` and B 1 for ``/generate``, no lse): device time (profiler),
    the wrapper's time a call, plain, SDPA and the bound. Returns the
    float32 records for ``shape_serve``."""
    import torch.nn.functional as F

    from tartangan_torch.ops.attention import _fwd, attention_plain
    lq, lk, ck, cv = 4096, 1024, 8, 32
    gen = torch.Generator(device=dev).manual_seed(2)
    serve = []
    for b in (25, 1):
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(b, lq, ck, device=dev, generator=gen).to(dtype)
            k = torch.randn(b, lk, ck, device=dev, generator=gen).to(dtype)
            v = torch.randn(b, lk, cv, device=dev, generator=gen).to(dtype)

            def k1():
                return _fwd(q, k, v, with_lse=False)
            t = [cuda_ms(lambda: attention_plain(q, k, v)), cuda_ms(k1),
                 cuda_ms(k1), cuda_ms(lambda: attention_plain(q, k, v))]
            t_dev = [device_ms(k1, K1_EVENTS), device_ms(k1, K1_EVENTS)]
            ms_lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, scale=1.0))
            bound, bound_by = attention_bound_ms(b, lq, lk, ck, cv,
                                                 q.element_size(),
                                                 with_lse=False)
            log(f"time attention_fwd serve B{b} Lq{lq} Lk{lk} Ck{ck} Cv{cv} "
                f"{str(dtype)[6:]} (no lse): kernel device "
                f"{t_dev[0]:.4f}/{t_dev[1]:.4f} ms (profiler), call "
                f"{t[1]:.4f}/{t[2]:.4f} ms (CUDA events), plain "
                f"{t[0]:.4f}/{t[3]:.4f} ms, sdpa {ms_lib:.4f} ms, bound "
                f"{bound:.4f} ms ({bound_by}); kernel at "
                f"{100 * bound / statistics.median(t_dev):.1f} % of the "
                f"bound")
            if dtype == torch.float32:
                serve.append({
                    "shape": f"B{b} Lq{lq} Lk{lk} Ck{ck} Cv{cv}, no lse",
                    "ms": statistics.median(t_dev),
                    "call_ms": statistics.median(t[1:3]),
                    "plain_ms": statistics.median([t[0], t[3]]),
                    "bound_ms": bound, "bound_by": bound_by,
                    "library_ms": ms_lib})
            del q, k, v
    return serve


def time_attention(dev, errs):
    """K1 and K2 at the two training shapes as the train step runs them
    (K1 storing lse; K2 given K1's o and lse, its delta launch included):
    the kernel's device time (profiler, twice), the wrapper's time a call
    (CUDA events), the plain version, the library call and the bound. The
    records of the kernels line carry the G shape's numbers and, under
    ``shape_d``, the D shape's; K1's also the serving shapes' under
    ``shape_serve`` (``time_attention_serve``). The launches are the train
    path's, filled in by ``main``."""
    import torch.nn.functional as F

    from tartangan_torch.ops.attention import (_bwd, _fwd,
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

        def k1():
            return _fwd(q, k, v, with_lse=True)
        fwd = [cuda_ms(lambda: attention_plain(q, k, v)), cuda_ms(k1),
               cuda_ms(k1), cuda_ms(lambda: attention_plain(q, k, v))]
        fwd_dev = [device_ms(k1, K1_EVENTS), device_ms(k1, K1_EVENTS)]
        fwd_lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=1.0))
        fwd_bound = attention_bound_ms(b, lq, lk, ck, cv, 4)
        log(f"time attention_fwd {shape} (with lse): kernel device "
            f"{fwd_dev[0]:.4f}/{fwd_dev[1]:.4f} ms (profiler), call "
            f"{fwd[1]:.4f}/{fwd[2]:.4f} ms (CUDA events), plain "
            f"{fwd[0]:.4f}/{fwd[3]:.4f} ms, sdpa {fwd_lib:.4f} ms, bound "
            f"{fwd_bound[0]:.4f} ms ({fwd_bound[1]}); kernel at "
            f"{100 * fwd_bound[0] / statistics.median(fwd_dev):.1f} % of "
            f"the bound")
        o, lse = k1()

        def k2():
            return _bwd(q, k, v, do, o, lse)
        bwd = [cuda_ms(lambda: attention_bwd_plain(q, k, v, do), iters=5),
               cuda_ms(k2, iters=5), cuda_ms(k2, iters=5),
               cuda_ms(lambda: attention_bwd_plain(q, k, v, do), iters=5)]
        bwd_dev = [device_ms(k2, K2_EVENTS), device_ms(k2, K2_EVENTS)]
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, scale=1.0)
        bwd_lib = cuda_ms(lambda: torch.autograd.grad(
            out, leaves, do, retain_graph=True), iters=5)
        bwd_bound = attention_bound_ms(b, lq, lk, ck, cv, 4, backward=True)
        log(f"time attention_bwd {shape} (given o, lse): kernel device "
            f"{bwd_dev[0]:.4f}/{bwd_dev[1]:.4f} ms (profiler; delta, dq and "
            f"dk/dv summed), call {bwd[1]:.4f}/{bwd[2]:.4f} ms (CUDA "
            f"events), plain {bwd[0]:.4f}/{bwd[3]:.4f} ms, sdpa backward "
            f"{bwd_lib:.4f} ms, bound {bwd_bound[0]:.4f} ms ({bwd_bound[1]});"
            f" kernel at {100 * bwd_bound[0] / statistics.median(bwd_dev):.1f}"
            f" % of the bound")
        if label == "G":
            # the bound takes the float32 peak at the 1980 MHz boost clock:
            # read the clock the card holds under each kernel
            for name, fn, t_dev, bound in (
                    ("attention_fwd", k1, fwd_dev, fwd_bound),
                    ("attention_bwd", k2, bwd_dev, bwd_bound)):
                got = clocks_during(fn)
                share = bound[0] / statistics.median(t_dev)
                if got:
                    log(f"clocks under {name} {shape}: SM median "
                        f"{got[0]:.0f} MHz (min {got[1]:.0f}), power median "
                        f"{got[2]:.1f} W, {got[3]} samples; kernel at "
                        f"{100 * share * 1980 / got[0]:.1f} % of its bound "
                        f"restated at that clock")
        for name, src, line, t, t_dev, lib, bound in (
                ("attention_fwd", "attention_fwd.cu", 41, fwd, fwd_dev,
                 fwd_lib, fwd_bound),
                ("attention_bwd", "attention_bwd.cu", 164, bwd, bwd_dev,
                 bwd_lib, bwd_bound)):
            times = {"ms": statistics.median(t_dev),
                     "call_ms": statistics.median([t[1], t[2]]),
                     "plain_ms": statistics.median([t[0], t[3]]),
                     "bound_ms": bound[0], "bound_by": bound[1],
                     "library_ms": lib}
            if label == "G":
                records[name] = {
                    "name": name, "route": "cuda",
                    "source": f"tartangan_torch/csrc/{src}",
                    "replaces": f"tartangan_tpu/ops/pallas/attention.py:{line}",
                    "launches": None, "max_abs_err": errs[name], **times}
            else:
                records[name]["shape_d"] = {
                    "shape": f"B{b} Lq{lq} Lk{lk} Ck{ck} Cv{cv}", **times}
        del q, k, v, do, o, lse, leaves, out
    records["attention_fwd"]["shape_serve"] = time_attention_serve(dev)
    return [records["attention_fwd"], records["attention_bwd"]]


# K1's shapes on the main path: (label, B, Lq, Lk, Ck, Cv, lse stored,
# scale of q); the last with large logits (many lazy rescales)
K1_SHAPES = [("G train", 64, 4096, 1024, 8, 32, True, 1),
             ("D train", 64, 1024, 256, 8, 32, True, 1),
             ("serve /grid", 25, 4096, 1024, 8, 32, False, 1),
             ("serve /generate", 1, 4096, 1024, 8, 32, False, 1),
             ("G train, q x 6", 64, 4096, 1024, 8, 32, True, 6)]


def build_k1_variants(sources):
    """``tt_attention_fwd`` of other K1 sources (the same C entry point,
    e.g. a parent commit's ``attention_fwd.cu``), built in parallel with
    the port's nvcc flags into ``build/k1_ab/`` and loaded; logs their
    ptxas usage."""
    from tartangan_torch.ops import build
    out_dir = ROOT / "build" / "k1_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, src in enumerate(sources):
        out = out_dir / f"libv{i}.so"
        procs.append((src, out, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    fns = []
    for src, out, proc in procs:
        text = proc.communicate(timeout=900)[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc {src}:\n{text}")
        for kernel, used, spill in ptxas_usage(text):
            log(f"  ptxas {src} {kernel}: {used}; {spill}")
        fn = ctypes.CDLL(str(out)).tt_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns.append((src, fn))
    return fns


def k1_ab(sources):
    """K1 built from each of ``sources`` against the checkout's K1 at
    ``K1_SHAPES`` in float32, on the same inputs: each held against the
    plain version, then each one's device time (profiler, 20 launches) in
    turns, the others, the checkout's twice, the others again. Returns the
    JSON-ready results."""
    from tartangan_torch.ops import build
    from tartangan_torch.ops.attention import (attention_lse_plain,
                                               attention_plain)
    lib = build.load("attention_fwd")
    variants = build_k1_variants(sources)
    checkout = lib.tt_attention_fwd
    checkout.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + \
        [ctypes.c_void_p]
    checkout.restype = ctypes.c_int
    variants.append(("checkout", checkout))
    gen = torch.Generator(device="cuda").manual_seed(17)
    results, wrong = [], []
    for label, b, lq, lk, ck, cv, with_lse, scale in K1_SHAPES:
        q, k, v = (torch.randn(s, device="cuda", generator=gen)
                   for s in ((b, lq, ck), (b, lk, ck), (b, lk, cv)))
        q *= scale
        out = torch.empty((b, lq, cv), device="cuda")
        lse = torch.empty((b, lq), device="cuda") if with_lse else None
        ref = attention_plain(q, k, v)
        lse_ref = attention_lse_plain(q, k)

        def call(fn):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     None if lse is None else lse.data_ptr(), b, lq, lk, ck,
                     cv, 0, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"K1 launch failed: cudaError {err}")
        errs = {}
        for name, fn in variants:
            out.zero_()
            call(fn)
            torch.cuda.synchronize()
            errs[name] = (out - ref).abs().max().item()
            held = torch.allclose(out, ref, **TOL[torch.float32])
            if lse is not None:
                errs[name] = max(errs[name],
                                 (lse - lse_ref).abs().max().item())
                held &= torch.allclose(lse, lse_ref, **TOL[torch.float32])
            if not held:
                wrong.append((label, name))
        times = {name: [] for name, _ in variants}
        others, mine = variants[:-1], variants[-1:]
        for name, fn in others + mine + mine + others[::-1]:
            times[name].append(device_ms(lambda: call(fn), K1_EVENTS))
        bound = attention_bound_ms(b, lq, lk, ck, cv, 4, with_lse=with_lse)
        row = {"shape": f"{label} B{b} Lq{lq} Lk{lk} Ck{ck} Cv{cv}"
                        f"{' lse' if with_lse else ''}",
               "bound_ms": bound[0],
               "ms": {name: statistics.median(t) for name, t in times.items()},
               "max_abs_err": errs}
        results.append(row)
        log(f"k1 A/B {row['shape']} float32, device ms (profiler, in turns):"
            + "".join(f" {name} {[round(x, 4) for x in t]}"
                      for name, t in times.items())
            + f"; bound {bound[0]:.4f} ms; checkout at "
            f"{100 * bound[0] / row['ms']['checkout']:.1f} % of it; max abs "
            f"error against the plain version (o and lse) {errs}")
        del q, k, v, out, lse, ref, lse_ref
    if wrong:
        raise AssertionError(f"K1 builds off the plain version beyond "
                             f"{TOL[torch.float32]}: {wrong}")
    return results


def build_gblock_variants(dirs):
    """The K4/K5 libraries of other sources (``gblock.cu`` in each of
    ``dirs``, with any header beside it), built in parallel with the port's
    nvcc flags into ``build/gblock_ab/`` and loaded: a source whose
    library exports ``tt_gblock_workspace`` takes the checkout's C
    arguments (raw weights); one that does not, the parent commit's
    (packed weights, ``tt_gblock_partial_rows``). Logs their ptxas use."""
    from tartangan_torch.ops import build
    out_dir = ROOT / "build" / "gblock_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, d in enumerate(dirs):
        out, src = out_dir / f"libv{i}.so", Path(d) / "gblock.cu"
        procs.append((str(d), src, out, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = []
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, src, out, proc in procs:
        text = proc.communicate(timeout=900)[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc {src}:\n{text}")
        for kernel, used, spill in ptxas_usage(text):
            log(f"  ptxas {src} {kernel}: {used}; {spill}")
        lib = ctypes.CDLL(str(out))
        if hasattr(lib, "tt_gblock_workspace"):
            for fn, (argtypes, restype) in build.SIGNATURES["gblock"].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
        else:
            lib.tt_gblock_partial_rows.argtypes = [I] * 4
            lib.tt_gblock_partial_rows.restype = LL
            lib.tt_gblock_a.argtypes = [P] * 8 + [LL, P] + [I] * 5 + [P]
            lib.tt_gblock_a.restype = I
            lib.tt_gblock_b.argtypes = [P] * 9 + [I] * 5 + [P]
            lib.tt_gblock_b.restype = I
        libs.append((name, lib))
    return libs


def raw_gblock_a(lib, x, m1, v1, s1, o1, w1, b1):
    """K4 of a library with the checkout's C arguments, as
    ``ops.gblock.gblock_a`` calls it (the scratch sized by the library),
    float32 (the dtype argument 0; a source from before it took one reads
    0 as its stream, the default stream, which PyTorch's is)."""
    b, h, w, cin = x.shape
    cout = w1.shape[0]
    y1p = torch.empty((b, h, w, 4 * cout), device=x.device)
    stats = torch.empty((2, 4 * cout), device=x.device)
    n = lib.tt_gblock_workspace(0, b, h, w, cin, cout)
    work = torch.empty(n, device=x.device)
    err = lib.tt_gblock_a(x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                          m1.data_ptr(), v1.data_ptr(), s1.data_ptr(),
                          o1.data_ptr(), y1p.data_ptr(), stats.data_ptr(),
                          work.data_ptr(), n, b, h, w, cin, cout, 0,
                          torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K4 failed: cudaError {err}")
    return y1p, stats


def raw_gblock_b(lib, y1p, x, m2, v2, s2, o2, w2, b2, wp, bp):
    """K5 of a library with the checkout's C arguments."""
    b, h, w, cin = x.shape
    cout = w2.shape[0]
    out = torch.empty((b, h, w, 4 * cout), device=x.device)
    n = lib.tt_gblock_workspace(1, b, h, w, cin, cout)
    work = torch.empty(n, device=x.device)
    err = lib.tt_gblock_b(y1p.data_ptr(), x.data_ptr(), w2.data_ptr(),
                          b2.data_ptr(), None if wp is None else wp.data_ptr(),
                          None if bp is None else bp.data_ptr(),
                          m2.data_ptr(), v2.data_ptr(), s2.data_ptr(),
                          o2.data_ptr(), out.data_ptr(), work.data_ptr(), n,
                          b, h, w, cin, cout, 0,
                          torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K5 failed: cudaError {err}")
    return out


def other_gblock_a(lib, x, m1, v1, s1, o1, w1, b1):
    """K4 of the other build, with its wrapper's work as that commit's
    ``ops/gblock.py`` did it: the merged-tap weights packed and
    transposed, the BatchNorm multiplier and the tiled bias made by
    PyTorch ops at every call."""
    from tartangan_torch.ops import parity as P
    from tartangan_torch.ops.gblock import BN_EPS
    b, h, w, cin = x.shape
    cout = w1.shape[0]
    w1p = P.pack_up_conv2(w1).permute(2, 3, 1, 0).contiguous()
    bias = b1.repeat(4).contiguous()
    mul = (torch.rsqrt(v1 + BN_EPS) * s1).contiguous()
    y1p = torch.empty((b, h, w, 4 * cout), device=x.device)
    rows = lib.tt_gblock_partial_rows(b, h, w, cout)
    partial = torch.empty((rows, 2, 4 * cout), device=x.device)
    stats = torch.empty((2, 4 * cout), device=x.device)
    err = lib.tt_gblock_a(x.data_ptr(), w1p.data_ptr(), bias.data_ptr(),
                          m1.data_ptr(), mul.data_ptr(), o1.data_ptr(),
                          y1p.data_ptr(), partial.data_ptr(), rows,
                          stats.data_ptr(), b, h, w, cin, cout,
                          torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the other K4 failed: cudaError {err}")
    return y1p, stats


def other_gblock_b(lib, y1p, x, m2, v2, s2, o2, w2, b2, wp, bp):
    """K5 of the other build, driven as that commit's wrapper did: the
    identity shortcut as wp = I, bp = 0, the weights and tiled vectors
    made by PyTorch ops at every call."""
    from tartangan_torch.ops import parity as P
    from tartangan_torch.ops.gblock import BN_EPS
    b, h, w, cin = x.shape
    cout = w2.shape[0]
    if wp is None:
        wp = torch.eye(cin, device=x.device)
        bp = torch.zeros(cout, device=x.device)
    w2p = P.pack_full_conv2(w2).permute(2, 3, 1, 0).contiguous()
    wp = wp.contiguous()
    bias = (b2 + bp).repeat(4).contiguous()
    mean = m2.repeat(4).contiguous()
    mul = (torch.rsqrt(v2 + BN_EPS) * s2).repeat(4).contiguous()
    add = o2.repeat(4).contiguous()
    out = torch.empty((b, h, w, 4 * cout), device=x.device)
    err = lib.tt_gblock_b(y1p.data_ptr(), x.data_ptr(), w2p.data_ptr(),
                          wp.data_ptr(), bias.data_ptr(), mean.data_ptr(),
                          mul.data_ptr(), add.data_ptr(), out.data_ptr(), b,
                          h, w, cin, cout,
                          torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the other K5 failed: cudaError {err}")
    return out


# A yardstick for K4/K5: the rate of mma.sync.m16n8k8 TF32 products on
# this card (independent accumulators, operands in registers, no loads)
MMA_RATE_SRC = r"""
#include <cuda_runtime.h>
#include <cstdint>
template <int CHAINS>
__global__ void mma_rate_kernel(float* out, int iters) {
  uint32_t a[4], b0 = threadIdx.x, b1 = threadIdx.x * 3u;
  for (int i = 0; i < 4; ++i) a[i] = threadIdx.x * (i + 1);
  float c[CHAINS][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) {
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(c[k][0]), "+f"(c[k][1]), "+f"(c[k][2]), "+f"(c[k][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  }
  float t = 0.f;
  for (int k = 0; k < CHAINS; ++k) t += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = t;
}
extern "C" int mma_rate(float* out, int blocks, int threads, int chains,
                        int iters) {
  if (chains == 4) mma_rate_kernel<4><<<blocks, threads>>>(out, iters);
  else if (chains == 8) mma_rate_kernel<8><<<blocks, threads>>>(out, iters);
  else mma_rate_kernel<16><<<blocks, threads>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def mma_tf32_rate():
    """TFLOP/s of TF32 mma.sync.m16n8k8 on the card (2 x 16 x 8 x 8 flop an
    instruction) for a few warps an SM and independent accumulators a
    warp, by CUDA events; logs each and returns the largest."""
    from tartangan_torch.ops import build
    out_dir = ROOT / "build" / "gblock_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib_path = out_dir / "mma_rate.cu", out_dir / "libmma_rate.so"
    src.write_text(MMA_RATE_SRC)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path),
                    str(src)], check=True, capture_output=True, timeout=600)
    fn = ctypes.CDLL(str(lib_path)).mma_rate
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 4 * 512, device="cuda")
    iters, best = 2000, 0.0
    for warps_sm, blocks_sm, chains in ((8, 1, 4), (8, 1, 8), (8, 1, 16),
                                        (16, 2, 8), (32, 4, 8)):
        threads = 32 * warps_sm // blocks_sm
        ms = cuda_ms(lambda: fn(out.data_ptr(), sms * blocks_sm, threads,
                                chains, iters), iters=3, reps=5)
        tflops = (sms * warps_sm * iters * chains * 2 * 16 * 8 * 8
                  / (ms * 1e-3) / 1e12)
        best = max(best, tflops)
        log(f"mma.sync m16n8k8 TF32: {warps_sm} warps an SM, {chains} "
            f"accumulators a warp: {tflops:.1f} TFLOP/s ({ms:.4f} ms)")
    return best


def gblock_ab(dirs):
    """K4 and K5 built from each of ``dirs`` (``build_gblock_variants``;
    e.g. the parent commit's sources) against the checkout's at the two
    '512thin' fused blocks' shapes, on the same inputs: each one's error
    against the plain float32 and float64 versions, then device time
    (profiler) and call time (CUDA events) in turns: the others, the
    checkout's twice, the others again. Returns the JSON-ready rows."""
    from tartangan_torch.ops import gblock as G
    variants = build_gblock_variants(dirs)
    gen = torch.Generator(device="cuda").manual_seed(19)
    rows, wrong = [], []
    for label, b, h, cin, cout in GBLOCK_SHAPES[:2]:
        p = gblock_params(cin, cout, "cuda", gen)
        x = torch.randn(b, h, h, cin, device="cuda", generator=gen)
        m1, v1 = G._moments(x)
        args_a = (x, m1, v1, p["s1"], p["o1"], p["w1"], p["b1"])
        y1r, st = G.gblock_a_plain(*args_a)
        n = 4 * b * h * h
        m2 = st.reshape(2, 4, cout).sum(1)[0] / n
        v2 = st.reshape(2, 4, cout).sum(1)[1] / n - m2 ** 2
        args_b = (y1r, x, m2, v2, p["s2"], p["o2"], p["w2"], p["b2"],
                  p["wp"], p["bp"])
        refb = G.gblock_b_plain(*args_b)
        calls = {"gblock_a": {}, "gblock_b": {}}
        for name, lib in variants:
            raw = hasattr(lib, "tt_gblock_workspace")
            calls["gblock_a"][name] = (
                (lambda lib=lib: raw_gblock_a(lib, *args_a)) if raw else
                (lambda lib=lib: other_gblock_a(lib, *args_a)),
                K4_EVENTS if raw else K4_EVENTS_PARENT)
            calls["gblock_b"][name] = (
                (lambda lib=lib: raw_gblock_b(lib, *args_b)) if raw else
                (lambda lib=lib: other_gblock_b(lib, *args_b)),
                K5_EVENTS if raw else K5_EVENTS_PARENT)
        calls["gblock_a"]["checkout"] = (lambda: G.gblock_a(*args_a),
                                         K4_EVENTS)
        calls["gblock_b"]["checkout"] = (lambda: G.gblock_b(*args_b),
                                         K5_EVENTS)
        for name, fns in calls.items():
            errs = {}
            ref = y1r if name == "gblock_a" else refb
            for v, (fn, _) in fns.items():
                out = fn()
                out = out[0] if name == "gblock_a" else out
                torch.cuda.synchronize()
                k4, k5 = gblock_f64_errors(
                    G, x, p, m1, v1, y1r, m2, v2,
                    (out, refb) if name == "gblock_a" else (y1r, out))
                errs[v] = {"f32": (out - ref).abs().max().item(),
                           "f64": k4 if name == "gblock_a" else k5}
                if _scaled_err(out, ref)[0] > TOL_PARITY["atol"]:
                    wrong.append((label, name, v))
            dev_ms = {v: [] for v in fns}
            call_ms = {v: [] for v in fns}
            others = [v for v in fns if v != "checkout"]
            for v in others + ["checkout", "checkout"] + others[::-1]:
                fn, events = fns[v]
                dev_ms[v].append(device_ms(fn, events))
                call_ms[v].append(cuda_ms(fn))
            macs = b * h * h * (16 * cin if name == "gblock_a"
                                else 36 * cout) * cout
            nbytes = 4 * (x.numel() + y1r.numel()) if name == "gblock_a" \
                else 4 * (2 * y1r.numel() + x.numel())
            row = {"kernel": name, "shape": f"{label} B{b} Cin{cin} Cout"
                                            f"{cout}",
                   "bound_fma_ms": _conv_bound_ms(macs, nbytes)[0],
                   "bound_3xtf32_ms": _tf32x3_bound_ms(macs, nbytes)[0],
                   "ms": {v: statistics.median(t) for v, t in dev_ms.items()},
                   "call_ms": {v: statistics.median(t)
                               for v, t in call_ms.items()},
                   "max_abs_err": errs}
            rows.append(row)
            log(f"gblock A/B {name} {row['shape']}: device ms (profiler, in "
                f"turns) {dev_ms}; call ms {call_ms}; bounds FMA "
                f"{row['bound_fma_ms']:.4f} ms, 3xTF32 "
                f"{row['bound_3xtf32_ms']:.4f} ms; max abs error against "
                f"the plain float32 and float64 versions {errs}")
    if wrong:
        raise AssertionError(f"gblock builds off the plain version beyond "
                             f"{TOL_PARITY}: {wrong}")
    return rows


# ------------------------------------------------- bfloat16 (--dtype bf16)
def _bf16_scaled_err(out, ref):
    assert out.dtype == ref.dtype == torch.bfloat16, (out.dtype, ref.dtype)
    scale = ref.float().abs().max()
    return ((out.float() - ref.float()).abs().max() / scale).item(), scale


def phase_parity_kernels_bf16(dev):
    """K3 (both modes), K4 and K5 in bfloat16 against their bfloat16 plain
    versions (which round at the kernels' points) at the '512thin' G
    shapes and the ragged ones (TOL_PARITY_BF16), K4's sums as float32
    sums of the y1p it stored; returns the largest max-abs error of each at
    the '512thin' shapes."""
    from tartangan_torch.ops import gblock as G
    from tartangan_torch.ops.parity_conv import (
        fused_parity_conv_plain,
        merged_tap_conv,
    )
    gen = torch.Generator(device=dev).manual_seed(21)
    worst = {"parity_conv": 0.0, "gblock_a": 0.0, "gblock_b": 0.0}
    bf = torch.bfloat16
    for label, b, h, wd, cin, cout in K3_SHAPES:
        for mode in ("up", "full"):
            wcin = cin if mode == "up" else cout
            ci = wcin if mode == "up" else 4 * wcin
            x = torch.randn(b, h, wd, ci, device=dev, generator=gen).to(bf)
            w = 0.1 * torch.randn(cout, wcin, 3, 3, device=dev, generator=gen)
            bias = torch.randn(cout, device=dev, generator=gen)
            out = merged_tap_conv(x, w, cout, mode, bias=bias)
            ref = fused_parity_conv_plain(x, w, cout, mode, bias)
            torch.cuda.synchronize()
            err, scale = _bf16_scaled_err(out, ref)
            log(f"kernel parity_conv bfloat16 '{mode}' {label} x "
                f"{tuple(x.shape)}: max_abs_err {err * scale:.3e}, {err:.3e} "
                f"of the plain output's max-abs (tolerance {TOL_PARITY_BF16}"
                f" on the latter)")
            if err > TOL_PARITY_BF16["atol"]:
                raise AssertionError(f"parity_conv bf16 {mode} {label}: {err}")
            if not label.startswith("ragged"):
                worst["parity_conv"] = max(worst["parity_conv"],
                                           err * scale.item())
            del x, out, ref
    for label, b, h, cin, cout in GBLOCK_SHAPES:
        p = gblock_params(cin, cout, dev, gen)
        x = torch.randn(b, h, h, cin, device=dev, generator=gen).to(bf)
        m1, v1 = G._moments(x)
        y1p, stats = G.gblock_a(x, m1, v1, p["s1"], p["o1"], p["w1"], p["b1"])
        y1r, statr = G.gblock_a_plain(x, m1, v1, p["s1"], p["o1"], p["w1"],
                                      p["b1"])
        n = 4 * b * h * h
        m2 = statr.reshape(2, 4, cout).sum(1)[0] / n
        v2 = statr.reshape(2, 4, cout).sum(1)[1] / n - m2 ** 2
        args = (y1r, x, m2, v2, p["s2"], p["o2"], p["w2"], p["b2"], p["wp"],
                p["bp"])
        outb, refb = G.gblock_b(*args), G.gblock_b_plain(*args)
        torch.cuda.synchronize()
        if stats.dtype != torch.float32:
            raise AssertionError(f"K4's sums are {stats.dtype}")
        # the sums are of the stored, rounded y1p
        y = y1p.double().reshape(-1, 4 * cout)
        own = torch.stack([y.sum(0), y.square().sum(0)])
        sum_err = ((stats.double() - own).abs()
                   / torch.stack([y.abs().sum(0), y.square().sum(0)])
                   .clamp_min(1e-30)).max().item()
        e_a, s_a = _bf16_scaled_err(y1p, y1r)
        e_b, s_b = _bf16_scaled_err(outb, refb)
        log(f"kernel gblock_a/gblock_b bfloat16 {label} x {tuple(x.shape)} "
            f"Cout {cout}: y1p {e_a * s_a:.3e} ({e_a:.3e} of max-abs), out_p "
            f"{e_b * s_b:.3e} ({e_b:.3e}) (tolerance {TOL_PARITY_BF16} after "
            f"dividing by max-abs); K4's float32 sums against those of its "
            f"own y1p {sum_err:.3e} of the sums of |y| (tolerance 1e-5)")
        if max(e_a, e_b) > TOL_PARITY_BF16["atol"] or sum_err > 1e-5:
            raise AssertionError(f"gblock bf16 {label}: {e_a}, {e_b}, "
                                 f"{sum_err}")
        if label.startswith("block"):
            worst["gblock_a"] = max(worst["gblock_a"], e_a * s_a.item())
            worst["gblock_b"] = max(worst["gblock_b"], e_b * s_b.item())
    return worst


def time_bf16_kernels(dev, errs16):
    """K1-K5 in bfloat16 at the bf16 parity step's shapes: the kernel's
    device time (profiler), plain version, one library call and the bound
    (bfloat16 bytes of the inputs and outputs, float32 ones for lse and
    the statistics, against the FLOPs at 989 TFLOP/s, the bf16 tensor-core
    peak). K1/K2 at G (D under ``shape_d``), K3-K5 summed over the launches
    of one G forward. Returns {name: the bf16 record}."""
    import torch.nn.functional as F

    from tartangan_torch.ops import gblock as G
    from tartangan_torch.ops import parity as P
    from tartangan_torch.ops.attention import (_bwd, _fwd,
                                               attention_bwd_plain,
                                               attention_plain)
    from tartangan_torch.ops.parity_conv import (
        fused_parity_conv_plain,
        merged_tap_conv,
    )
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(22)
    out = {}

    def rec(ms, plain_ms, lib, bound, err):
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": lib, "max_abs_err": err}
    for label, b, lq, lk, ck, cv in (("G", 64, 4096, 1024, 8, 32),
                                     ("D", 64, 1024, 256, 8, 32)):
        q, k, v, do = (torch.randn(s, device=dev, generator=gen).to(bf)
                       for s in ((b, lq, ck), (b, lk, ck), (b, lk, cv),
                                 (b, lq, cv)))

        def k1():
            return _fwd(q, k, v, with_lse=True)
        o, lse = k1()
        err1 = (o.float() - attention_plain(q, k, v).float()).abs().max()

        def k2():
            return _bwd(q, k, v, do, o, lse)
        err2 = max((a.float() - r.float()).abs().max().item()
                   for a, r in zip(k2(), attention_bwd_plain(q, k, v, do)))
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        sdpa = F.scaled_dot_product_attention(*leaves, scale=1.0)
        r1 = rec(statistics.median([device_ms(k1, K1_EVENTS)
                                    for _ in range(2)]),
                 cuda_ms(lambda: attention_plain(q, k, v)),
                 cuda_ms(lambda: F.scaled_dot_product_attention(
                     q, k, v, scale=1.0)),
                 attention_bound_ms(b, lq, lk, ck, cv, 2,
                                    peak=PEAK_BF16_FLOPS), err1.item())
        r2 = rec(statistics.median([device_ms(k2, K2_EVENTS)
                                    for _ in range(2)]),
                 cuda_ms(lambda: attention_bwd_plain(q, k, v, do), iters=5),
                 cuda_ms(lambda: torch.autograd.grad(
                     sdpa, leaves, do, retain_graph=True), iters=5),
                 attention_bound_ms(b, lq, lk, ck, cv, 2, backward=True,
                                    peak=PEAK_BF16_FLOPS), err2)
        for name, r in (("attention_fwd", r1), ("attention_bwd", r2)):
            log(f"time {name} bfloat16 {label} B{b} Lq{lq} Lk{lk}: kernel "
                f"device {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, sdpa"
                f" {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}); max_abs_err {r['max_abs_err']:.3e}")
            if label == "G":
                out[name] = r
            else:
                out[name]["shape_d"] = {
                    "shape": f"B{b} Lq{lq} Lk{lk} Ck{ck} Cv{cv}", **r}
        del q, k, v, do, o, lse, leaves, sdpa
    # K3-K5 over one G forward: ms, plain, library, bytes, flops
    tot = {k: [0.0] * 5 for k in ("parity_conv", "gblock_a", "gblock_b")}
    for label, b, h, wd, cin, cout in K3_SHAPES[:4]:
        for mode in ("up", "full"):
            wcin = cin if mode == "up" else cout
            ci = wcin if mode == "up" else 4 * wcin
            x = torch.randn(b, h, wd, ci, device=dev, generator=gen).to(bf)
            w = 0.1 * torch.randn(cout, wcin, 3, 3, device=dev, generator=gen)
            bias = torch.randn(cout, device=dev, generator=gen)
            w3 = (P.pack_up_conv if mode == "up" else P.pack_full_conv)(w)
            w3, b4 = w3.to(bf), bias.repeat(4).to(bf)
            xc = x.permute(0, 3, 1, 2)
            it = 5 if h >= 128 else 20

            def kern():
                return merged_tap_conv(x, w, cout, mode, bias=bias)
            ms = statistics.median([device_ms(kern, K3_EVENTS)
                                    for _ in range(2)])
            plain = cuda_ms(lambda: fused_parity_conv_plain(
                x, w, cout, mode, bias), iters=it)
            lib = cuda_ms(lambda: F.conv2d(xc, w3, b4, padding=1), iters=it)
            taps = 16 * wcin if mode == "up" else 36 * wcin
            flops = 2 * b * h * wd * taps * cout
            nbytes = 2 * (x.numel() + b * h * wd * 4 * cout) \
                + 4 * (w.numel() + cout)
            bound = _bound(nbytes, flops, PEAK_BF16_FLOPS)
            log(f"time parity_conv bfloat16 '{mode}' {label}: kernel device "
                f"{ms:.4f} ms, plain {plain:.4f} ms, F.conv2d bf16 3x3-packed"
                f" + bias {lib:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
            for i, val in enumerate((ms, plain, lib, nbytes, flops)):
                tot["parity_conv"][i] += val
            del x, xc
    for label, b, h, cin, cout in GBLOCK_SHAPES[:2]:
        p = gblock_params(cin, cout, dev, gen)
        x = torch.randn(b, h, h, cin, device=dev, generator=gen).to(bf)
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
        for name, kern, plain, args, events, flops, nbytes in (
                ("gblock_a", G.gblock_a, G.gblock_a_plain, args_a, K4_EVENTS,
                 2 * pos * 16 * cin * cout,
                 2 * (x.numel() + y1p.numel()) + 4 * 2 * 4 * cout),
                ("gblock_b", G.gblock_b, G.gblock_b_plain, args_b, K5_EVENTS,
                 2 * pos * 36 * cout * cout,
                 2 * (2 * y1p.numel() + x.numel()))):
            ms = statistics.median([device_ms(lambda: kern(*args), events)
                                    for _ in range(2)])
            plain_ms = cuda_ms(lambda: plain(*args))
            bound = _bound(nbytes, flops, PEAK_BF16_FLOPS)
            log(f"time {name} bfloat16 {label} x {tuple(x.shape)}: kernel "
                f"device {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                f"{bound[0]:.4f} ms ({bound[1]})")
            for i, val in enumerate((ms, plain_ms, 0.0, nbytes, flops)):
                tot[name][i] += val
    for name, (ms, plain_ms, lib, nbytes, flops) in tot.items():
        out[name] = rec(ms, plain_ms, lib if name == "parity_conv" else None,
                        _bound(nbytes, flops, PEAK_BF16_FLOPS), errs16[name])
        log(f"kernels line {name} bfloat16, summed over one G forward: "
            f"kernel device {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{out[name]['bound_ms']:.4f} ms")
    return out


def hold_parity_bf16(par16, init, batch, z_d, z_g, exact):
    """The bfloat16 parity step with K1-K5 against the plain '512thin' step
    in float64 (``exact``, from the same weights, batch and latents), within
    PARITY_WITNESS_FACTOR times the farthest bfloat16 step without the
    kernels (the parity forms with FUSED_G off, the fused blocks and the
    attention on their plain versions; the plain path on the plain
    attention): gradients as in the float32 hold, losses and gp by the same
    rule. Returns what failed."""
    from tartangan_torch.train.cnn import CNNTrainer
    plain16 = CNNTrainer.create_from_cli([
        str(TRAIN_DIR / "tartans512.npy"),
        "--config", "512thin", "--parity-blocks", "off", "--batch-size",
        str(batch.shape[0]), "--dtype", "bf16", "--device", "cuda",
        "--run-id", "plain16", "--output", str(PARITY_DIR / "out")])

    def fresh(t, plain_tree):
        t.build_models()
        t.state.g.load_state_dict(plain_state_from_fused(init["g"])
                                  if plain_tree else init["g"])
        t.state.d.load_state_dict(init["d"])
    kern = "bf16 parity, kernels"
    steps = {}
    fresh(par16, False)
    set_fused_kernels(par16, True)
    steps[kern] = _step_grads(par16, batch, z_d, z_g, plain_names=True)
    fresh(par16, False)
    set_fused_kernels(par16, False)
    set_attention_kernel(par16, False)
    steps[f"bf16 {FORMS}, plain attention"] = _step_grads(
        par16, batch, z_d, z_g, plain_names=True)
    set_fused_kernels(par16, True)
    set_attention_kernel(par16, True)
    fresh(plain16, True)
    set_attention_kernel(plain16, False)
    steps["bf16 plain, plain attention"] = _step_grads(plain16, batch, z_d,
                                                       z_g)
    del plain16
    witnesses, failed = {}, []
    for label, step in steps.items():
        if label != kern:
            witnesses[label], _ = _hold(f"witness: {label} vs float64", step,
                                        exact, losses=False)
    spread = {tag: {k: max(w[tag][k] for w in witnesses.values())
                    for k in ("max", "norm")} for tag in ("g", "d")}
    failed += _hold(f"{kern} vs float64", steps[kern], exact, spread,
                    losses=False)[1]
    m64 = exact[0]
    for k, v in steps[kern][0].items():
        far = max(abs(steps[w][0][k] - m64[k]) for w in witnesses)
        tol = max(PARITY_WITNESS_FACTOR * far,
                  TOL_STEP_LOSS["atol"] + TOL_STEP_LOSS["rtol"] * abs(m64[k]))
        log(f"hold {kern} vs float64: {k} {v:.6f} vs {m64[k]:.6f}, error "
            f"{abs(v - m64[k]):.3e} (tolerance {tol:.3e}: "
            f"{PARITY_WITNESS_FACTOR}x the farthest bf16 step without the "
            f"kernels, {far:.3e})")
        if abs(v - m64[k]) > tol:
            failed.append(f"{kern}: {k}")
    for label in witnesses:
        _hold(f"{kern} vs {label}", steps[kern], steps[label], losses=False)
    return failed


def time_steps(label, trainers, batch, z_d, z_g, reps=2, extra=None):
    """Each trainer's step in turns (host clock, synchronized, after a
    warm-up), its peak device memory and a profile (device time by kernel,
    idle share); ``extra`` the step's other draws (the IQN step's taus).
    Returns {name: median ms}."""
    def once(t):
        t0 = time.perf_counter()
        t._train_step(t.state, batch, z_d, z_g, **(extra or {}))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3
    for t in trainers.values():
        once(t)
    times = {name: [] for name in trainers}
    for _ in range(reps):
        for name, t in trainers.items():
            times[name].append(once(t))
    b = batch.shape[0]
    med = {name: statistics.median(v) for name, v in times.items()}
    for name, t in trainers.items():
        torch.cuda.reset_peak_memory_stats()
        once(t)
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"time train step {label} {name} B{b} (host clock, synchronized,"
            f" {reps} in turns after warm-up): median {med[name]:.3f} ms "
            f"{[round(x, 3) for x in times[name]]}, {1e3 * b / med[name]:.1f}"
            f" images/s; peak device memory {peak:.2f} GiB")
        profile_call(f"train step {label} {name} B{b}", lambda: once(t))
    return med


def phase_128(archive):
    """Config '128' (the JAX package's main path and ``bench.py``'s
    headline: blocks 128-128-64-32-16, latent 256, no attention, plain
    blocks) at B 128 in float32 and in bfloat16: 3 steps each through the
    trainer's entry points (128x128 crops of the 512x512 archive, one batch
    an epoch), finite losses, a float32 checkpoint; then the two steps
    timed in turns, with images/s, peak memory and a profile each."""
    from tartangan_torch.train.cnn import CNNTrainer
    out_root = ROOT / "build" / "chip_smoke_128" / "out"
    trainers = {}
    for dtype in ("f32", "bf16"):
        shutil.rmtree(out_root / dtype, ignore_errors=True)
        t = CNNTrainer.create_from_cli([
            str(archive), "--config", "128", "--batch-size", "128",
            "--epochs", "3", "--dtype", dtype, "--device", "cuda",
            "--run-id", dtype, "--output", str(out_root), "--log-iters", "1",
            "--log-progress-newlines", "--gen-freq", "1000"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = {k: [float(v) for v in t.logs[k]]
                  for k in ("g_loss", "d_loss", "gp")}
        log(f"128: config '128' B128 {dtype}: {t.steps} steps in {wall:.1f} "
            f"s (host clock, sampling and checkpoints included); losses "
            f"{losses}")
        for k, vals in losses.items():
            assert len(vals) == 3 and all(np.isfinite(vals)), (k, vals)
        assert {p.dtype for p in t.state.g.parameters()} == {torch.float32}
        trainers[dtype] = t
    t = trainers["f32"]
    batch = torch.from_numpy(t.dataset.batch(
        np.arange(128), np.random.default_rng(0))).to(t.device)
    gen = torch.Generator(device=t.device).manual_seed(17)
    z_d = torch.randn((1, 128, 256), generator=gen, device=t.device)
    z_g = torch.randn((128, 256), generator=gen, device=t.device)
    time_steps("'128'", trainers, batch, z_d, z_g)


EVAL_DIR = ROOT / "build" / "chip_smoke_eval"
FIXTURES = ROOT / "tests" / "fixtures"
CALIBRATED = FIXTURES / "inception_calibrated.npz"
# the JAX Inception's pool and logits on the crc32-keyed fixture weights,
# and the JAX test's tolerance (tests/test_inception_weights.py:120-131)
TOL_INCEPTION_FIXTURE = dict(rtol=2e-4, atol=2e-4)
# the card's forward against the port's CPU forward, of the max-abs: both
# IEEE float32, summed in other orders through 94 convolutions
TOL_INCEPTION_CPU = 1e-4
# Newton-Schulz in float32 on the card against the float64 eigh form, on
# the same mu and sigma (the JAX test's bound,
# tests/test_inception_fid.py:29-38)
TOL_FID_NS = 1e-2
# images: more than 2048, so the dataset's 2048-dim covariance has full
# rank; 17 batches of 128
EVAL_DATA_IMAGES = 2176
EVAL_IMAGES = 4096
EVAL_BATCH = 128


def inception_fixture_weights(model):
    """The JAX tests' torchvision-schema fixture weights
    (``tests/test_inception_weights.py::synthetic_state_dict``): each
    tensor drawn from a generator seeded by the crc32 of its torchvision
    key, in the torch shape; BatchNorm weight and running_var uniform in
    [0.5, 1.5], everything else normal(0, 0.05). Built over the port's
    ``torch_key_map``."""
    from tartangan_torch.models.inception import torch_key_map
    state = model.state_dict()
    out = {}
    for flax_key, torch_key in torch_key_map(model).items():
        shape = tuple(state[torch_key].shape)
        rng = np.random.default_rng(zlib.crc32(torch_key.encode()))
        if flax_key.split(".")[-1] in ("scale", "var"):
            val = rng.uniform(0.5, 1.5, shape)
        else:
            val = rng.normal(0.0, 0.05, shape)
        out[torch_key] = val.astype(np.float32)
    return out


def inception_macs(model, dev):
    """Multiply-adds of one image through the network at 299x299, counted
    from the shapes of its convolutions' outputs and the fc layer."""
    total = [0]

    def hook(mod, inputs, out):
        if isinstance(mod, torch.nn.Conv2d):
            kh, kw = mod.kernel_size
            total[0] += out[0].numel() * mod.in_channels * kh * kw
        else:
            total[0] += mod.in_features * mod.out_features
    handles = [mod.register_forward_hook(hook) for mod in model.modules()
               if isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        with torch.no_grad():
            model(torch.zeros((1, 3, 299, 299), device=dev))
    finally:
        for h in handles:
            h.remove()
    return total[0]


def hold_inception(dev):
    """Holds 1 and 2: the port's Inception on the card against the JAX
    package's committed output on the fixture weights, and on the seed-0
    template with the calibrated statistics against the port's CPU
    forward at B 8."""
    from tartangan_torch.models import inception as I
    model = I.init_inception()
    I.port_torch_state_dict(model, inception_fixture_weights(model))
    x = np.random.default_rng(42).uniform(-1.0, 1.0, (1, 299, 299, 3))
    x = torch.from_numpy(x.astype(np.float32).transpose(0, 3, 1, 2))
    with torch.no_grad():
        pool, logits = model.to(dev)(x.to(dev))
    expected = np.load(FIXTURES / "inception_port_expected.npz")
    errs = {}
    for name, out in (("pool", pool), ("logits", logits)):
        out = out.cpu().numpy()
        np.testing.assert_allclose(out, expected[name],
                                   **TOL_INCEPTION_FIXTURE)
        errs[name] = float(np.abs(out - expected[name]).max())
    log(f"eval: Inception v3 on the card, fixture weights, against the JAX "
        f"package's output (inception_port_expected.npz): max abs error "
        f"{errs} (tolerance {TOL_INCEPTION_FIXTURE})")

    model = I.load_weights_npz(I.init_inception(0), CALIBRATED)
    x = torch.from_numpy(np.random.default_rng(43).uniform(
        -2.0, 2.0, (8, 3, 299, 299)).astype(np.float32))
    with torch.no_grad():
        ref = model(x)
        out = model.to(dev)(x.to(dev))
    errs = {}
    for name, a, b in zip(("pool", "logits"), out, ref):
        err = float((a.cpu() - b).abs().max() / b.abs().max())
        errs[name] = err
        if not err <= TOL_INCEPTION_CPU:
            raise AssertionError(f"Inception card vs CPU {name}: {err}")
    log(f"eval: Inception v3 (seed-0 template + calibrated statistics) B 8, "
        f"card against the port's CPU forward: max abs error over max-abs "
        f"{errs} (tolerance {TOL_INCEPTION_CPU})")


def fid_trainer(archive, moments_path, dtype, dev):
    """Config '128' at B 128 for 3 steps through the trainer's entry
    points, with ``--fid --fid-freq 2 --n-inception-imgs 4096`` and the
    TensorBoard collector; the FID fires once, at step 2."""
    from tartangan_torch.train.cnn import CNNTrainer
    from tartangan_torch.utils import tb_events
    out_root = EVAL_DIR / "out"
    shutil.rmtree(out_root / dtype, ignore_errors=True)
    tb = EVAL_DIR / "tb" / dtype
    shutil.rmtree(tb, ignore_errors=True)
    t = CNNTrainer.create_from_cli([
        str(archive), "--config", "128", "--batch-size", str(EVAL_BATCH),
        "--epochs", "3", "--dtype", dtype, "--device", str(dev),
        "--run-id", dtype, "--output", str(out_root), "--gen-freq", "1000",
        "--quiet-logs", "--fid", "--fid-freq", "2",
        "--n-inception-imgs", str(EVAL_IMAGES),
        "--inception-moments", str(moments_path),
        "--inception-weights", str(CALIBRATED),
        "--metrics-collector", "tensorboard", "--metrics-path", str(tb)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fids = [float(v) for v in t.logs["fid"]]
    scores = [(float(a), float(b)) for a, b in zip(
        t.logs["inception_score_mean"], t.logs["inception_score_std"])]
    assert t.steps == 3 and len(fids) == 1, (t.steps, fids)
    assert np.isfinite(fids[0]) and fids[0] >= 0, fids
    (name,) = [p for p in (tb / dtype).iterdir()]
    events = [tb_events.decode_scalar_event(r)
              for r in tb_events.read_records(name)]
    last = events[-1][2]
    assert events[-1][1] == 2 and last["CNNTrainer/fid"] == np.float32(
        fids[0]), (events[-1][:2], last)
    log(f"eval: '128' B{EVAL_BATCH} {dtype} with --fid: 3 steps in "
        f"{wall:.1f} s (host clock; the FID at step 2 over {EVAL_IMAGES} "
        f"images included); fid {fids[0]!r}, IS (mean, std) {scores}; the "
        f"event file {name.name} reads back {len(events)} records, the "
        f"last at step 2 with CNNTrainer/fid = {last['CNNTrainer/fid']!r}")
    return t


def time_fid(trainer, net, data_mu, data_sigma, label):
    """Holds 3 and 4, and the times of the FID closure's parts over
    EVAL_IMAGES images of ``trainer``'s G: G sampling -> Inception ->
    moment sums run under ``torch.cuda.set_sync_debug_mode("error")``
    after a warm-up batch, until the one readback; the on-card
    Newton-Schulz FID against the float64 form on the same mu and sigma."""
    from tartangan_torch.eval.fid import (
        frechet_distance,
        inception_score,
        numpy_frechet_distance,
    )
    from tartangan_torch.eval.inception import (
        finish_moments,
        stream_activations,
    )
    stream_activations(trainer.generate, net, 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sums = stream_activations(trainer.generate, net, EVAL_IMAGES)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    probs, mu, sigma = finish_moments(*sums)
    t_stream = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert probs.shape == (EVAL_IMAGES, 1000) and np.isfinite(sigma).all()

    def dev(a):
        return torch.as_tensor(a, device=trainer.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ns = float(frechet_distance(dev(mu), dev(sigma), dev(data_mu),
                                dev(data_sigma)))
    t_ns = time.perf_counter() - t0
    t0 = time.perf_counter()
    is_mean, is_std = inception_score(probs, 5)
    t_is = time.perf_counter() - t0
    t0 = time.perf_counter()
    exact = numpy_frechet_distance(mu, sigma, data_mu, data_sigma)
    t_np = time.perf_counter() - t0
    fallback = not np.isfinite(ns) or ns < 0
    rel = abs(ns - exact) / abs(exact)
    log(f"eval {label}: {EVAL_IMAGES} images G -> Inception -> moment sums "
        f"ran under set_sync_debug_mode('error') after a warm-up batch, "
        f"{t_stream:.3f} s to the readback (host clock), peak device memory "
        f"{peak:.2f} GiB; FID Newton-Schulz float32 on the card {ns!r} "
        f"({t_ns * 1e3:.1f} ms), float64 eigh on the host {exact!r} "
        f"({t_np * 1e3:.0f} ms), relative difference {rel:.3e} (tolerance "
        f"{TOL_FID_NS}); robust_frechet falls back: {fallback}; IS "
        f"{is_mean:.5f} +/- {is_std:.5f} ({t_is * 1e3:.1f} ms)")
    if fallback or not rel <= TOL_FID_NS:
        raise AssertionError(f"FID on the card {ns} vs float64 {exact}")

    # the parts apart, each synchronized, by CUDA events
    n_batches = EVAL_IMAGES // EVAL_BATCH
    parts = {}

    def timed(name, fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        parts[name] = start.elapsed_time(end)
        return out
    images = timed("G sampling", lambda: [trainer.generate()
                                          for _ in range(n_batches)])
    outs = timed("Inception", lambda: [net(x) for x in images])
    sum_x = torch.zeros(2048, device=trainer.device)
    sum_xxt = torch.zeros(2048, 2048, device=trainer.device)

    def moments():
        for pool, _ in outs:
            sum_x.add_(pool.sum(0))
            sum_xxt.addmm_(pool.T, pool)
    timed("moments", moments)
    timed("Newton-Schulz", lambda: frechet_distance(
        dev(mu), dev(sigma), dev(data_mu), dev(data_sigma)))
    parts["IS (host)"] = t_is * 1e3
    log(f"eval {label}: the FID closure's parts at {EVAL_IMAGES} images "
        f"(CUDA events, each part alone): " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in parts.items()))
    del images, outs
    return parts


def time_inception(net, dev, smi):
    """Inception's forward at B 128 (normalize, resize 128 -> 299, the
    network, softmax): images/s by device time (CUDA events) and by the
    host clock, against the float32 FMA bound of its multiply-adds."""
    x = torch.rand((EVAL_BATCH, 3, 128, 128), device=dev) * 2 - 1
    ms = cuda_ms(lambda: net(x), iters=5, reps=5)

    def synced():
        net(x)
        torch.cuda.synchronize()
    wall = host_ms(synced, reps=10)
    macs = inception_macs(net.model, dev)
    bound, by = _conv_bound_ms(macs * EVAL_BATCH, x.numel() * 4)
    log(f"eval: Inception v3 forward B{EVAL_BATCH} float32 from 128x128: "
        f"{ms:.3f} ms by device time ({1e3 * EVAL_BATCH / ms:.1f} images/s), "
        f"{wall:.3f} ms by host clock ({1e3 * EVAL_BATCH / wall:.1f} "
        f"images/s); {macs / 1e9:.4f} G multiply-adds an image, float32 FMA "
        f"bound {bound:.3f} ms ({by}), {100 * bound / ms:.1f} % of it; "
        f"{smi}")
    profile_call(f"Inception forward B{EVAL_BATCH}", synced)
    return ms, wall


def phase_eval(dev, archive, smi):
    """Phase 10: holds 1-4 and the times of evaluation while training."""
    from tartangan_torch.data.image_bytes import ImageBytesDataset
    from tartangan_torch.data.synthetic import make_archive
    from tartangan_torch.eval.inception import InceptionWrapper
    from tartangan_torch.eval.moments import calculate_inception_moments
    hold_inception(dev)
    gc.collect()
    torch.cuda.empty_cache()

    EVAL_DIR.mkdir(parents=True, exist_ok=True)
    data = EVAL_DIR / "tartans128.npy"
    np.save(data, make_archive(EVAL_DATA_IMAGES, 128, seed=1))
    moments_path = EVAL_DIR / "moments128.npz"
    t0 = time.perf_counter()
    subprocess.run(
        [sys.executable, "-m", "tartangan_torch.eval.moments", str(data),
         str(moments_path), "--batch-size", str(EVAL_BATCH),
         "--inception-weights", str(CALIBRATED), "--device", str(dev)],
        cwd=ROOT, check=True, timeout=600)
    cli_s = time.perf_counter() - t0
    with np.load(moments_path) as m:
        data_mu, data_sigma = m["mu"], m["sigma"]
    assert data_mu.shape == (2048,) and np.isfinite(data_sigma).all()
    log(f"eval: python -m tartangan_torch.eval.moments over "
        f"{EVAL_DATA_IMAGES} 128x128 images, B {EVAL_BATCH}: {cli_s:.1f} s "
        f"wall (host clock, process start included)")

    net = InceptionWrapper(weights=str(CALIBRATED), device=dev)
    # the same moments in this process, warm: the CLI's wall less its
    # start-up, and its output against the library's
    ds = ImageBytesDataset.from_path(data)
    calculate_inception_moments(ds, net, EVAL_BATCH, quiet=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mu, sigma = calculate_inception_moments(ds, net, EVAL_BATCH, quiet=True)
    warm_s = time.perf_counter() - t0
    err = max(float(np.abs(mu - data_mu).max() / np.abs(data_mu).max()),
              float(np.abs(sigma - data_sigma).max()
                    / np.abs(data_sigma).max()))
    log(f"eval: the same moments in this process, warm: {warm_s:.3f} s "
        f"(host clock); against the CLI's, max abs error over max-abs "
        f"{err:.3e} (tolerance {TOL_INCEPTION_CPU})")
    if not err <= TOL_INCEPTION_CPU:
        raise AssertionError(f"moments CLI vs in-process: {err}")
    del ds
    time_inception(net, dev, smi)
    for dtype in ("f32", "bf16"):
        t = fid_trainer(archive, moments_path, dtype, dev)
        fid = next(c for c in t.components.components
                   if type(c).__name__ == "FIDComponent")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        closure = fid.get_inception_metrics(t.generate, EVAL_IMAGES, 5)
        wall = time.perf_counter() - t0
        log(f"eval {dtype}: the FID closure at {EVAL_IMAGES} images, "
            f"{wall * 1e3:.1f} ms wall (host clock; G sampling, Inception, "
            f"moments, readback, Newton-Schulz, IS); (IS mean, IS std, FID) "
            f"{closure}")
        time_fid(t, net, data_mu, data_sigma, dtype)
        del t, fid
        gc.collect()
        torch.cuda.empty_cache()


DISPATCH_DIR = ROOT / "build" / "chip_smoke_dispatch"
# the '128' cells' archive: the 192 512x512 tartans repeated to 1024 rows,
# 8 batches of 128 an epoch (two calls of K = 4); each step crops 128x128
DISPATCH_IMAGES = 1024
# K1-K5's device events in a replay: K1 and K2 by their main kernels, K3
# by its one, K4 by its reduce, K5 by the conv kernel K4 shares with it
REPLAY_EVENTS = {"attention_fwd": kernel_names("attention_fwd_kernel"),
                 "attention_bwd": kernel_names("dkdv_kernel"),
                 "parity_conv": kernel_names("tile_kernel"),
                 "gblock_a": kernel_names("reduce_partials"),
                 "gblock_conv": kernel_names("conv_kernel")}
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch")


def dispatch_trainer(archive, run_id, *extra, parity=False):
    """A trainer of '128' at B 128, or of '512thin' at B 64 with the
    parity path of phase 7 (``--parity-blocks on``, FUSED_G, fused G
    blocks), through ``create_from_cli``."""
    from tartangan_torch.ops import parity as P
    from tartangan_torch.train.cnn import CNNTrainer
    out = DISPATCH_DIR / "out"
    shutil.rmtree(out / run_id, ignore_errors=True)
    argv = [str(archive), "--config", "512thin" if parity else "128",
            "--batch-size", "64" if parity else "128", "--epochs", "1",
            "--device", "cuda", "--run-id", run_id, "--output", str(out),
            "--quiet-logs", "--gen-freq", "100000", *extra]
    if not parity:
        return CNNTrainer.create_from_cli(argv)
    P.FUSED_G = True
    return parity_trainer(argv + ["--parity-blocks", "on"])


def train_dispatch(label, trainer, calls, k):
    """``trainer.train()``; every loss finite, ``calls`` stacked (K,)
    entries of each metric; returns the flat gp."""
    from tartangan_torch.train.multi import GraphedChunk
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    flat = {}
    for key in ("g_loss", "d_loss", "gp"):
        entries = trainer.logs[key]
        assert len(entries) == calls and all(
            e.shape == (k,) for e in entries), (key, entries)
        flat[key] = torch.cat(entries).float().cpu()
        assert torch.isfinite(flat[key]).all(), (key, flat[key])
    assert trainer.steps == calls * k
    call = trainer._chunk_call
    assert isinstance(call, GraphedChunk), type(call)
    log(f"dispatch {label}: {calls} calls of {k} steps in {wall:.1f} s "
        f"(host clock: warm-up, capture of {len(call.graphs)} graph(s), "
        f"replays, sampling and checkpoints); losses "
        f"{ {k_: [round(float(v), 4) for v in t] for k_, t in flat.items()} }")
    return flat["gp"]


def state_groups(state):
    """The train state's tensors by group: parameters, statistics and
    Adam's moments of G and D, and the EMA target."""
    groups = {"g_target params": list(state.g_target.parameters())}
    for name in ("g", "d"):
        m, opt = getattr(state, name), getattr(state, f"opt_{name}")
        groups[f"{name} params"] = list(m.parameters())
        groups[f"{name} stats"] = list(m.buffers())
        for key in ("exp_avg", "exp_avg_sq"):
            groups[f"{name} adam {key}"] = [opt.state[p][key]
                                            for p in m.parameters()]
    return groups


def graph_run(state, fn, inputs, step0, draws, tensors, start):
    """Put the train state back at ``start``, run one K-step call through
    ``fn`` and return its metrics, the state by group and Adam's step
    counts (clones)."""
    with torch.no_grad():
        for t, s0 in zip(tensors, start):
            t.copy_(s0)
    metrics = {k: v.clone() for k, v in
               fn(state, inputs, step0, **draws).items()}
    groups = {name: [t.detach().clone() for t in ts]
              for name, ts in state_groups(state).items()}
    steps = [o.state[p]["step"].clone() for o in (state.opt_g, state.opt_d)
             for p in o.state]
    return metrics, groups, steps


def rel_loss_err(a, b):
    """Each metric's largest error relative to ``b``, over the K steps."""
    return {k: float(((a[k] - b[k]).abs() / b[k].abs().clamp_min(1e-30))
                     .max()) for k in b}


def run_errors(run, ref, before):
    """``run`` against ``ref`` (each a ``graph_run``): the losses' largest
    relative error; for each group of parameters, the error in the norm of
    its change from ``before`` over that norm (and the norm of the
    difference of the changes over it); for the statistics and Adam's
    moments, the max abs error over the group's max-abs."""
    errs = {"losses": max(rel_loss_err(run[0], ref[0]).values())}
    change = {}
    with torch.no_grad():
        for name, group in ref[1].items():
            if name in before:
                d_r = torch.cat([(a - b).flatten().double()
                                 for a, b in zip(run[1][name], before[name])])
                d_e = torch.cat([(a - b).flatten().double()
                                 for a, b in zip(group, before[name])])
                norm = float(d_e.norm())
                errs[name] = abs(float(d_r.norm()) - norm) / (norm or 1.0)
                change[name] = (norm, float((d_r - d_e).norm()) / (norm or 1))
            else:
                scale = max(float(t.abs().max()) for t in group) or 1.0
                errs[name] = max(float((a - b).abs().max()) for a, b in
                                 zip(run[1][name], group)) / scale
    return errs, change


def same_runs(a, b):
    """Two ``graph_run`` results equal bit for bit."""
    return (all(torch.equal(a[0][k], b[0][k]) for k in b[0])
            and all(torch.equal(x, y) for k in b[1]
                    for x, y in zip(a[1][k], b[1][k]))
            and all(torch.equal(x, y) for x, y in zip(a[2], b[2])))


def hold_graph(label, trainer):
    """The trainer's own K-step graph, the one it trained with and that
    ``time_dispatch`` times, replayed against the same K steps run eagerly
    (``multi_step``, the graph's plain version), from one state and one set
    of draws, at the training rates and then with both rates 0 (the rates
    are device tensors that the graph reads, ``make_adam``).

    At the training rates every step after the first reads the weights the
    steps before it updated, and G's loss reads D's update of its step.
    Where the replay and eager differ at all, a second eager run (the
    witness) must differ too: if eager reproduces itself bit for bit (as in
    bfloat16), so must the replay. Then the losses' largest relative error
    and, for each group of parameters, the error in the norm of its change
    over the call are held within TOL_GRAPH_TRAINED; the statistics and
    Adam's moments are logged. In float32 atomic sums (cuDNN, the bilinear
    backward) differ from run to run, and Adam with beta1 = 0 moves a
    weight whose gradient is near 0 by +-lr on the sign of its noise, so
    that two eager runs of 4 steps land up to 5.5e-4 apart in a loss and
    4.0e-2 of the max-abs in G's first moment (NVIDIA H100): the change's
    norm hardly moves, the weights do.

    With both rates 0 each step's gradients come from the same weights:
    the losses within TOL_STEP_LOSS, the statistics, the EMA target and
    Adam's moments within TOL_STEP_GRAD of each group's max-abs. The eager
    run with rates 0 also shows that the trained check sees the update: its
    losses are farther than TOL_GRAPH_TRAINED from the trained run's, and
    every group of parameters moved at the training rates. Adam's step
    counts are equal in both pairs. Puts the state and the rates back."""
    from tartangan_torch.train.multi import state_tensors
    state, call = trainer.state, trainer._chunk_call
    step0 = trainer.steps
    assert call.multi_step.pattern(step0) in call.graphs, "a new capture"
    groups = [g for o in (state.opt_g, state.opt_d) for g in o.param_groups]
    assert all(isinstance(g["lr"], torch.Tensor) for g in groups)
    rates = [float(g["lr"]) for g in groups]
    tensors = state_tensors(state)
    start = [t.detach().clone() for t in tensors]
    before = {name: [t.detach().clone() for t in ts]
              for name, ts in state_groups(state).items()
              if name.endswith("params")}
    draws = trainer.chunk_draws(True)
    args = (trainer._archive, step0, draws, tensors, start)
    runs = {}
    try:
        runs["graph"] = graph_run(state, call, *args)
        runs["eager"] = graph_run(state, call.multi_step, *args)
        if not same_runs(runs["graph"], runs["eager"]):
            runs["witness"] = graph_run(state, call.multi_step, *args)
        for g in groups:
            g["lr"].fill_(0.0)
        runs["graph lr 0"] = graph_run(state, call, *args)
        runs["eager lr 0"] = graph_run(state, call.multi_step, *args)
        torch.cuda.synchronize()
    finally:
        for g, r in zip(groups, rates):
            g["lr"].fill_(r)
        with torch.no_grad():
            for t, s0 in zip(tensors, start):
                t.copy_(s0)
    graph, eager = runs["graph"], runs["eager"]
    errs, change = run_errors(graph, eager, before)
    errs0, _ = run_errors(runs["graph lr 0"], runs["eager lr 0"], before)
    seen = max(rel_loss_err(runs["eager lr 0"][0], eager[0]).values())
    witness = runs.get("witness")
    reproducible = witness is not None and same_runs(witness, eager)
    trained = {k: v for k, v in errs.items()
               if k == "losses" or k in before}
    shown = {k: f"{v:.2e}" for k, v in errs.items()}
    log(f"hold graph {label}: the trainer's replay of "
        f"{len(eager[0]['g_loss'])} steps vs the same steps eager; at the "
        f"training rates g_loss {graph[0]['g_loss'].tolist()} vs "
        f"{eager[0]['g_loss'].tolist()}, "
        + ("equal bit for bit" if witness is None else
           f"a second eager run {'equal' if reproducible else 'not equal'} "
           f"to the first bit for bit; the losses' relative error and each "
           f"parameter group's error in the norm of its change (tolerance "
           f"{TOL_GRAPH_TRAINED}), the rest's max abs error over its "
           f"max-abs (logged): {shown}")
        + f"; the change's norm and the norm of the difference of the "
        f"changes over it "
        f"{ {k: f'{n:.3e}, {d:.3e}' for k, (n, d) in change.items()} }; "
        f"rates 0 move a loss {seen:.3e} from the trained run; with rates "
        f"0, error over each group's max-abs (parameters: of their change) "
        f"{ {k: f'{v:.2e}' for k, v in errs0.items()} } (losses "
        f"{TOL_STEP_LOSS['rtol']} relative, the rest "
        f"{TOL_STEP_GRAD['atol']})")
    bad = {}
    if witness is not None:
        if reproducible:
            bad["eager reproduces itself, the replay does not"] = shown
        bad.update({k: v for k, v in trained.items()
                    if not v <= TOL_GRAPH_TRAINED})
    bad.update({k: "did not move" for k, (n, _) in change.items()
                if not n > 0})
    if not seen > TOL_GRAPH_TRAINED:
        bad["rates 0 move no loss past the tolerance"] = seen
    for k in eager[0]:
        torch.testing.assert_close(runs["graph lr 0"][0][k],
                                   runs["eager lr 0"][0][k], **TOL_STEP_LOSS)
    bad.update({f"{k}, rates 0": v for k, v in errs0.items()
                if k != "losses" and not v <= TOL_STEP_GRAD["atol"]})
    for a, b in ((graph, eager), (runs["graph lr 0"], runs["eager lr 0"])):
        if not all(torch.equal(x, y) for x, y in zip(a[2], b[2])):
            bad["Adam's step counts"] = [x.item() for x in a[2][:2]]
    if bad:
        raise AssertionError(f"graph vs eager {label}: {bad}")


def hold_adam(params, lr):
    """``make_adam`` on the card (capturable, the optimizer of every CUDA
    run) against torch's Adam with the same hyperparameters and
    ``capturable=False``, the form the CPU tests hold against
    ``optax.adam``: 3 steps of seeded gradients on two copies of
    ``params``. Each parameter, moment and step count within TOL_ADAM (a
    few float32 ulps; the two compute the bias corrections apart, on the
    card and on the host); an update without its bias correction or at
    another rate is off by lr or more."""
    from tartangan_torch.train.common import make_adam
    copies = [[p.detach().clone().requires_grad_() for p in params]
              for _ in range(2)]
    cap = make_adam(copies[0], lr)
    plain = torch.optim.Adam(copies[1], lr=lr, betas=(0.0, 0.999),
                             eps=1e-8, capturable=False)
    assert cap.defaults["capturable"], cap.defaults
    gen = torch.Generator(device=params[0].device).manual_seed(11)
    for _ in range(3):
        for a, b in zip(*copies):
            a.grad = 1e-3 * torch.randn(a.shape, generator=gen,
                                        device=a.device)
            b.grad = a.grad.clone()
        cap.step()
        plain.step()
    worst = {}
    for a, b in zip(*copies):
        pairs = [("params", a, b)] + [
            (k, cap.state[a][k], plain.state[b][k])
            for k in ("exp_avg", "exp_avg_sq", "step")]
        for k, x, y in pairs:
            x, y = x.detach().double().cpu(), y.detach().double().cpu()
            err = float(((x - y).abs() / (lr if k == "params" else
                                           y.abs().clamp_min(1e-30))).max())
            worst[k] = max(worst.get(k, 0.0), err)
            torch.testing.assert_close(
                x, y, rtol=TOL_ADAM["rtol"],
                atol=TOL_ADAM["atol"] * lr if k == "params" else 0.0)
    moved = max(float((b - p).abs().max()) for b, p in zip(copies[1], params))
    log(f"hold adam: make_adam (capturable) vs torch Adam (capturable=False) "
        f"over 3 steps on {len(params)} tensors "
        f"({sum(p.numel() for p in params)} values), lr {lr}: largest "
        f"move {moved:.3e}; largest error (params over lr, the rest "
        f"relative) { {k: f'{v:.2e}' for k, v in worst.items()} } (tolerance "
        f"{TOL_ADAM['rtol']}; parameters also {TOL_ADAM['atol']} x lr)")


def replay_events(trainer):
    """K1-K5's device events and the host's launch calls in one call
    (draws and replay), from ``torch.profiler``, the window held open past
    the call (it drops late events otherwise)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.train_batch(None)
        torch.cuda.synchronize()
        time.sleep(0.1)
    counts = dict.fromkeys(REPLAY_EVENTS, 0)
    host = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for k, pats in REPLAY_EVENTS.items():
                if any(p in e.name for p in pats):
                    counts[k] += 1
        elif e.name in HOST_LAUNCHES:
            host[e.name] = host.get(e.name, 0) + 1
    counts["gblock_b"] = counts.pop("gblock_conv") - counts["gblock_a"]
    return counts, host


def memory_of(fn, pool):
    """Peak device memory of one ``fn`` (GiB): the peak of allocated
    tensors (every live one in the process) and, for a graph, its pool's
    reserved segments, which a replay uses without allocating."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    pool_bytes = 0
    if pool is not None:
        pool_bytes = sum(seg["total_size"]
                         for seg in torch.cuda.memory_snapshot()
                         if tuple(seg["segment_pool_id"]) == tuple(pool))
    return {"peak_gib": round((peak + pool_bytes) / 2**30, 3),
            "transient_gib": round((peak - base + pool_bytes) / 2**30, 3),
            "pool_gib": round(pool_bytes / 2**30, 3)}


def event_idle(fn):
    """The device's idle share of one ``fn()`` (which does not
    synchronize): 1 - the span between CUDA events recorded before and
    after it on the stream over the host-clock time to the synchronize.
    For a graph replay, whose kernels run back to back, the span is the
    busy time that a profile would give."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return 1 - start.elapsed_time(end) / ((time.perf_counter() - t0) * 1e3)


def time_dispatch(label, ways, batch, reps):
    """``ways``: name -> (fn, steps, pool): ``fn`` runs ``steps`` train
    steps of a warm trainer without synchronizing; ``pool`` is a graph's
    (None for eager ways). Each way ``reps`` times in turns (host clock
    around ``fn`` and a synchronize), per step and per image, then once
    more for its peak memory and idle share: an eager way profiled (idle
    from the union of its device events, host launch calls), a graph way
    by CUDA events (``event_idle``), not profiled: in five runs of the
    whole smoke out of five, the profile of the '128' bfloat16 K = 4
    replay here crashed the process in the replay (a segmentation fault),
    though never in phase 11 alone (PyTorch 2.11, CUDA 12.8; the cause is
    not known). Returns {name: record}."""
    def once(fn, steps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps
    times = {name: [] for name in ways}
    for _ in range(reps):
        for name, (fn, steps, _) in ways.items():
            times[name].append(once(fn, steps))
    out = {}
    for name, (fn, steps, pool) in ways.items():
        measured = []
        if pool is None:
            memory = memory_of(lambda: measured.append(profile_call(
                f"dispatch {label} {name}", lambda: once(fn, steps))), pool)
            idle, prof = measured[0]
            launches = {}
            for e in prof.events():
                if e.name in HOST_LAUNCHES:
                    launches[e.name] = launches.get(e.name, 0) + 1
            launches = {k: v / steps for k, v in launches.items()}
        else:
            memory = memory_of(lambda: measured.append(event_idle(fn)), pool)
            idle, launches = measured[0], "not profiled"
        med = statistics.median(times[name])
        out[name] = dict(memory=memory, ms_per_step=round(med, 3),
                         images_per_s=round(1e3 * batch / med, 1),
                         ms=[round(t, 3) for t in times[name]],
                         idle_share=None if idle is None else round(idle, 3),
                         host_launch_calls_per_step=launches)
        log(f"time dispatch {label} {name} B{batch} (host clock, "
            f"synchronized, {reps} in turns): {out[name]}")
    return out


def phase_dispatch(archive, smi):
    """Phase 11: the trainer's data and dispatch paths on the card
    (``--device-data``, ``--steps-per-call K`` replayed from CUDA graphs,
    ``--profile-dir``/``--timing``, ``--activation selu``). Returns the
    timing records."""
    from tartangan_torch.train.multi import GraphedChunk
    t_phase = last = time.perf_counter()

    def lap(part):
        nonlocal last
        now = time.perf_counter()
        log(f"dispatch: {part} took {now - last:.1f} s (host clock)")
        last = now
    DISPATCH_DIR.mkdir(parents=True, exist_ok=True)
    big = DISPATCH_DIR / "tartans512x1024.npy"
    np.save(big, np.resize(np.load(archive), (DISPATCH_IMAGES, 512, 512, 3)))
    results = {"card": smi}
    lap("the 1024-row archive")

    # '128' B 128, --device-data --steps-per-call 4, two calls a dtype
    k4 = {}
    for dtype in ("f32", "bf16"):
        t = dispatch_trainer(big, f"k4_{dtype}", "--dtype", dtype,
                             "--device-data", "--steps-per-call", "4")
        train_dispatch(f"'128' B128 {dtype} K4", t, 2, 4)
        assert len(t._chunk_call.graphs) == 1
        hold_graph(f"'128' B128 {dtype} K4", t)
        if dtype == "f32":
            hold_adam(list(t.state.g.parameters()), t.args.lr_g)
            del t  # only bfloat16 is timed below
        else:
            k4[dtype] = t
        lap(f"'128' {dtype} K4: 2 calls and the hold")
    # lazy R1 every 2 steps at K = 3: two patterns, R1 on steps 0, 2, 4
    t = dispatch_trainer(big, "r1", "--dtype", "bf16", "--device-data",
                         "--steps-per-call", "3", "--r1-interval", "2")
    gp = train_dispatch("'128' B128 bf16 K3 --r1-interval 2", t, 2, 3)
    if (gp > 0).tolist() != [True, False, True, False, True, False]:
        raise AssertionError(f"R1 cadence: gp {gp.tolist()}")
    assert len(t._chunk_call.graphs) == 2
    log(f"dispatch: R1 ran on steps 0, 2, 4 of 0-5 (gp {gp.tolist()}), "
        f"from 2 graphs")
    del t
    # after the capture: a call makes no host sync and no H2D copy
    t = k4["bf16"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        m = t.train_batch(None)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(m["g_loss"]).all()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t.train_batch(None)
        torch.cuda.synchronize()
        time.sleep(0.1)
    h2d = [e.name for e in prof.events()
           if e.device_type == DeviceType.CUDA and "HtoD" in e.name]
    kernels = sum(e.device_type == DeviceType.CUDA for e in prof.events())
    log(f"dispatch: a K4 call under set_sync_debug_mode('error') ran; "
        f"profiled, {kernels} device events, {len(h2d)} host-to-device "
        f"copies")
    if h2d or not kernels:
        raise AssertionError(f"H2D copies {h2d}, device events {kernels}")
    del prof
    lap("R1 cadence, sync and H2D checks")

    # times: the host archive at K = 1, --device-data at K = 1 and K = 4,
    # in bfloat16 (float32, cut for phase 15's time, was timed in PRs 11-14:
    # PERF.md)
    for dtype, reps in (("bf16", 2),):
        t1 = dispatch_trainer(big, f"k1_{dtype}", "--dtype", dtype,
                              "--device-data", "--epochs", "0")
        t1.train()
        t1.train_batch(None)  # warm-up
        rng = np.random.default_rng(0)
        host = [torch.from_numpy(t1.dataset.batch(
            rng.integers(0, DISPATCH_IMAGES, 128), rng)).pin_memory()
            for _ in range(4)]
        t4 = k4.pop(dtype)

        def host_k1(t1=t1, host=host):
            for b in host:
                t1.train_batch(b.to(t1.device, non_blocking=True))

        def device_k1(t1=t1):
            for _ in range(4):
                t1.train_batch(None)
        results[f"128_{dtype}"] = time_dispatch(f"'128' {dtype}", {
            "host archive K1": (host_k1, 4, None),
            "device archive K1": (device_k1, 4, None),
            "device archive K4 graph": (lambda t4=t4: t4.train_batch(None),
                                        4, t4._chunk_call._pool)}, 128, reps)
        del t1, t4, host
        gc.collect()
        torch.cuda.empty_cache()
        lap(f"'128' {dtype} timed three ways")

    # '512thin' parity path at B 64, --device-data --steps-per-call 2
    per_step = {"attention_fwd": K1_PER_STEP, "attention_bwd": K2_PER_STEP,
                "parity_conv": K3_PER_STEP, "gblock_a": K4_PER_STEP,
                "gblock_b": K5_PER_STEP}
    counters = parity_counters()
    for dtype in ("f32", "bf16"):
        t = dispatch_trainer(archive, f"parity_k2_{dtype}", "--dtype", dtype,
                             "--device-data", "--steps-per-call", "2",
                             parity=True)
        per_call = []
        train_batch = t.train_batch

        def counted(batch, train_batch=train_batch, per_call=per_call):
            before = {k: f.launches for k, f in counters.items()}
            metrics = train_batch(batch)
            per_call.append({k: f.launches - before[k]
                             for k, f in counters.items()})
            return metrics
        t.train_batch = counted
        train_dispatch(f"'512thin' parity B64 {dtype} K2", t, 1, 2)
        t.train_batch = train_batch
        counts, host = replay_events(t)
        log(f"dispatch parity {dtype}: wrapper launches in the first call "
            f"(its warm-up and its capture, 2 steps each) {per_call}; in one "
            f"replayed call, device events {counts}, host launch calls "
            f"{host}")
        want = {k: 2 * n for k, n in per_step.items()}
        if counts != want or per_call != [{k: 2 * v
                                           for k, v in want.items()}]:
            raise AssertionError(f"K1-K5 in a replay {counts}, want {want}; "
                                 f"in the first call {per_call}")
        hold_graph(f"'512thin' parity B64 {dtype} K2", t)
        lap(f"'512thin' parity {dtype} K2: a call, its events and the hold")
        if dtype == "f32":
            del t
            gc.collect()
            torch.cuda.empty_cache()

    t1 = dispatch_trainer(archive, "parity_k1_bf16", "--dtype", "bf16",
                          "--device-data", "--epochs", "0", parity=True)
    t1.train()
    t1.train_batch(None)  # warm-up

    def parity_k1(t1=t1):
        for _ in range(2):
            t1.train_batch(None)
    results["512thin_parity_bf16"] = time_dispatch(
        "'512thin' parity bf16", {
            "device archive K1": (parity_k1, 2, None),
            "device archive K2 graph": (lambda: t.train_batch(None), 2,
                                        t._chunk_call._pool)}, 64, 2)
    del t, t1
    gc.collect()
    torch.cuda.empty_cache()
    lap("'512thin' parity bf16 timed two ways")

    # --profile-dir with --timing: a trace of calls 2 and 4 (replays)
    trace_dir = DISPATCH_DIR / "trace"
    shutil.rmtree(trace_dir, ignore_errors=True)
    t = dispatch_trainer(big, "profile", "--dtype", "bf16", "--device-data",
                         "--steps-per-call", "2", "--profile-dir",
                         str(trace_dir), "--profile-start", "2",
                         "--profile-steps", "2", "--timing",
                         "--timing-freq", "2")
    train_dispatch("'128' B128 bf16 K2 --profile-dir --timing", t, 4, 2)
    trace = json.loads((trace_dir / "trace_2.json").read_text())
    cats = {}
    for e in trace["traceEvents"]:
        cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
    rates = [float(r) for r in t.logs["images_per_sec"]]
    log(f"dispatch: --profile-dir trace {trace_dir / 'trace_2.json'}: "
        f"{len(trace['traceEvents'])} events by category {cats}; "
        f"images_per_sec {rates}")
    if not cats.get("kernel") or len(rates) != 3 or min(rates) <= 0:
        raise AssertionError(f"trace categories {cats}, rates {rates}")
    del t, trace
    lap("--profile-dir --timing")

    # --activation selu: '128' trains one step (192 images, one batch)
    t = dispatch_trainer(archive, "selu", "--dtype", "bf16", "--activation",
                         "selu")
    t.train()
    losses = {k: float(t.logs[k][0]) for k in ("g_loss", "d_loss", "gp")}
    log(f"dispatch: '128' B128 bf16 --activation selu, one step: {losses}")
    assert t.steps == 1 and all(np.isfinite(list(losses.values())))
    assert not isinstance(t._chunk_call, GraphedChunk)
    del t
    gc.collect()
    torch.cuda.empty_cache()
    lap("--activation selu")
    log(f"dispatch: phase 11 took {time.perf_counter() - t_phase:.1f} s "
        f"(host clock)")
    return results


# --------------------------------------------------------------- phase 12
P12_DIR = ROOT / "build" / "chip_smoke_p12"
# config '1024''s attention (blocks 512-512-512-256-128-64-32-16, attention
# after block 3: heads Ck 32, Cv 128): G at 64x64 (Lq 4096, Lk 1024), D at
# 32x32 (Lq 1024, Lk 256); B 16, the batch of phase 12's '1024' runs
SHAPES_1024 = (("G", 16, 4096, 1024, 32, 128), ("D", 16, 1024, 256, 32, 128))
# the first step's losses of '1024' with --remat (each policy) against the
# run without: the four runs start from one seeded state, batch and draws
# and compute the same forward; the gradients differ by the order of the
# float32 atomic sums in the backward (cuDNN, the bilinear backward), which
# bfloat16 rounding magnifies, and G's loss reads D's update of the step
TOL_REMAT_LOSS = dict(rtol=1e-2, atol=1e-3)
# the largest batch that '1024' with --remat convs is reckoned to fit:
# the train state plus the batch times the working memory an image of the
# B 16 run took, at most this share of the card's memory
FIT_SHARE = 0.85


def phase_1024_kernels(dev):
    """K1 and K2 at config '1024''s attention shapes (B 16), in float32 and
    bfloat16: each against its plain version with phase 3's tolerances (K2
    fed K1's o and lse, each gradient over its max-abs), K1's lse against
    the plain forward's, the two Functions to second order at the D shape
    (float32), then timed as phase 4 times them: the kernel's device time
    (profiler), the wrapper's call (CUDA events), the plain version, SDPA
    (and its backward) and the bound. Returns {name: {"G float32": record,
    ...}}, the kernels line's ``shape_1024``."""
    import torch.nn.functional as F

    from tartangan_torch.ops.attention import (_bwd, _fwd,
                                               attention_bwd_plain,
                                               attention_lse_plain,
                                               attention_plain)
    gen = torch.Generator(device=dev).manual_seed(12)
    out = {"attention_fwd": {}, "attention_bwd": {}}
    for label, b, lq, lk, ck, cv in SHAPES_1024:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (torch.randn(s, device=dev, generator=gen).to(dtype)
                           for s in ((b, lq, ck), (b, lk, ck), (b, lk, cv),
                                     (b, lq, cv)))
            o, lse = _fwd(q, k, v, with_lse=True)
            ref = attention_plain(q, k, v)
            torch.testing.assert_close(o.float(), ref.float(), **TOL[dtype])
            torch.testing.assert_close(lse, attention_lse_plain(q, k),
                                       **TOL[torch.float32])
            err1 = (o.float() - ref.float()).abs().max().item()
            err2 = 0.0
            for a, r in zip(_bwd(q, k, v, do, o, lse),
                            attention_bwd_plain(q, k, v, do)):
                scale = r.float().abs().max()
                torch.testing.assert_close(a.float() / scale,
                                           r.float() / scale, **TOL[dtype])
                err2 = max(err2, (a.float() - r.float()).abs().max().item())
            del ref
            bf = dtype == torch.bfloat16
            size, peak = (2, PEAK_BF16_FLOPS) if bf else (4, PEAK_F32_FLOPS)
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            sdpa = F.scaled_dot_product_attention(*leaves, scale=1.0)

            def k1():
                return _fwd(q, k, v, with_lse=True)

            def k2():
                return _bwd(q, k, v, do, o, lse)
            shape = f"B{b} Lq{lq} Lk{lk} Ck{ck} Cv{cv}"
            for name, fn, events, plain, lib, bound, err, iters in (
                    ("attention_fwd", k1, K1_EVENTS,
                     lambda: attention_plain(q, k, v),
                     lambda: F.scaled_dot_product_attention(q, k, v,
                                                            scale=1.0),
                     attention_bound_ms(b, lq, lk, ck, cv, size, peak=peak),
                     err1, 20),
                    ("attention_bwd", k2, K2_EVENTS,
                     lambda: attention_bwd_plain(q, k, v, do),
                     lambda: torch.autograd.grad(sdpa, leaves, do,
                                                 retain_graph=True),
                     attention_bound_ms(b, lq, lk, ck, cv, size,
                                        backward=True, peak=peak),
                     err2, 5)):
                rec = {"shape": shape,
                       "ms": statistics.median([device_ms(fn, events)
                                                for _ in range(2)]),
                       "call_ms": cuda_ms(fn, iters=iters),
                       "plain_ms": cuda_ms(plain, iters=iters),
                       "library_ms": cuda_ms(lib, iters=iters),
                       "bound_ms": bound[0], "bound_by": bound[1],
                       "max_abs_err": err}
                out[name][f"{label} {str(dtype)[6:]}"] = rec
                log(f"time {name} '1024' {label} {shape} {str(dtype)[6:]}: "
                    f"held against the plain version (max_abs_err "
                    f"{err:.3e}, tolerance {TOL[dtype]}"
                    f"{' over max-abs' if name == 'attention_bwd' else ''});"
                    f" kernel device {rec['ms']:.4f} ms (profiler), call "
                    f"{rec['call_ms']:.4f} ms, plain {rec['plain_ms']:.4f} "
                    f"ms, sdpa{' backward' if name == 'attention_bwd' else ''}"
                    f" {rec['library_ms']:.4f} ms, bound {bound[0]:.4f} ms "
                    f"({bound[1]}); kernel at "
                    f"{100 * bound[0] / rec['ms']:.1f} % of the bound")
            del q, k, v, do, o, lse, leaves, sdpa
    check_double_backward(dev, SHAPES_1024[1][1:])
    return out


def run_counted(trainer, label, stop=None,
                expect=(K1_PER_STEP, K2_PER_STEP)):
    """``trainer.train()`` with the K1/K2 launch counts set to 0 just
    before and read just after; each step synchronized and timed (host
    clock). With ``stop``, the run is interrupted before step ``stop`` as
    Ctrl-C interrupts it (the trainer's graceful end: samples and the
    final checkpoint). ``expect``: the (K1, K2) launches of every step
    (the text GAN's (0, 0)). Returns (per-step (K1, K2) launches, per-step ms,
    wall s, peak device memory, device memory held after the run: the
    train state)."""
    from tartangan_torch.ops.attention import attention as k1
    from tartangan_torch.ops.attention import attention_bwd as k2
    per_step, times = [], []
    train_batch = trainer.train_batch

    def counted(batch):
        if len(per_step) == stop:
            raise KeyboardInterrupt
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        before = (k1.launches, k2.launches)
        metrics = train_batch(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        per_step.append((k1.launches - before[0], k2.launches - before[1]))
        return metrics
    trainer.train_batch = counted
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    k1.launches = k2.launches = 0
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (k1.launches, k2.launches)
    if (0 in launches and any(expect)) or per_step != [expect] * len(
            per_step):
        raise AssertionError(f"{label}: expected {expect} K1/K2 launches a "
                             f"step, got {per_step} ({launches} in the run)")
    return (per_step, times, wall, torch.cuda.max_memory_allocated(),
            torch.cuda.memory_allocated())


def finite_logs(trainer, keys, steps):
    losses = {k: [float(v) for v in trainer.logs[k]] for k in keys}
    for k, vals in losses.items():
        assert len(vals) == steps and all(np.isfinite(vals)), (k, vals)
    return losses


def run_1024(archive, label, batch_size, *extra, samples=True, steps=2):
    """'1024' at full width, bfloat16, R1 every step, through
    ``create_from_cli`` and ``.train()``, ``steps`` steps (interrupted
    after the last); then one step without R1 on its state, for its peak
    memory.
    ``samples=False`` skips the sample PNGs (after the first step and at
    the end, ~9 s each at 1024² on an H100), which the run without remat
    writes; the sampler's latent draws go with them, so the second step's
    latents, and losses, differ from that run's (only the first step's
    are held)."""
    from tartangan_torch.train.cnn import CNNTrainer, make_cnn_train_step
    from tartangan_torch.train.components.image_sampler import (
        ImageSamplerComponent)
    out = P12_DIR / "out"
    shutil.rmtree(out / label, ignore_errors=True)
    trainer = CNNTrainer.create_from_cli([
        str(archive), "--config", "1024", "--batch-size", str(batch_size),
        "--epochs", "2", "--dtype", "bf16", "--device", "cuda",
        "--run-id", label, "--output", str(out), "--quiet-logs",
        "--gen-freq", "100000", *extra])
    if not samples:
        for component in trainer.components.components:
            if isinstance(component, ImageSamplerComponent):
                component.output_samples = lambda filename: None
    per_step, times, wall, peak, held = run_counted(trainer, label,
                                                    stop=steps)
    assert len(per_step) == steps, per_step
    assert trainer.gan_config.blocks == (512, 512, 512, 256, 128, 64, 32, 16)
    losses = finite_logs(trainer, ("g_loss", "d_loss", "gp"), steps)
    ms = times[-1]
    # a step without R1 (a lazy-R1 run's other steps) on the same trainer:
    # what remat does where no second-order graph is kept
    no_r1 = make_cnn_train_step(grad_penalty=0.0,
                                ema_factor=trainer.args.lr_target_g,
                                dtype=trainer.dtype)
    batch = torch.from_numpy(np.array(
        trainer.dataset.images[:batch_size])).cuda()
    z_d, z_g = trainer.draw_z((1, batch_size)), trainer.draw_z((batch_size,))
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    no_r1(trainer.state, batch, z_d, z_g)
    torch.cuda.synchronize()
    peak_no_r1 = torch.cuda.max_memory_allocated()
    log(f"1024 {label}: B{batch_size} bfloat16, {steps} steps in {wall:.1f} s"
        f" (host clock, {'sampling and ' if samples else ''}the checkpoint "
        f"included); step times "
        f"{[round(t, 3) for t in times]} ms (the last: {ms:.3f} ms, "
        f"{1e3 * batch_size / ms:.1f} images/s); losses {losses}; K1/K2 "
        f"launches a step {per_step}; peak device memory "
        f"{peak / 2**30:.3f} GiB, {held / 2**30:.3f} GiB held after the run "
        f"(the train state); a step without R1: peak "
        f"{peak_no_r1 / 2**30:.3f} GiB")
    del trainer, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "peak": peak, "held": held, "ms": ms,
            "batch": batch_size, "peak_no_r1": peak_no_r1}


def phase_1024():
    """'1024' at full width, B 16, bfloat16, R1 every step, 2 steps each
    without remat and with ``--remat`` under 'full' and 'convs', one step
    under 'dots' (depth cut for phase 15's time); the first step's losses
    held against the run without remat (TOL_REMAT_LOSS). Then the largest
    batch of {32, 48, 64} that 'convs' is reckoned to fit (FIT_SHARE), 2
    steps at it."""
    from tartangan_torch.data.synthetic import make_archive
    P12_DIR.mkdir(parents=True, exist_ok=True)
    archive = P12_DIR / "tartans1024.npy"
    t0 = time.perf_counter()
    images = make_archive(64, 1024, seed=0)
    np.save(archive, images)
    log(f"1024: wrote a {images.shape} uint8 synthetic tartan archive in "
        f"{time.perf_counter() - t0:.1f} s")
    del images
    runs = {}
    for way, flags, steps in (
            ("no remat", (), 2), ("remat full", ("--remat",), 2),
            ("remat convs", ("--remat", "--remat-policy", "convs"), 2),
            ("remat dots", ("--remat", "--remat-policy", "dots"), 1)):
        runs[way] = run_1024(archive, way.replace(" ", "_"), 16, *flags,
                             samples=not flags, steps=steps)
    base = runs["no remat"]["losses"]
    for way, run in runs.items():
        for k in base:
            np.testing.assert_allclose(run["losses"][k][0], base[k][0],
                                       **TOL_REMAT_LOSS, err_msg=f"{way} {k}")
    log("1024: the first step's losses of the three --remat ways within "
        f"{TOL_REMAT_LOSS} of the run without: "
        + "; ".join(f"{w} {[r['losses'][k][0] for k in base]}"
                    for w, r in runs.items()))
    convs = runs["remat convs"]
    total = torch.cuda.get_device_properties(0).total_memory
    per_image = (convs["peak"] - convs["held"]) / 16
    reckon = {b: convs["held"] + b * per_image for b in (32, 48, 64)}
    fits = [b for b, need in reckon.items() if need <= FIT_SHARE * total]
    log(f"1024: --remat convs at B16 took {per_image / 2**30:.3f} GiB an "
        f"image above the {convs['held'] / 2**30:.3f} GiB train state; "
        f"reckoned peaks " + ", ".join(f"B{b} {v / 2**30:.2f} GiB"
                                       for b, v in reckon.items())
        + f" against {FIT_SHARE} x {total / 2**30:.2f} GiB: "
        + (f"B{max(fits)} is the largest that fits" if fits else
           "none fits; no larger batch is run"))
    if fits:
        b = max(fits)
        big = run_1024(archive, f"remat_convs_b{b}", b, "--remat",
                       "--remat-policy", "convs", samples=False)
        runs[f"remat convs B{b}"] = big
        log(f"1024: --remat convs at B{b}: peak {big['peak'] / 2**30:.3f} "
            f"GiB against the reckoned {reckon[b] / 2**30:.3f} GiB")
    return runs


def phase_remat_parity(archive, dev):
    """--remat with K3 inside: '512thin' with --parity-blocks on, FUSED_G
    and the fused G blocks (phase 7's path), float32, B 64. One step
    without remat, again (the witness of the backward's run-to-run
    spread), with --remat convs and with --remat full, each from the same
    fresh state, batch and latents with D's rate 0 (``_step_grads``): the
    losses, gp and gradients held as phase 7 holds them (``_hold``:
    TOL_PARITY_STEP_GRAD or PARITY_WITNESS_FACTOR x the witness), the
    running statistics equal bit for bit, K3's launches as many under
    convs as without remat (16 a step) and more under full. Then --remat
    convs --steps-per-call 2 in bfloat16 with --device-data: 1 call
    trained, and its graph held against eager (``hold_graph``)."""
    from tartangan_torch.ops import parity as P
    P.FUSED_G = True
    argv = [str(archive), "--config", "512thin", "--parity-blocks", "on",
            "--batch-size", "64", "--epochs", "1", "--dtype", "f32",
            "--device", "cuda", "--run-id", "p12_parity", "--output",
            str(P12_DIR / "out"), "--quiet-logs"]
    batch = torch.from_numpy(np.array(np.load(archive, mmap_mode="r")[:64])).to(
        dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    z_d = torch.randn((1, 64, 256), generator=gen, device=dev)
    z_g = torch.randn((64, 256), generator=gen, device=dev)
    counters = parity_counters()
    results = {}
    for way, flags in (("no remat", ()), ("no remat again", ()),
                       ("remat convs", ("--remat", "--remat-policy",
                                        "convs")),
                       ("remat full", ("--remat", "--remat-policy",
                                       "full"))):
        trainer = parity_trainer(argv + list(flags))
        trainer.build_models()
        for c in counters.values():
            c.launches = 0
        step = _step_grads(trainer, batch, z_d, z_g)
        torch.cuda.synchronize()
        launches = {n: c.launches for n, c in counters.items()}
        stats = [t.clone() for m in (trainer.state.g, trainer.state.d)
                 for t in m.buffers()]
        results[way] = (step, stats, launches)
        log(f"remat parity {way}: K1-K5 launches in the step {launches}")
        del trainer
        gc.collect()
    base, base_stats, base_launches = results["no remat"]
    witness, _ = _hold("remat parity: no remat, twice", results[
        "no remat again"][0], base)
    failed = []
    for way in ("remat convs", "remat full"):
        step, stats, launches = results[way]
        _, bad = _hold(f"remat parity: {way} vs no remat", step, base,
                       witness=witness)
        failed += bad
        same = all(torch.equal(a, b) for a, b in zip(stats, base_stats))
        log(f"remat parity {way}: running statistics "
            f"{'equal' if same else 'NOT equal'} bit for bit to the step "
            f"without remat")
        if not same:
            failed.append(f"{way}: running statistics")
    k3 = {w: r[2]["parity_conv"] for w, r in results.items()}
    if not (k3["remat convs"] == k3["no remat"] == 16
            and k3["remat full"] > k3["no remat"]):
        failed.append(f"K3 launches a step {k3}: convs must make as many as "
                      "no remat (16), full more")
    if any(v == 0 for r in results.values() for v in r[2].values()):
        failed.append("a kernel of the path was not launched")
    if failed:
        raise AssertionError(f"remat parity: {failed}")
    log(f"remat parity: K3 launches a step {k3}")

    trainer = dispatch_trainer(archive, "p12_graph", "--dtype", "bf16",
                               "--device-data", "--steps-per-call", "2",
                               "--remat", "--remat-policy", "convs",
                               parity=True)
    train_dispatch("'512thin' parity bf16 --remat convs K = 2", trainer, 1,
                   2)
    hold_graph("'512thin' parity bf16 --remat convs K = 2", trainer)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()


def phase_iqn_info(archive, dev):
    """The IQN and InfoGAN trainers: '512thin' at full width, B 64,
    bfloat16, 3 steps each through ``create_from_cli`` and ``.train()``:
    finite losses (and code losses), K1/K2 launches a step, a final
    checkpoint in the JAX trainers' layout; the serve app loads the IQN
    run and generates on the card. One float32 step with the kernels held
    against one with the plain attention from the same state and draws
    (``hold_step``, phase 6's tolerances); the bfloat16 step timed
    (``time_steps``). Then one IQN call of 2 steps with --device-data
    --steps-per-call 2, its graph held against eager (``hold_graph``)."""
    from tartangan_torch import serve
    from tartangan_torch.train.info import InfoTrainer
    from tartangan_torch.train.iqn import IQNTrainer
    from tartangan_torch.utils import msgpack
    out = P12_DIR / "out"
    batch = torch.from_numpy(np.array(np.load(archive, mmap_mode="r")[:64])).to(
        dev)
    for name, cls, keys, head in (
            ("iqn", IQNTrainer, ("g_loss", "d_loss", "gp"),
             ("IQN_0", "to_output")),
            ("info", InfoTrainer, ("g_loss", "g_code_loss", "d_loss",
                                   "d_code_loss", "gp"),
             ("LinearOutput_0", "LinearOutput_1"))):
        shutil.rmtree(out / name, ignore_errors=True)
        argv = [str(archive), "--config", "512thin", "--batch-size", "64",
                "--epochs", "1", "--device", "cuda", "--output", str(out),
                "--quiet-logs"]
        trainer = cls.create_from_cli(argv + ["--dtype", "bf16", "--run-id",
                                              name])
        per_step, times, wall, peak, _ = run_counted(trainer, name)
        losses = finite_logs(trainer, keys, 3)
        ckpt = out / name / "checkpoints" / "3"
        for part in ("g", "g_target", "d", "opt_g", "opt_d"):
            assert (ckpt / f"{part}.msgpack").is_file(), part
        d_tree = msgpack.loads((ckpt / "d.msgpack").read_bytes())
        opt_d = msgpack.loads((ckpt / "opt_d.msgpack").read_bytes())
        assert int(opt_d["0"]["count"]) == 3
        assert all(h in d_tree["params"]["output_block"] for h in head)
        log(f"{name}: '512thin' B64 bfloat16, 3 steps in {wall:.1f} s (host "
            f"clock, sampling and the checkpoint included); losses {losses};"
            f" K1/K2 launches a step {per_step}; step times "
            f"{[round(t, 3) for t in times]} ms; peak device memory "
            f"{peak / 2**30:.3f} GiB; checkpoint {ckpt} in the JAX layout "
            f"(output_block {sorted(d_tree['params']['output_block'])})")
        if name == "iqn":
            app = serve._ServeApp(serve._ServeApp.parse_cli_args(
                [str(out / name)]))
            app.load_generator()
            z = np.random.default_rng(8).standard_normal((2, 256)).astype(
                np.float32)
            imgs = app.generate(z)
            assert imgs.shape == (2, 512, 512, 3) and np.isfinite(imgs).all()
            log(f"iqn: the port's serve app loaded {ckpt} and generated "
                f"{imgs.shape} on the card")
            del app
        trainer.build_models()
        trainer.z_gen.manual_seed(7)
        z_d, z_g = trainer.draw_z((1, 64)), trainer.draw_z((64,))
        extra = trainer.extra_draws((), 64)
        time_steps(f"'512thin' {name}", {"bfloat16": trainer}, batch, z_d,
                   z_g, extra=extra)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        hold = cls.create_from_cli(argv + ["--dtype", "f32", "--run-id",
                                           f"{name}_hold"])
        hold_step(hold, dev, batch)
        del hold
        gc.collect()
        torch.cuda.empty_cache()
    shutil.rmtree(out / "iqn_graph", ignore_errors=True)
    trainer = IQNTrainer.create_from_cli([
        str(archive), "--config", "512thin", "--batch-size", "64",
        "--epochs", "1", "--device", "cuda", "--output", str(out),
        "--quiet-logs", "--dtype", "bf16", "--run-id", "iqn_graph",
        "--gen-freq", "100000", "--device-data", "--steps-per-call", "2"])
    train_dispatch("'512thin' iqn bf16 K = 2", trainer, 1, 2)
    draws = trainer.chunk_draws(True)
    assert draws["taus_d"].shape == (2, 1, 2, 8 * 64, 1)
    hold_graph("'512thin' iqn bf16 K = 2", trainer)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()


# --------------------------------------------------------------- phase 13
P13_DIR = ROOT / "build" / "chip_smoke_p13"
# the scene generator's attention at '512thin' with --scene-size 16: it
# follows the fourth block of config.blocks[2:], at 256x256 with 16
# channels (Ck 2, Cv 8; keys and values 2x2 max-pooled); B 64
SHAPE_SCENE = (64, 65536, 16384, 2, 8)
# the text GAN's corpus: seeded documents of 100-160 words over a Zipf
# vocabulary; 512 documents make 4 batches of 128
TEXT_DOCS, TEXT_VOCAB = 512, 2000


def attention_f64(q, k, v, do):
    """The attention's output and (dq, dk, dv) in float64, from the same
    inputs: ``attention_plain`` and ``attention_bwd_plain``'s formulas
    without their float32 casts."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    p = torch.softmax(torch.bmm(q, k.transpose(1, 2)), -1)
    o = torch.bmm(p, v)
    dv = torch.bmm(p.transpose(1, 2), do)
    ds = torch.bmm(do, v.transpose(1, 2))
    ds -= (ds * p).sum(-1, keepdim=True)
    ds *= p
    del p
    return o, (torch.bmm(ds, k), torch.bmm(ds.transpose(1, 2), q), dv)


def scene_kernel_hold(q, k, v, do, label):
    """K1 (with lse) and K2 (fed K1's o and lse) against their plain
    versions with phase 3's tolerances, each output over its max-abs (a
    sum over Lq or Lk terms), K1's lse against the plain forward's; K2
    launched twice for the same bits. Both also against the same math in
    float64 (logged: which of kernel and plain version lies nearer).
    Returns (K1's max abs error, K2's largest max abs error) against the
    plain versions."""
    from tartangan_torch.ops.attention import (_bwd, _fwd,
                                               attention_bwd_plain,
                                               attention_lse_plain,
                                               attention_plain)
    dtype = q.dtype
    o, lse = _fwd(q, k, v, with_lse=True)
    outs = _bwd(q, k, v, do, o, lse)
    again = _bwd(q, k, v, do, o, lse)
    same = all(torch.equal(a, b) for a, b in zip(outs, again))
    del again
    lse_err = (lse - attention_lse_plain(q, k)).abs().max().item()
    torch.testing.assert_close(lse, attention_lse_plain(q, k),
                               **TOL[torch.float32])
    plain = (attention_plain(q, k, v), *attention_bwd_plain(q, k, v, do))
    o64, grads64 = attention_f64(q, k, v, do)
    errs, worst = {}, {}
    for name, a, r, w in zip(("o", "dq", "dk", "dv"), (o, *outs), plain,
                             (o64, *grads64)):
        scale = w.abs().max()
        errs[name] = tuple(((x.double() - y.double()).abs().max()
                            / scale).item()
                           for x, y in ((a, r), (a, w), (r, w)))
        worst[name] = (a.double() - r.double()).abs().max().item()
    del o64, grads64
    log(f"kernel scene {label} {str(dtype)[6:]}: error over the float64 "
        f"max-abs, (kernel vs plain, kernel vs float64, plain vs float64): "
        + ", ".join(f"{n} ({a:.2e}, {b:.2e}, {c:.2e})"
                    for n, (a, b, c) in errs.items())
        + f"; lse vs plain {lse_err:.3e}; two K2 launches "
        f"{'equal' if same else 'NOT equal'} bit for bit")
    if not same:
        raise AssertionError(f"scene {label}: two K2 launches differ")
    for name, a, r in zip(("o", "dq", "dk", "dv"), (o, *outs), plain):
        scale = r.float().abs().max()
        torch.testing.assert_close(a.float() / scale, r.float() / scale,
                                   **TOL[dtype], msg=lambda m: f"{name}: {m}")
    return worst["o"], max(worst["dq"], worst["dk"], worst["dv"])


def phase_scene_kernels(dev):
    """K1 and K2 at the scene generator's attention (SHAPE_SCENE), in
    float32 and bfloat16. Held against their plain versions
    (``scene_kernel_hold``) at B 1 (its own launch configuration: the
    plain logits take 4 GiB an image) and on the last image of a B 64
    launch (the training grid), then timed at B 64: the kernel's device
    time (profiler), the wrapper's call (CUDA events), the bound; the plain
    version and SDPA (math) at B 1, where they fit; SDPA at B 64 with its
    fused backends only, null where none takes the shape. Returns {name:
    {"G float32": record, ...}}, the kernels line's ``shape_scene``."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from tartangan_torch.ops.attention import (_bwd, _fwd,
                                               attention_bwd_plain,
                                               attention_plain)
    b, lq, lk, ck, cv = SHAPE_SCENE
    shape = f"B{b} Lq{lq} Lk{lk} Ck{ck} Cv{cv}"
    gen = torch.Generator(device=dev).manual_seed(13)
    out = {"attention_fwd": {}, "attention_bwd": {}}
    fused = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.CUDNN_ATTENTION]

    def timed(fn, iters):
        try:
            return cuda_ms(fn, iters=iters, reps=2)
        except (RuntimeError, torch.cuda.OutOfMemoryError) as e:
            log(f"  not timed: {str(e).splitlines()[0][:160]}")
            return None
        finally:
            gc.collect()
            torch.cuda.empty_cache()

    for dtype in (torch.float32, torch.bfloat16):
        name_dt = str(dtype)[6:]
        q, k, v, do = (torch.randn(s, device=dev, generator=gen).to(dtype)
                       for s in ((b, lq, ck), (b, lk, ck), (b, lk, cv),
                                 (b, lq, cv)))
        one = [t[-1:].contiguous() for t in (q, k, v, do)]
        err1, err2 = scene_kernel_hold(*one, "B1")
        # the B 64 launch's last image against the plain version
        o, lse = _fwd(q, k, v, with_lse=True)
        dq, dk, dv = _bwd(q, k, v, do, o, lse)
        errs = []
        for name, a, r in zip(("o", "dq", "dk", "dv"), (o, dq, dk, dv),
                              (attention_plain(*one[:3]),
                               *attention_bwd_plain(*one))):
            scale = r.float().abs().max()
            errs.append(f"{name} {((a[-1:].float() - r.float()).abs().max() / scale).item():.2e}")
            torch.testing.assert_close(a[-1:].float() / scale,
                                       r.float() / scale, **TOL[dtype])
        log(f"kernel scene {shape} {name_dt}: the last image of the B{b} "
            f"launch within {TOL[dtype]} of the plain version, over its "
            f"max-abs: {', '.join(errs)}")
        del dq, dk, dv
        gc.collect()
        torch.cuda.empty_cache()
        bf = dtype == torch.bfloat16
        size, peak = (2, PEAK_BF16_FLOPS) if bf else (4, PEAK_F32_FLOPS)
        plain_fwd = timed(lambda: attention_plain(*one[:3]), 3)
        plain_bwd = timed(lambda: attention_bwd_plain(*one), 2)
        lib_b1 = timed(lambda: F.scaled_dot_product_attention(
            *one[:3], scale=1.0), 3)
        # one head: SDPA's fused backends take (B, heads, L, E)
        leaves = [t.detach()[:, None].requires_grad_() for t in (q, k, v)]

        def sdpa_fwd():
            with sdpa_kernel(fused):
                return F.scaled_dot_product_attention(*leaves, scale=1.0)

        def sdpa_bwd():
            return torch.autograd.grad(sdpa_fwd(), leaves, do[:, None])
        lib_fwd, lib_bwd = timed(sdpa_fwd, 3), timed(sdpa_bwd, 2)

        def k1():
            return _fwd(q, k, v, with_lse=True)

        def k2():
            return _bwd(q, k, v, do, o, lse)
        for name, fn, events, plain, lib, bound, err, iters in (
                ("attention_fwd", k1, K1_EVENTS, plain_fwd, lib_fwd,
                 attention_bound_ms(b, lq, lk, ck, cv, size, peak=peak),
                 err1, 5),
                ("attention_bwd", k2, K2_EVENTS, plain_bwd, lib_bwd,
                 attention_bound_ms(b, lq, lk, ck, cv, size, backward=True,
                                    peak=peak), err2, 3)):
            rec = {"shape": shape,
                   "ms": device_ms(fn, events, iters=iters),
                   "call_ms": cuda_ms(fn, iters=iters - 1, reps=2),
                   "plain_ms": None, "plain_b1_ms": plain,
                   "library_ms": lib,
                   "library_b1_ms": lib_b1 if name == "attention_fwd"
                   else None,
                   "bound_ms": bound[0], "bound_by": bound[1],
                   "max_abs_err": err}
            out[name][f"G {name_dt}"] = rec
            log(f"time {name} scene G {shape} {name_dt}: kernel device "
                f"{rec['ms']:.3f} ms (profiler), call {rec['call_ms']:.3f} "
                f"ms, bound {bound[0]:.3f} ms ({bound[1]}), kernel at "
                f"{100 * bound[0] / rec['ms']:.1f} % of the bound; plain at "
                f"B1 {plain}, sdpa at B{b} (fused backends) {lib}, sdpa at "
                f"B1 {rec['library_b1_ms']} ms (the plain version cannot "
                f"run at B{b}: its logits take {b * lq * lk * 4 / 2**30:.0f}"
                f" GiB)")
        del q, k, v, do, o, lse, leaves, one
        gc.collect()
        torch.cuda.empty_cache()
    return out


def tree_shapes(tree, prefix=""):
    """{path: shape} of a msgpack tree's leaves."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(tree_shapes(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = tuple(np.shape(value))
    return out


def p13_trainer(cls, archive, run_id, *extra, batch_size=64, dtype="bf16"):
    out = P13_DIR / "out"
    shutil.rmtree(out / run_id, ignore_errors=True)
    return cls.create_from_cli([
        str(archive), "--config", "512thin", "--batch-size", str(batch_size),
        "--epochs", "1", "--dtype", dtype, "--device", "cuda", "--run-id",
        run_id, "--output", str(out), "--quiet-logs", "--gen-freq",
        "100000", *extra])


def phase_new_trainers(archive, dev):
    """The shared-filter CNN and IQN trainers and the scene trainer with
    --patch-noise: '512thin', B 64, bfloat16, R1 every step, through
    ``create_from_cli`` and ``.train()``, 2 steps each (interrupted after
    the second): finite losses, K1/K2 launches a step (the counts set to 0
    before each run), step times, peak memory, the final checkpoint's JAX
    layout (the bank ``shared_filters`` HWIO, the scene's
    ``structure_generator``), a profile of a scene step. Then a float32
    scene step at B 2 with the kernels against one with the plain
    attention (``hold_step``, phase 6's tolerances), and one scene call of
    2 steps with --device-data --steps-per-call 2 replayed and held against
    eager (``hold_graph``). Returns {name: (per-step ms, peak bytes)}."""
    from tartangan_torch.train.scene import SceneTrainer
    from tartangan_torch.train.shared.cnn import SharedCNNTrainer
    from tartangan_torch.train.shared.iqn import SharedIQNTrainer
    from tartangan_torch.utils import msgpack
    results = {}
    for name, cls, keys, extra in (
            ("shared_cnn", SharedCNNTrainer, ("g_loss", "d_loss", "gp"), ()),
            ("shared_iqn", SharedIQNTrainer, ("g_loss", "d_loss", "gp"), ()),
            ("scene", SceneTrainer, ("g_loss", "d_loss", "gp"),
             ("--patch-noise",))):
        trainer = p13_trainer(cls, archive, name, *extra)
        per_step, times, wall, peak, held = run_counted(trainer, name, stop=2)
        losses = finite_logs(trainer, keys, 2)
        ckpt = P13_DIR / "out" / name / "checkpoints" / "2"
        g_tree = tree_shapes(msgpack.loads((ckpt / "g.msgpack").read_bytes()))
        d_tree = tree_shapes(msgpack.loads((ckpt / "d.msgpack").read_bytes()))
        opt_d = msgpack.loads((ckpt / "opt_d.msgpack").read_bytes())
        assert int(opt_d["0"]["count"]) == 2
        if name.startswith("shared"):
            # latent 256, widest block 128: HWIO (3, 3, 256, 128)
            assert g_tree["params/shared_filters"] == (3, 3, 256, 128)
            assert d_tree["params/shared_filters"] == (3, 3, 256, 128)
            assert "params/SharedResidualGeneratorBlock_6/SharedConvBlock_1/"\
                "bias" in g_tree
            head = ("IQNDiscriminatorOutput_0" if name == "shared_iqn"
                    else "DiscriminatorOutput_0")
            assert any(k.startswith(f"params/{head}/") for k in d_tree)
        else:
            assert g_tree["params/structure_generator/patch_transforms/"
                          "kernel"] == (256, 120)
            assert "params/SelfAttention2d_0/gamma" in g_tree
            assert "params/ResidualGeneratorBlock_4/Conv_1/kernel" in g_tree
        log(f"{name}: '512thin' B64 bfloat16, 2 steps in {wall:.1f} s (host "
            f"clock, sampling and the checkpoint included); losses "
            f"{losses}; K1/K2 launches a step {per_step}; step times "
            f"{[round(t, 3) for t in times]} ms (the second: "
            f"{64e3 / times[-1]:.1f} images/s); peak device memory "
            f"{peak / 2**30:.3f} GiB ({held / 2**30:.3f} GiB held after the "
            f"run); checkpoint {ckpt} in the JAX layout ({len(g_tree)} G "
            f"and {len(d_tree)} D leaves)")
        results[name] = (times, peak)
        if name == "scene":
            batch = torch.from_numpy(np.array(
                trainer.dataset.images[:64])).to(dev)
            trainer.z_gen.manual_seed(7)
            z_d, z_g = trainer.draw_z((1, 64)), trainer.draw_z((64,))
            extra_draws = trainer.extra_draws((), 64)
            assert extra_draws["noise_g"].shape == (3, 3)

            def step():
                trainer._train_step(trainer.state, batch, z_d, z_g,
                                    **extra_draws)
                torch.cuda.synchronize()
            step()
            profile_call("train step scene bf16 B64", step)
            del batch
        del trainer
        gc.collect()
        torch.cuda.empty_cache()

    hold = p13_trainer(SceneTrainer, archive, "scene_hold", "--patch-noise",
                       batch_size=2, dtype="f32")
    batch = torch.from_numpy(np.array(np.load(archive, mmap_mode="r")[:2])).to(
        dev)
    hold_step(hold, dev, batch)
    del hold, batch
    gc.collect()
    torch.cuda.empty_cache()

    trainer = p13_trainer(SceneTrainer, archive, "scene_graph",
                          "--patch-noise", "--device-data",
                          "--steps-per-call", "2")
    train_dispatch("'512thin' scene bf16 K = 2", trainer, 1, 2)
    draws = trainer.chunk_draws(True)
    assert draws["noise_d"].shape == (2, 1, 3, 3), draws["noise_d"].shape
    hold_graph("'512thin' scene bf16 K = 2", trainer)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return results


def write_corpus(path):
    """TEXT_DOCS seeded documents of 100-160 words, one a line, over a
    vocabulary of TEXT_VOCAB words drawn with Zipf frequencies."""
    rng = np.random.default_rng(13)
    words = np.array([f"w{i}" for i in range(TEXT_VOCAB)])
    p = 1.0 / np.arange(1, TEXT_VOCAB + 1)
    p /= p.sum()
    with open(path, "w") as f:
        for _ in range(TEXT_DOCS):
            n = int(rng.integers(100, 161))
            f.write(" ".join(words[rng.choice(TEXT_VOCAB, n, p=p)]) + " .\n")


def phase_text():
    """The text GAN at config '128' (blocks 128-128-64-32-16 in 1-D: G from
    4 to 128 tokens), --embedding-dims 64, B 128, on the seeded corpus:
    4 steps through ``create_from_cli`` and ``.train()``, the first 2
    pretraining the embedding (G and D losses 0), the last 2 the full
    step; finite losses, a sample file, the checkpoint's ``embedding`` and
    ``opt_emb`` in the JAX layout, step times."""
    from tartangan_torch.train.text_cnn import TextCNNTrainer
    from tartangan_torch.utils import msgpack
    P13_DIR.mkdir(parents=True, exist_ok=True)
    corpus = P13_DIR / "corpus.txt"
    write_corpus(corpus)
    out = P13_DIR / "out"
    shutil.rmtree(out / "text", ignore_errors=True)
    trainer = TextCNNTrainer.create_from_cli([
        str(corpus), "--config", "128", "--batch-size", "128", "--epochs",
        "1", "--embedding-dims", "64", "--pretrain-embedding", "2",
        "--device", "cuda", "--run-id", "text", "--output", str(out),
        "--quiet-logs", "--gen-freq", "100000"])
    per_step, times, wall, peak, _ = run_counted(trainer, "text",
                                                 expect=(0, 0))
    losses = finite_logs(trainer, ("g_loss", "d_loss", "gp",
                                   "embedding_loss"), 4)
    g = losses["g_loss"]
    assert g[:2] == [0.0, 0.0] and all(x != 0 for x in g[2:]), g
    sample = out / "text" / "samples" / "sample_4.txt"
    text = sample.read_text()
    assert text.count("-" * 40) == 16, text[:200]
    ckpt = out / "text" / "checkpoints" / "4"
    emb = tree_shapes(msgpack.loads((ckpt / "embedding.msgpack").read_bytes()))
    vocab = len(trainer.dataset.vocab)
    assert emb == {"embedding_u": (vocab, 64), "embedding_v": (vocab, 64)}
    assert msgpack.loads((ckpt / "opt_emb.msgpack").read_bytes()) == {
        "0": {}, "1": {}}
    log(f"text: '128' in 1-D, B128 float32, embedding 64 over {vocab} "
        f"tokens, 4 steps (2 pretraining the embedding) in {wall:.1f} s; "
        f"losses {losses}; step times {[round(t, 3) for t in times]} ms; "
        f"peak device memory {peak / 2**30:.3f} GiB; {sample} (first line: "
        f"{text.splitlines()[0][:70]!r}); checkpoint {ckpt} with embedding "
        f"and opt_emb")
    return times, peak


# --------------------------------------------------------------- phase 14
APPS_DIR = ROOT / "build" / "chip_smoke_apps"
# find_image's objective with the kernels against the plain attention: the
# loss relative and the gradient w.r.t. z over its max-abs (phase 6's
# TOL_STEP_LOSS and TOL_STEP_GRAD)


def attention_layers(model, gamma=None):
    from tartangan_torch.models.attention import SelfAttention2d
    layers = [m for m in model.modules() if isinstance(m, SelfAttention2d)]
    if gamma is not None:
        with torch.no_grad():
            for m in layers:
                m.gamma.fill_(gamma)
    return layers


@contextlib.contextmanager
def plain_attention(model):
    layers = attention_layers(model)
    for m in layers:
        m.use_kernel = False
    try:
        yield
    finally:
        for m in layers:
            m.use_kernel = True


def timed(fn):
    """(fn's result, host seconds with the device drained)."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_apps(dev):
    """Phase 14: the post-training apps and the export at '512thin' full
    width (see the module docstring). Returns K1's and K2's launches in the
    find_image run."""
    from tartangan_torch.explore.continuous_interp import ContinuousInterp
    from tartangan_torch.explore.find_image import FindImage
    from tartangan_torch.explore.info_encode import InfoGANEncodeImage
    from tartangan_torch.explore.render_tour import RenderTour
    from tartangan_torch.export import onnx_eval
    from tartangan_torch.export.web import WebExportApp
    from tartangan_torch.ops.attention import attention, attention_bwd
    t_phase = time.perf_counter()
    shutil.rmtree(APPS_DIR, ignore_errors=True)
    APPS_DIR.mkdir(parents=True)
    runs = [TRAIN_DIR / "out" / b for b in ("b64", "b32")
            if (TRAIN_DIR / "out" / b / "checkpoints").is_dir()]
    run, info_run = str(runs[0]), str(P12_DIR / "out" / "info")
    rng = np.random.default_rng(14)

    # render_tour and continuous_interp, default flags
    attention.launches = 0
    prefix = APPS_DIR / "tour" / "frame"
    app = RenderTour(RenderTour.parse_cli_args([run, str(prefix)]))
    _, secs = timed(app.run)
    frames = sorted(prefix.parent.glob("frame_*.png"))
    assert len(frames) == 6, frames  # 2 points x 3 frames
    assert png_size(frames[0].read_bytes()) == (516, 516)
    assert attention.launches == 1, attention.launches
    log(f"apps: render_tour wrote {len(frames)} PNGs in {secs:.2f} s (host "
        f"clock, load included), K1 launches {attention.launches}")
    attention.launches = 0
    prefix = APPS_DIR / "interp" / "img"
    app = ContinuousInterp(ContinuousInterp.parse_cli_args(
        [run, str(prefix), "--output-size", "256"]))
    _, secs = timed(app.run)
    out = Path(f"{prefix}_combined.png")
    assert png_size(out.read_bytes()) == (260, 260)
    assert attention.launches == 6, attention.launches  # a grid row a call
    log(f"apps: continuous_interp wrote {out.name} in {secs:.2f} s, K1 "
        f"launches {attention.launches} (one a grid row)")
    del app

    # find_image, Adam, B 2, 20 steps
    fi = FindImage(FindImage.parse_cli_args(
        [run, str(APPS_DIR / "find" / "adam"), "unused.png",
         "--max-steps", "20"]))
    fi.load_generator()
    attention_layers(fi.g, gamma=0.5)
    target = fi.generate(rng.standard_normal((1, 256)).astype(np.float32))[0]
    z0 = rng.standard_normal((2, 256)).astype(np.float32)
    per_step = []
    step = fi.step

    def counted(*a):
        before = (attention.launches, attention_bwd.launches)
        out = step(*a)
        per_step.append((attention.launches - before[0],
                         attention_bwd.launches - before[1]))
        return out
    fi.step = counted
    attention.launches = attention_bwd.launches = 0
    _, secs = timed(lambda: fi.find(target, z=z0))
    launches_find = {"attention_fwd": attention.launches,
                     "attention_bwd": attention_bwd.launches}
    adam_losses = list(fi.loss_history)
    log(f"apps: find_image adam B2 20 steps in {secs:.2f} s (host clock, 2 "
        f"PNGs included); loss {adam_losses[0]:.2f} -> {adam_losses[-1]:.2f};"
        f" K1/K2 launches {launches_find}")
    assert np.all(np.isfinite(adam_losses))
    assert adam_losses[-1] < adam_losses[0], adam_losses
    assert per_step == [(1, 1)] * 20, per_step
    fi.step = step
    zt = torch.as_tensor(z0, device=dev)
    loss_k, grad_k, _ = fi.value_and_grad(zt)
    with plain_attention(fi.g):
        loss_p, grad_p, _ = fi.value_and_grad(zt)
    loss_err = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    grad_err = float((grad_k - grad_p).abs().max() / grad_p.abs().max())
    log(f"apps: find_image objective at z0, kernels vs plain attention: "
        f"loss rel err {loss_err:.3e} (tolerance "
        f"{TOL_STEP_LOSS['rtol']}), grad w.r.t. z err over max-abs "
        f"{grad_err:.3e} (tolerance {TOL_STEP_GRAD['atol']})")
    assert loss_err <= TOL_STEP_LOSS["rtol"], loss_err
    assert grad_err <= TOL_STEP_GRAD["atol"], grad_err
    state = fi.opt.init(zt)
    ms_adam = host_ms(lambda: timed(lambda: fi.step(zt, state)), reps=5)
    with plain_attention(fi.g):
        ms_plain = host_ms(lambda: timed(lambda: fi.step(zt, state)), reps=5)
    log(f"time find_image adam step B2 (host clock, device drained): "
        f"{ms_adam:.3f} ms with the kernels, {ms_plain:.3f} ms with the "
        f"plain attention")

    # L-BFGS, 5 steps: K1 and K2 once for the step and once a trial
    fi.args.optimizer, fi.args.max_steps = "lbfgs", 5
    fi.args.output_prefix = str(APPS_DIR / "find" / "lbfgs")
    attention.launches = attention_bwd.launches = 0
    _, secs = timed(lambda: fi.find(target, z=z0))
    trials = fi.linesearch_steps
    log(f"apps: find_image lbfgs B2 5 steps in {secs:.2f} s "
        f"({secs / 5 * 1e3:.1f} ms a step, host clock); line-search trials "
        f"a step {trials}; loss {fi.loss_history[0]:.2f} -> "
        f"{fi.loss_history[-1]:.2f}; K1/K2 launches {attention.launches}/"
        f"{attention_bwd.launches}")
    assert np.all(np.isfinite(fi.loss_history))
    assert fi.loss_history[-1] < fi.loss_history[0], fi.loss_history
    assert attention.launches == attention_bwd.launches == 5 + sum(trials)

    # --vgg, 3 steps (Adam): Inception forward and backward at 299
    fi.args.optimizer, fi.args.max_steps, fi.args.vgg = "adam", 3, True
    fi.args.output_prefix = str(APPS_DIR / "find" / "vgg")
    _, secs = timed(lambda: fi.find(target, z=z0))
    log(f"apps: find_image --vgg B2 3 steps in {secs:.2f} s (host clock, "
        f"Inception's init and the target's features included); losses "
        f"{fi.loss_history}")
    assert np.all(np.isfinite(fi.loss_history))
    ms_vgg = host_ms(lambda: timed(lambda: fi.step(zt, fi.opt.init(zt))),
                     reps=3)
    log(f"time find_image --vgg adam step B2 (host clock): {ms_vgg:.3f} ms")
    del fi, target
    gc.collect()
    torch.cuda.empty_cache()

    # info_encode: one B 32 batch through the InfoGAN D
    ie = InfoGANEncodeImage(InfoGANEncodeImage.parse_cli_args(
        [info_run, str(APPS_DIR / "info" / "codes"), "unused", "--recon"]))
    ie.load_generator(target=False)
    ie.load_discriminator(info=True)
    d_attn = attention_layers(ie.d, gamma=0.5)
    shapes = []
    hook = d_attn[0].register_forward_pre_hook(
        lambda m, a: shapes.append(tuple(a[0].shape)))
    imgs = rng.uniform(-1, 1, (32, 512, 512, 3)).astype(np.float32)
    attention.launches = 0
    (_, codes), secs = timed(lambda: ie.discriminate(imgs))
    launches_d = attention.launches
    with plain_attention(ie.d):
        _, codes_plain = ie.discriminate(imgs)
    hook.remove()
    err = float(np.abs(codes - codes_plain).max())
    log(f"apps: info_encode D B32 in {secs * 1e3:.1f} ms (host clock), K1 "
        f"launches {launches_d} at D's attention input {shapes[0]} "
        f"(Lq {shapes[0][2] * shapes[0][3]}); codes {codes.shape} vs the "
        f"plain attention's: max_abs_err {err:.3e}")
    assert launches_d == 1 and shapes[0][2:] == (32, 32), shapes
    np.testing.assert_allclose(codes, codes_plain, rtol=1e-4, atol=1e-4)
    codes2, secs = timed(lambda: ie.encode_batch(imgs, 0))
    recon = APPS_DIR / "info" / "codes_0.png"
    assert codes2.shape == (32, 15) and png_size(recon.read_bytes()) == (
        8 * 512 + 18, 4 * 512 + 10)
    log(f"apps: info_encode --recon B32 (D, G(codes), PNG) in {secs:.2f} s")
    del ie, imgs
    gc.collect()
    torch.cuda.empty_cache()

    # export.web --onnx at B 1
    base = APPS_DIR / "web" / "ttgan"
    we = WebExportApp(WebExportApp.parse_cli_args(
        [run, "--output", str(base), "--onnx"]))
    _, secs = timed(we.run)
    sizes = {ext: Path(f"{base}.{ext}").stat().st_size
             for ext in ("pt2", "json", "onnx")}
    log(f"apps: export.web --onnx B1 in {secs:.2f} s (host clock: load, "
        f"torch.export, save, reload and run, ONNX emit and one numpy "
        f"interpreter run); sizes {sizes} bytes")
    t0 = time.perf_counter()
    program = torch.export.load(f"{base}.pt2").module()
    secs_load = time.perf_counter() - t0
    z = rng.standard_normal((1, 256)).astype(np.float32)
    attention.launches = 0
    with torch.inference_mode():
        out, secs_run = timed(lambda: program(torch.as_tensor(z, device=dev)))
    launches_pt2 = attention.launches
    out = out.permute(0, 2, 1, 3).cpu().numpy()  # NWHC -> NHWC
    err = float(np.abs(out - we.generate(z)).max())
    log(f"apps: .pt2 loaded in {secs_load:.2f} s, run B1 in "
        f"{secs_run * 1e3:.1f} ms (first call); K1 launches {launches_pt2}; "
        f"vs generate max_abs_err {err:.3e}")
    assert launches_pt2 == 1, launches_pt2
    assert err <= 1e-5, err
    model_bytes = Path(f"{base}.onnx").read_bytes()
    t0 = time.perf_counter()
    onnx_out = onnx_eval.evaluate(model_bytes, {"z": z})["image"]
    secs_onnx = time.perf_counter() - t0
    with torch.inference_mode():
        ref = we.g(torch.as_tensor(z, device=dev), train=False).cpu().numpy()
    err = float(np.abs(onnx_out - ref).max())
    log(f"apps: ONNX through the numpy interpreter B1 in {secs_onnx:.2f} s "
        f"(host); vs G eval mode on the card max_abs_err {err:.3e}")
    assert err <= 1e-3, err
    del we, program
    gc.collect()
    torch.cuda.empty_cache()
    log(f"apps: phase 14 took {time.perf_counter() - t_phase:.1f} s")
    return launches_find




# ---------------------------------------------------------------- phase 15
MESH_DIR = ROOT / "build" / "chip_smoke_mesh"
MESH_BATCH = 8
# the JAX package's mesh tolerances (tests/test_distributed_equivalence.py):
# metrics, G's parameters after Adam's first step (+-lr x sign(g), and a
# gradient near 0 may take the other sign in another summation order), D's
# running statistics. Those bound Adam's step, not the gradient, so the
# gradients themselves (Adam's first moments: beta1 is 0) are held too, as
# max |diff| over the tower's largest |gradient| (``grad_err``). Float32
# readings on an H100 (dp 2, tp 2, NCCL world 1): D's, taken before any
# update, 6.4e-5 to 1.25e-4 (R1's second-order term on top of another
# batch split or another BatchNorm reduction: NCCL world 1 reads 1.2e-4);
# G's 6.3e-3 to 8.1e-3, as they also follow D's first update, whose +-lr
# steps on near-0 gradients may go either way (1.9e-3 without it). A
# gradient summed over the wrong group or scaled by the ranks reads O(1)
TOL_MESH = {"loss": 1e-3, "g": 5e-4, "d_stats": 1e-3, "d_grad": 1e-3,
            "g_grad": 5e-2}


def mesh_argv(archive, run_id, *extra):
    return [str(archive), "--config", "512thin", "--batch-size",
            str(MESH_BATCH), "--epochs", "1", "--dtype", "f32", "--device",
            "cuda", "--run-id", run_id, "--output", str(MESH_DIR / "out"),
            "--gen-freq", "1000", "--checkpoint-freq", "1000",
            "--quiet-logs", "--seed", "5", *extra]


def mesh_rank_run(argv, entry=True, reps=1):
    """One step of the CNN trainer on this rank (or the one process), with
    K1/K2 counted where the step launches them and its time (``first_ms``),
    then ``reps`` more steps timed (``step_ms``); host clock around a device
    sync, every rank at once.
    ``entry``: through ``create_from_cli`` and ``.train()`` (samples and a
    checkpoint at the end); else the trainer's build, its components'
    train begin (the image sampler's draws) and its step on the first
    global batch, without the end's sampling (whose gathers dominate a
    ``--tp`` run on gloo). Rank 0 returns the metrics, G's parameters, D's
    statistics and both towers' gradients (gathered from the model group's
    slices), every rank's K1/K2 launches in the step, and the times."""
    import torch.distributed as dist

    from tartangan_torch.data.prefetch import EpochBatcher
    from tartangan_torch.ops.attention import attention, attention_bwd
    from tartangan_torch.parallel import collectives as C
    from tartangan_torch.parallel import mesh as M
    from tartangan_torch.train.cnn import CNNTrainer
    from tartangan_torch.utils.scalars import last_scalar
    trainer = CNNTrainer.create_from_cli(argv)
    counts = []
    train_batch = trainer.train_batch

    first = []

    def counted(batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        before = (attention.launches, attention_bwd.launches)
        metrics = train_batch(batch)
        counts.append((attention.launches - before[0],
                       attention_bwd.launches - before[1]))
        torch.cuda.synchronize()
        first.append((time.perf_counter() - t0) * 1e3)
        return metrics
    if entry:
        trainer.train_batch = counted
        trainer.train()
        assert trainer.steps == 1, trainer.steps
        logs = {k: last_scalar(v[-1]) for k, v in trainer.logs.items()}
    else:
        trainer.build_models()
        trainer._setup_mesh_state()
        trainer.dataset = trainer.prepare_dataset()
        trainer.components.invoke("train_begin", 0, {})
        host = next(EpochBatcher(trainer.dataset, MESH_BATCH,
                                 seed=trainer.args.seed).epoch())
        metrics = C.sum_metrics(counted(torch.from_numpy(
            trainer.shard(host)).to(trainer.device)))
        logs = {k: float(v) for k, v in metrics.items()}
    art = trainer.checkpoint_artifacts()
    mesh = M.current()
    batch = trainer.shard(torch.from_numpy(
        trainer.dataset.images[:MESH_BATCH]).to(trainer.device))
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_batch(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    per_rank = [counts]
    if mesh is not None:
        per_rank = [None] * mesh.world
        dist.all_gather_object(per_rank, counts)
    if not M.is_writer():
        return None
    return {"logs": logs, "g": art["g"]["params"],
            "d_stats": art["d"]["batch_stats"],
            "g_grad": art["opt_g"]["0"]["mu"],
            "d_grad": art["opt_d"]["0"]["mu"], "launches": per_rank,
            "first_ms": first[0], "step_ms": times,
            "backend": None if mesh is None else mesh.backend}


def mesh_pair(argv_dp, argv_tp):
    """A rank of the two that share the card: dp 2 through the entry
    points, then the same two processes re-grouped as tp 2."""
    from tartangan_torch.parallel import mesh as M
    dp = mesh_rank_run(argv_dp)
    gc.collect()
    torch.cuda.empty_cache()
    M.make_mesh(2, tp=2, device_type="cuda", share_device=True)
    tp = mesh_rank_run(argv_tp, entry=False, reps=0)
    return (dp, tp) if M.is_writer() else None


def _tree_max_err(a, b, prefix=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), prefix
        return max((_tree_max_err(a[k], b[k], f"{prefix}/{k}") for k in a),
                   default=0.0)
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def _tree_max_abs(tree):
    if isinstance(tree, dict):
        return max((_tree_max_abs(v) for v in tree.values()), default=0.0)
    return float(np.abs(np.asarray(tree, np.float64)).max())


def grad_err(run, ref):
    """max |run - ref| over ``ref``'s largest |gradient| (a conv bias that
    a BatchNorm follows has a gradient of rounding noise: its own scale is
    no measure)."""
    return _tree_max_err(run, ref) / _tree_max_abs(ref)


def hold_mesh(label, run, ref):
    """``run`` against the one-process ``ref`` at TOL_MESH; every rank
    launched K1 and K2 as the one-process step does."""
    loss = max(abs(run["logs"][k] - ref["logs"][k])
               for k in ("g_loss", "d_loss", "gp"))
    errs = {"g": _tree_max_err(run["g"], ref["g"]),
            "d_stats": _tree_max_err(run["d_stats"], ref["d_stats"]),
            "d_grad": grad_err(run["d_grad"], ref["d_grad"]),
            "g_grad": grad_err(run["g_grad"], ref["g_grad"])}
    log(f"mesh: {label} ({run['backend']}) against one process: losses "
        f"{run['logs']} vs {ref['logs']}; max |loss err| {loss:.3e} (tol "
        f"{TOL_MESH['loss']}), G params {errs['g']:.3e} (tol "
        f"{TOL_MESH['g']}), D stats {errs['d_stats']:.3e} (tol "
        f"{TOL_MESH['d_stats']}), D grads {errs['d_grad']:.3e} and G grads "
        f"{errs['g_grad']:.3e} of the largest (tol {TOL_MESH['d_grad']}, "
        f"{TOL_MESH['g_grad']}; largest {_tree_max_abs(ref['d_grad']):.4e}, "
        f"{_tree_max_abs(ref['g_grad']):.4e}); K1/K2 launches per "
        f"rank in the step {run['launches']}; the step {run['first_ms']:.1f} "
        f"ms, then {run['step_ms']} ms (host clock, every rank at once)")
    if not (loss < TOL_MESH["loss"]
            and all(errs[k] < TOL_MESH[k] for k in errs)):
        raise AssertionError(f"mesh: {label} does not hold against one "
                             "process")
    for counts in run["launches"]:
        if counts != ref["launches"][0]:
            raise AssertionError(f"mesh: {label}: a rank launched K1/K2 "
                                 f"{counts}, one process "
                                 f"{ref['launches'][0]}")


def mesh_resume(archive, run_id):
    """A one-process trainer resumes ``run_id``'s checkpoint (written by a
    mesh; its checkpoint component's train begin) and holds exactly what
    it wrote."""
    from tartangan_torch.train.cnn import CNNTrainer
    from tartangan_torch.utils import msgpack
    ckpt = MESH_DIR / "out" / run_id / "checkpoints" / "1"
    names = ("g", "g_target", "d", "opt_g", "opt_d")
    saved = {name: msgpack.loads((ckpt / f"{name}.msgpack").read_bytes())
             for name in names}
    t = CNNTrainer.create_from_cli(mesh_argv(
        archive, run_id, "--resume-training-latest"))
    t.build_models()
    t.components.invoke("train_begin", 0, {})
    assert t.steps == 1, t.steps
    mine = t.checkpoint_artifacts()
    for name in names:
        err = _tree_max_err(mine[name], saved[name])
        if err != 0:
            raise AssertionError(f"mesh: resumed {name} is {err} off")
    log(f"mesh: a one-process trainer resumed {ckpt} bit for bit")


def phase_calibrate(data128):
    """``eval.calibrate``'s CLI on synthetic 128px tartans at B 16, every
    level, then --validate --validate-n 256, on the card."""
    from tartangan_torch.eval import calibrate
    npz = MESH_DIR / "tartans128.npz"
    np.savez(npz, images=np.load(data128))
    out = MESH_DIR / "calibrated.npz"
    t0 = time.perf_counter()
    model = calibrate.calibrate_variables(np.load(npz)["images"],
                                          batch_size=16, device="cuda")
    calibrate.save_stats_npz(model, out)
    t_cal = time.perf_counter() - t0
    t0 = time.perf_counter()
    checks = calibrate.main([str(npz), str(out), "--batch-size", "16",
                             "--validate", "--validate-n", "256",
                             "--device", "cuda"])
    t_cli = time.perf_counter() - t0
    log(f"calibrate: every level at B 16 in {t_cal:.1f} s (host clock); the "
        f"CLI with --validate --validate-n 256 in {t_cli:.1f} s: {checks}")
    fids = [checks[k] for k in ("fid_holdout", "fid_blurred", "fid_noise")]
    assert all(np.isfinite(fids)), checks
    if not checks["ordered"]:
        raise AssertionError(f"calibrate: the FIDs are not ordered {checks}")


def phase_native_crop(archive):
    """The native batcher against numpy on the 512px archive: byte-equal,
    and the host time of one B 64 batch of 512x512 crops (and of 384x384
    crops at random offsets)."""
    from tartangan_torch import native
    images = np.load(archive)
    rng = np.random.default_rng(3)
    idx = rng.integers(0, len(images), 64)
    for size in (512, 384):
        hi = images.shape[1] - size + 1
        ys = rng.integers(0, hi, 64).astype(np.int32)
        xs = rng.integers(0, hi, 64).astype(np.int32)
        ours = native.crop_batch(images, idx, ys, xs, size)
        plain = native.crop_batch_plain(images, idx, ys, xs, size)
        if not np.array_equal(ours, plain):
            raise AssertionError(f"native crop {size} differs from numpy")
        t_native = host_ms(lambda: native.crop_batch(images, idx, ys, xs,
                                                     size))
        t_plain = host_ms(lambda: native.crop_batch_plain(images, idx, ys,
                                                          xs, size))
        log(f"native crop: B 64 of {size}x{size} from the {images.shape} "
            f"archive byte-equal to numpy; host {t_native:.3f} ms vs "
            f"numpy {t_plain:.3f} ms ({os.cpu_count()} cores)")


def phase_mesh(data128):
    """Phase 15: the device mesh on the card, the calibration and the
    native crop. Returns the K1/K2 launches per rank of each mesh step."""
    from tartangan_torch.parallel import mesh as M
    t15 = time.perf_counter()
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    MESH_DIR.mkdir(parents=True)
    archive = MESH_DIR / "tartans512x8.npy"
    np.save(archive, np.load(TRAIN_DIR / "tartans512.npy")[:MESH_BATCH])

    # (d) the CLI in a process of its own: 2 steps on one card
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "tartangan_torch.train.cnn",
                    *mesh_argv(archive, "cli", "--num-devices", "1",
                               "--epochs", "2")],
                   check=True, cwd=ROOT, stdout=subprocess.DEVNULL)
    assert (MESH_DIR / "out" / "cli" / "checkpoints" / "2"
            / "g.msgpack").is_file()
    log(f"mesh: the trainer's CLI with --num-devices 1 took 2 steps in "
        f"{time.perf_counter() - t0:.1f} s (a process of its own)")

    lap = time.perf_counter()
    # the references and the NCCL run take the step without the entry
    # points' end (samples, checkpoint); the draws are the same
    ref = mesh_rank_run(mesh_argv(archive, "one"), entry=False)
    log(f"mesh: the one-process reference took "
        f"{time.perf_counter() - lap:.1f} s")
    # (a) data parallelism through the launcher, 2 gloo ranks sharing the
    # card; (b) the same ranks as tensor parallelism
    lap = time.perf_counter()
    dp2, tp2 = M.launch(
        mesh_pair, 2, (mesh_argv(archive, "dp2", "--num-devices", "2"),
                       mesh_argv(archive, "tp2", "--num-devices", "2",
                                 "--tp", "2")),
        device_type="cuda", share_device=True)
    log(f"mesh: the two ranks (start, dp 2, tp 2) took "
        f"{time.perf_counter() - lap:.1f} s")
    hold_mesh("dp 2", dp2, ref)
    # the tp run's draws and batch are the entry points' (the components'
    # train begin draws first)
    hold_mesh("tp 2", tp2, ref)
    mesh_resume(archive, "dp2")
    # (c) the mesh path on an NCCL group of one, in this process
    M.make_mesh(1, device_type="cuda",
                init_method=f"file://{MESH_DIR / 'nccl_rdzv'}", rank=0)
    try:
        nccl = mesh_rank_run(mesh_argv(archive, "nccl1", "--num-devices",
                                       "1"), entry=False)
    finally:
        M.teardown()
    assert nccl["backend"] == "nccl", nccl["backend"]
    hold_mesh("NCCL world 1", nccl, ref)
    log(f"mesh: step times (ms, host clock; the counted step, then one "
        f"more): one process {ref['first_ms']:.1f}, {ref['step_ms']}; NCCL "
        f"world 1 {nccl['first_ms']:.1f}, {nccl['step_ms']}; dp 2 sharing "
        f"the card {dp2['first_ms']:.1f}, {dp2['step_ms']}; tp 2 sharing the "
        f"card {tp2['first_ms']:.1f}")
    t_mesh = time.perf_counter() - t15

    phase_calibrate(data128)
    phase_native_crop(TRAIN_DIR / "tartans512.npy")
    log(f"phase 15 took {time.perf_counter() - t15:.1f} s ({t_mesh:.1f} s "
        "of it the mesh)")
    names = ("attention_fwd", "attention_bwd")
    return {name: {label: [c[0][i] for c in run["launches"]]
                   for label, run in (("dp2", dp2), ("tp2", tp2),
                                      ("nccl1", nccl))}
            for i, name in enumerate(names)}

def main():
    ab = sys.argv[1:]
    if ab and not ((ab[0] == "--k1-ab" and len(ab) >= 2)
                   or (ab[0] == "--gblock-ab" and len(ab) >= 2)):
        print("usage: chip_smoke.py [--k1-ab OTHER_attention_fwd.cu ... | "
              "--gblock-ab OTHER_DIR ...]", file=sys.stderr)
        return 2
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
    faulthandler.enable()  # a crash in native code prints the Python stack
    t_start = time.perf_counter()

    def done(phase):
        log(f"time: {phase} done {time.perf_counter() - t_start:.1f} s "
            "after the start")
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
            for kernel, used, spill in ptxas_usage(text):
                log(f"  ptxas {name} {kernel}: {used}; {spill}")

        if ab and ab[0] == "--gblock-ab":
            rate = mma_tf32_rate()
            print(json.dumps({"gblock_ab": gblock_ab(ab[1:]),
                              "mma_tf32_tflops": rate}))
            print(nvidia_smi_line())
            return 0
        if ab:
            print(json.dumps({"k1_ab": k1_ab(ab[1:])}))
            print(nvidia_smi_line())
            return 0
        errs = phase_kernels(dev)
        perrs = phase_parity_kernels(dev)
        perrs16 = phase_parity_kernels_bf16(dev)
        phase_no_sync(dev)
        # the kernels' device times before the train steps' long profiles,
        # after which the profiler was seen to drop kernel events
        records = time_attention(dev, errs) + time_parity_kernels(dev, perrs)
        bf16 = time_bf16_kernels(dev, perrs16)
        shape_1024 = phase_1024_kernels(dev)
        shape_scene = phase_scene_kernels(dev)
        done("phases 1-4, 12's and 13's kernels")
        gc.collect()
        torch.cuda.empty_cache()
        app, serve_launches = phase_serve()
        check_generator(app)
        phase_times(app)
        del app
        done("phase 5")
        trainer, launches, _ = phase_train(dev)
        log(f"serve path launches {serve_launches}; train path launches "
            f"{launches} (the kernels line counts the train path)")
        batch, z_d, z_g, _ = hold_step(trainer, dev)
        time_train(trainer, batch, z_d, z_g)
        del trainer, batch
        done("phase 6")
        gc.collect()
        torch.cuda.empty_cache()

        archive = TRAIN_DIR / "tartans512.npy"
        par, par_launches, _ = phase_parity_train(archive)
        log(f"parity path launches {par_launches} (the kernels line counts "
            f"K3-K5 on this path)")
        par16, par16_launches, _ = phase_parity_train(archive, "bf16")
        log(f"bfloat16 parity path launches {par16_launches} (the kernels "
            f"line's bf16 records count K1-K5 on this path)")
        batch = torch.from_numpy(par.dataset.images[:64]).to(dev)
        gen = torch.Generator(device=dev).manual_seed(7)
        z_d = torch.randn((1, 64, 256), generator=gen, device=dev)
        z_g = torch.randn((64, 256), generator=gen, device=dev)
        plain = hold_parity(par, dev, batch, z_d, z_g, par16)
        time_parity_step(par, plain, batch, z_d, z_g)
        par16.build_models()
        par.build_models()
        time_steps("'512thin' parity path", {"float32": par,
                                             "bfloat16": par16},
                   batch, z_d, z_g)
        del par, par16, plain, batch
        done("phases 7-8")
        gc.collect()
        torch.cuda.empty_cache()
        phase_128(archive)
        done("phase 9")
        gc.collect()
        torch.cuda.empty_cache()
        phase_eval(dev, archive, smi)
        done("phase 10")
        gc.collect()
        torch.cuda.empty_cache()
        phase_dispatch(archive, smi)
        done("phase 11")
        gc.collect()
        torch.cuda.empty_cache()
        t12 = time.perf_counter()
        phase_1024()
        phase_remat_parity(archive, dev)
        phase_iqn_info(archive, dev)
        log(f"phase 12 took {time.perf_counter() - t12:.1f} s after its "
            f"kernels")
        done("phase 12")
        t13 = time.perf_counter()
        phase_new_trainers(archive, dev)
        phase_text()
        log(f"phase 13 took {time.perf_counter() - t13:.1f} s after its "
            f"kernels")
        done("phase 13")
        gc.collect()
        torch.cuda.empty_cache()
        launches_find = phase_apps(dev)
        done("phase 14")
        gc.collect()
        torch.cuda.empty_cache()
        launches_mesh = phase_mesh(EVAL_DIR / "tartans128.npy")
        done("phase 15")
        k3_k5 = ("parity_conv", "gblock_a", "gblock_b")
        for rec in records:
            name = rec["name"]
            rec["launches"] = par_launches[name] if name in k3_k5 \
                else launches[name]
            rec["dtypes"] = ["float32", "bfloat16"]
            rec["bf16"] = {"launches": par16_launches[name], **bf16[name]}
            if name in shape_1024:
                rec["shape_1024"] = shape_1024[name]
                rec["shape_scene"] = shape_scene[name]
            if name in launches_find:
                rec["launches_find"] = launches_find[name]
            if name in launches_mesh:
                rec["launches_mesh"] = launches_mesh[name]
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
