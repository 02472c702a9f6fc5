"""Profiling and throughput component (``--profile-dir``, ``--timing``).

Counterpart of ``tartangan_tpu/train/components/profiler.py:17-58``:
``--profile-dir DIR`` traces steps [``--profile-start``,
``--profile-start + --profile-steps``) with ``torch.profiler`` (host
activities, and the device's on CUDA) and writes a Chrome/Perfetto trace
(``DIR/trace_{start}.json``); every ``--timing-freq`` steps the wall-clock
images/sec since the last report is appended to the logs as
``images_per_sec``, after a ``torch.cuda.synchronize()`` on CUDA, so the
clock covers the work it counts.

Under ``--steps-per-call K`` the trace starts in the call whose window
[steps, steps + K) contains ``--profile-start``, as ``every`` fires; the
JAX component starts only when the call's first step equals it, so it
never starts there when ``profile_start % K != 0``. At K = 1 the two rules
agree.
"""
from __future__ import annotations

import os
import time

import torch

from ...utils.fs import maybe_makedirs
from .base import TrainerComponent


class ProfilerComponent(TrainerComponent):
    def on_train_begin(self, steps, logs):
        self._prof = None
        self._t0 = time.perf_counter()
        self._steps0 = steps

    def on_batch_begin(self, steps, logs):
        args = self.trainer.args
        k = getattr(self.trainer, "steps_per_call", 1)
        if (args.profile_dir and self._prof is None
                and steps <= args.profile_start < steps + k):
            print(f"[profiler] starting trace -> {args.profile_dir}")
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.trainer.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()

    def on_batch_end(self, steps, logs):
        args = self.trainer.args
        if (self._prof is not None
                and steps >= args.profile_start + args.profile_steps):
            self._stop()

        if args.timing_freq and steps and self.every(args.timing_freq, steps):
            self._sync()
            now = time.perf_counter()
            imgs = (steps - self._steps0) * args.batch_size
            logs["images_per_sec"].append(imgs / max(now - self._t0, 1e-9))
            self._t0, self._steps0 = now, steps

    def on_train_end(self, steps, logs):
        if self._prof is not None:
            self._stop()

    def _sync(self):
        if self.trainer.device.type == "cuda":
            torch.cuda.synchronize(self.trainer.device)

    def _stop(self):
        self._sync()
        self._prof.stop()
        profile_dir = self.trainer.args.profile_dir
        maybe_makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir,
                            f"trace_{self.trainer.args.profile_start}.json")
        self._prof.export_chrome_trace(path)
        self._prof = None
        print(f"[profiler] trace captured -> {path}")

    @classmethod
    def add_args_to_parser(cls, parser):
        parser.add_argument("--profile-start", type=int, default=10,
                            help="Step at which to start the device trace")
        parser.add_argument("--profile-steps", type=int, default=5,
                            help="Number of steps to trace")
        parser.add_argument("--timing-freq", type=int, default=100,
                            help="Log images/sec every N steps (0=off)")
