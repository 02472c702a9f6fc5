"""The system under test: a tartangan_torch trainer, the one that the
cell's model module names, driven through its own loop (``Trainer.train``:
the batcher, the pinned one-ahead copy to the device, ``train_batch``).

``bench_trainer`` makes the model's trainer class into one with a record
of what the set-up's steps were fed: their batches and every draw each
step took, by the name the model module gives it (``DRAWS``: the latents
of ``draw_z`` and whatever ``extra_draws`` returns). ``Window`` is a
trainer component: it loads the benchmark's weights before the first
step, keeps what the check needs from the first steps, opens the measured
window after the warm-up steps and, once ``seconds`` have passed, closes
it; traced, it then profiles ``trace_steps`` more steps. It ends the loop
by raising ``WindowClosed`` out of it.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from tartangan_torch.train.components.base import TrainerComponent

from . import check


class WindowClosed(Exception):
    pass


def parse_args(trainer_cls, argv: list):
    parser = argparse.ArgumentParser()
    trainer_cls.add_args_to_parser(parser)
    args = parser.parse_args(argv)
    args._argv = list(argv)
    return args


def bench_trainer(trainer_cls):
    """``trainer_cls`` with ``fed``: what its first steps were fed."""

    class BenchTrainer(trainer_cls):
        def __init__(self, args, components, record_steps: int):
            super().__init__(args, components)
            self.record_steps = record_steps
            self.fed = []  # (batch, {draw: tensor}) of the first steps, host

        def train_batch(self, batch):
            with torch.profiler.record_function("portbench.step"):
                return super().train_batch(batch)

    return BenchTrainer


def _named(draws: dict, args: tuple, kw: dict) -> dict:
    """A step's draws by name: ``args`` in the order of ``draws``, then
    ``kw``."""
    return {**dict(zip(draws, args)), **kw}


def record(trainer, draws: dict):
    """Wrap the trainer's step to keep, for its first ``record_steps``
    steps, the batch and each draw it is given (``draws``: the model's
    ``DRAWS``) in ``trainer.fed``."""
    def recorded(fn):
        def step(state, batch, *args, **kw):
            if trainer.steps < trainer.record_steps:
                named = _named(draws, args, kw)
                trainer.fed.append((batch.cpu().numpy(),
                                    {k: v.cpu() for k, v in named.items()}))
            return fn(state, batch, *args, **kw)
        return step

    trainer._train_step = recorded(trainer._train_step)
    if trainer._train_step_alt is not None:
        trainer._train_step_alt = recorded(trainer._train_step_alt)


class Window(TrainerComponent):
    """Loads the weights, keeps the check's records, times the window and,
    traced, profiles the steps after it. ``draws`` is the model's
    ``DRAWS``. ``fault`` plants a fault in the program's step, beneath
    the record of what it was fed, for the tests and the study of
    ``check.py``'s limits: ``unchanged`` (the step returns the state as it
    was), ``half_batch`` (the step sees half the batch and half of every
    draw that has a batch axis), ``negated_g`` (G's optimizer gets the
    negated gradient)."""

    def __init__(self, weights, draws, *, check_steps, warm_steps,
                 r1_interval, seconds, trace_steps=None, fault=None):
        super().__init__(None)
        if not 1 <= check_steps <= warm_steps:
            raise ValueError("the check's steps are warm-up steps")
        self.weights, self.draws = weights, draws
        self.check_steps, self.warm_steps = check_steps, warm_steps
        self.r1_interval = r1_interval
        self.seconds, self.trace_steps = seconds, trace_steps
        self.fault = fault
        self.prof = None
        self.records = {}
        self.step_r1, self.trace_r1 = [], []  # R1 or not, by step
        self.marks = {}  # set-up's moments (host clock) for the log

    def on_train_begin(self, steps, logs):
        self.marks["built"] = time.perf_counter()
        t = self.trainer
        s = t.state
        with torch.no_grad():
            # the EMA target starts as G's copy: its parameters, not its
            # statistics, which it never uses in training
            for model, key, leaves in ((s.g, "g", None), (s.d, "d", None),
                                       (s.g_target, "g", "params")):
                own = model.state_dict()
                if set(own) != set(self.weights[key]):
                    raise KeyError(f"the program's {key} has the leaves "
                                   f"{sorted(set(own) ^ set(self.weights[key]))}"
                                   " that the reference does not, or lacks them")
                names = dict(model.named_parameters()) if leaves else own
                for name in names:
                    own[name].copy_(self.weights[key][name])
        plant(t, self.fault, self.draws)
        record(t, self.draws)

    def _sync(self):
        if self.trainer.device.type == "cuda":
            torch.cuda.synchronize()

    def on_batch_end(self, steps, logs):
        t = self.trainer
        if steps < self.warm_steps:
            self.marks[f"step {steps + 1}"] = time.perf_counter()
        if steps == 0:
            self.records["grads"] = {
                "g": check.first_grads(t.state.g, t.state.opt_g),
                "d": check.first_grads(t.state.d, t.state.opt_d)}
            self.records["after_1"] = check.state_of(t.state.g, t.state.d,
                                                     t.state.g_target)
        if steps == self.check_steps - 1:
            self.records["after"] = check.state_of(t.state.g, t.state.d,
                                                   t.state.g_target)
            self.records["losses"] = [
                {k: float(logs[k][i]) for k in ("d_loss", "g_loss", "gp")}
                for i in range(self.check_steps)]
        if self.prof is not None:
            self.trace_r1.append(steps % self.r1_interval == 0)
            if len(self.trace_r1) >= self.trace_steps:
                self._sync()
                self.trace_t1_ns = time.time_ns()
                self.prof.stop()
                raise WindowClosed
        elif steps >= self.warm_steps:
            self.step_r1.append(steps % self.r1_interval == 0)
            if time.perf_counter() - self.t0 >= self.seconds:
                self._sync()
                self.t1 = time.perf_counter()
                self.steps = len(self.step_r1)
                if self.trace_steps is None:
                    raise WindowClosed
                from torch.profiler import ProfilerActivity, profile
                acts = [ProfilerActivity.CPU]
                if t.device.type == "cuda":
                    acts.append(ProfilerActivity.CUDA)
                self.prof = profile(activities=acts)
                self.prof.start()
                self.trace_t0_ns = time.time_ns()
        if steps == self.warm_steps - 1:
            self._sync()
            if t.device.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            self.t0 = time.perf_counter()


def plant(trainer, fault, draws: dict):
    """Break the program's step underneath the loop (see ``Window``);
    ``draws`` is the model's ``DRAWS``."""
    if fault is None:
        return
    if fault == "negated_g":
        opt = trainer.state.opt_g
        step = opt.step

        def negated(*args, **kw):
            for group in opt.param_groups:
                for p in group["params"]:
                    if p.grad is not None:
                        p.grad.neg_()
            return step(*args, **kw)
        opt.step = negated
        return
    if fault not in ("unchanged", "half_batch"):
        raise ValueError(f"unknown fault {fault!r}")

    def broken(fn):
        def step(state, batch, *args, **kw):
            if fault == "unchanged":
                zero = torch.zeros((), device=batch.device)
                return {"g_loss": zero, "d_loss": zero, "gp": zero}
            h = batch.shape[0] // 2

            def half(name, v):
                axis = draws[name]
                return v if axis is None else v.narrow(axis, 0, h)
            args = [half(k, v) for k, v in zip(draws, args)]
            kw = {k: half(k, v) for k, v in kw.items()}
            return fn(state, batch[:h], *args, **kw)
        return step

    trainer._train_step = broken(trainer._train_step)
    if trainer._train_step_alt is not None:
        trainer._train_step_alt = broken(trainer._train_step_alt)


def run(model, cfg, traffic, weights, data_path, out_dir, seed, device, *,
        seconds, trace, fault=None):
    """Train model module ``model``'s trainer from ``weights`` through the
    warm-up, the window and, with ``trace``, the traced steps. Returns
    (trainer, window component)."""
    trainer_cls = bench_trainer(model.trainer_class())
    args = parse_args(trainer_cls, model.trainer_argv(
        cfg, traffic, data_path, out_dir, seed, device))
    window = Window(weights, model.DRAWS, check_steps=traffic["check_steps"],
                    warm_steps=traffic["warm_steps"],
                    r1_interval=traffic["r1_interval"], seconds=seconds,
                    trace_steps=traffic["trace_steps"] if trace else None,
                    fault=fault)
    trainer = trainer_cls(args, [window], traffic["check_steps"])
    try:
        trainer.train()
    except WindowClosed:
        pass
    else:
        raise RuntimeError("the trainer's loop ended before the window "
                           "closed")
    return trainer, window


def rows_of(batches: list, archive: np.ndarray) -> list:
    """Each fed batch's rows as indices into ``archive`` (None for a row
    that is not in it)."""
    index = {archive[i].tobytes(): i for i in range(len(archive))}
    return [[index.get(row.tobytes()) for row in batch] for batch in batches]
