"""Step chunking (``--steps-per-call K``): K train steps per call.

Counterpart of ``tartangan_tpu/train/multi.py``, where one jitted
``lax.scan`` of K steps is one device dispatch. On CUDA its counterpart is
one replay of a captured CUDA graph of the K steps (``GraphedChunk``):
the host then launches one graph a call instead of thousands of kernels
(the bfloat16 '128' step at B 128 is host-bound on an H100). On the CPU
the same K-step function runs eagerly; that eager loop is its plain
version.

Two input modes, as there:

- ``broadcast``: every inner step gets the same ``inputs`` (the
  ``--device-data`` archive on the device) and gathers its own batch from
  it with its own draws (``data/device.py``);
- ``scan``: ``inputs`` has a leading (K, ...) axis and inner step i takes
  slice i: host batches stacked K at a time (``stack_batches``), one
  host-to-device copy a call.

Random draws are arguments: each keyword of ``draws`` is a (K, ...)
tensor whose slice i goes to inner step i (the latents ``z_d``, ``z_g``
and, under ``--device-data``, ``idx``, ``ys``, ``xs``). The trainer makes
them before the call, outside any graph, so no generator is captured.

Metrics come back stacked as (K,) tensors on the device; logs consumers
take the last element (``utils/scalars.last_scalar``).
"""
from __future__ import annotations

import dataclasses
import gc

import numpy as np
import torch
from torch import nn


def chunk_train_step(step_fn, steps_per_call: int, batch_mode: str,
                     alt_step_fn=None, alt_interval: int = 1):
    """Wrap ``step_fn(state, batch, **draws_i) -> metrics`` into
    ``multi_step(state, inputs, step0=0, **draws) -> stacked metrics``,
    K steps in order.

    ``alt_step_fn`` (with ``alt_interval > 1``) runs on every inner step
    whose global index ``step0 + i`` is not a multiple of
    ``alt_interval``, ``step_fn`` on the multiples: lazy R1, exact across
    call boundaries for any K, since the trainer passes its step count as
    ``step0``. ``multi_step.pattern(step0)`` is the tuple of the inner
    steps that run ``step_fn``.
    """
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1: {steps_per_call}")
    if batch_mode not in ("broadcast", "scan"):
        raise ValueError(f"unknown batch_mode: {batch_mode}")
    k = steps_per_call

    def pattern(step0):
        if alt_step_fn is None:
            return (True,) * k
        return tuple((step0 + i) % alt_interval == 0 for i in range(k))

    def multi_step(state, inputs, step0=0, **draws):
        per_step = []
        for i, primary in enumerate(pattern(step0)):
            batch = inputs if batch_mode == "broadcast" else inputs[i]
            fn = step_fn if primary else alt_step_fn
            per_step.append(fn(state, batch,
                               **{n: d[i] for n, d in draws.items()}))
        return {name: torch.stack([m[name] for m in per_step])
                for name in per_step[0]}

    multi_step.pattern = pattern
    multi_step.batch_mode = batch_mode
    return multi_step


def stack_batches(batch_iter, k: int):
    """Group a host batch iterator into stacked ``(K, B, ...)`` arrays. A
    trailing partial group is dropped (a graph has one shape)."""
    group = []
    for batch in batch_iter:
        group.append(batch)
        if len(group) == k:
            yield np.stack(group)
            group = []


def state_tensors(state) -> list[torch.Tensor]:
    """Every tensor a train step updates in place: the parameters and
    buffers of each module field of ``state`` and the tensors of each
    optimizer field's state."""
    out = []
    for field in dataclasses.fields(state):
        value = getattr(state, field.name)
        if isinstance(value, nn.Module):
            out += list(value.parameters()) + list(value.buffers())
        elif isinstance(value, torch.optim.Optimizer):
            out += [t for s in value.state.values() for t in s.values()
                    if isinstance(t, torch.Tensor)]
    return out


class GraphedChunk:
    """``multi_step`` replayed from CUDA graphs, one captured for each R1
    pattern a call meets (at most ``alt_interval``), sharing one memory
    pool. A call copies its inputs and draws into the graphs' static
    buffers, replays, and returns clones of the stacked metrics (the next
    replay overwrites the graph's own).

    Before a pattern's capture, its K steps run once eagerly on a side
    stream (kernel builds, ``ops/consts.py`` constants, Adam's state,
    cuDNN's workspaces all exist before the capture), and the train state
    is then put back as it was (Adam state the warm-up created is zeroed,
    which is Adam's initial state), so the warm-up trains nothing. A
    capture that fails raises; nothing falls back to eager. The optimizers
    must be capturable (``train/common.py::make_adam`` on CUDA), and
    anything that replaces the state's tensors (rather than copying into
    them) after a capture would leave the graphs on the old ones: a resume
    loads before the first call, and an optimizer's rate is set with
    ``fill_``. In
    'broadcast' mode ``inputs`` (the device archive) is one tensor for
    every call and is read in place; in 'scan' mode each call's stacked
    batches are copied into a static buffer.
    """

    def __init__(self, multi_step):
        self.multi_step = multi_step
        self.graphs = {}
        self._pool = None
        self._inputs = None
        self._draws = None

    def __call__(self, state, inputs, step0=0, **draws):
        if self._draws is None:
            self._inputs = (inputs if self.multi_step.batch_mode ==
                            "broadcast" else inputs.clone())
            self._draws = {n: d.clone() for n, d in draws.items()}
        else:
            if inputs is not self._inputs:
                self._inputs.copy_(inputs)
            for n, d in draws.items():
                self._draws[n].copy_(d)
        key = self.multi_step.pattern(step0)
        if key not in self.graphs:
            self.graphs[key] = self._capture(state, step0)
        graph, out = self.graphs[key]
        graph.replay()
        return {name: t.clone() for name, t in out.items()}

    def _capture(self, state, step0):
        # autograd graphs of earlier steps that only a reference cycle
        # keeps (R1's double backward) would keep their AccumulateGrad
        # nodes, and with them the stream those steps ran on, into the
        # capture: a backward there would then join that stream
        gc.collect()
        with torch.no_grad():
            saved = [(t, t.clone()) for t in state_tensors(state)]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.multi_step(state, self._inputs, step0, **self._draws)
        torch.cuda.current_stream().wait_stream(side)
        with torch.no_grad():
            kept = {id(t) for t, _ in saved}
            for t, before in saved:
                t.copy_(before)
            for t in state_tensors(state):
                if id(t) not in kept:
                    t.zero_()
        del saved
        for field in dataclasses.fields(state):
            opt = getattr(state, field.name)
            if isinstance(opt, torch.optim.Optimizer):
                opt.zero_grad(set_to_none=True)
        gc.collect()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                out = self.multi_step(state, self._inputs, step0,
                                      **self._draws)
        except RuntimeError as e:
            raise RuntimeError(
                f"CUDA graph capture of a {len(self.multi_step.pattern(0))}"
                f"-step call failed: {e}") from e
        return graph, out
