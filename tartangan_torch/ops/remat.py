"""Rematerialization of the tower blocks (``--remat``, ``--remat-policy``).

Counterpart of the JAX package's ``nn.remat`` of the residual and parity
blocks (``tartangan_tpu/models/factories.py:53-157``) and of its
``_ckpt`` tags (``models/blocks.py:51-59``). A rematted block runs under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``: its
forward keeps only the block's input, and the backward recomputes what it
needs. What the recomputation may take from the forward instead is the
policy's:

- ``full``: nothing; everything is recomputed, the convolutions too;
- ``convs``: the values of the calls tagged with ``tagged`` (the blocks'
  main-path convolutions, as ``_ckpt`` tags them), so only the norm, act
  and resample chains between them are recomputed;
- ``dots``: the outputs of products with no batch dimensions (``aten.mm``,
  ``aten.addmm``: JAX's ``dots_with_no_batch_dims_saveable``). These
  blocks hold none, so it recomputes what ``full`` does.

A saving policy keeps its values in a ``_Frame``, in the order the
forward made them, and a recomputation takes them back in that order. The
convolutions are seen by a ``TorchDispatchMode``; a hand-written kernel,
launched through ``ctypes``, is not, so its wrapper (K3's
``merged_tap_conv``) passes its launch through ``reuse``. A taken-back
value enters the autograd graph as the output of its op, so the op's
backward (and R1's second order through it) runs as without remat.

The recomputation leaves every running statistic as it is: JAX's remat
is functional and updates BatchNorm's statistics once, in the forward,
where the port's recomputation would apply the update again (R1's inner
gradient recomputes D's blocks inside ``update_batch_stats``). The
recomputation may run more than once for one forward (R1's inner gradient,
then the outer backward), each time from the same saved values.
"""
from __future__ import annotations

import contextlib
import threading

import torch
from torch.utils.checkpoint import checkpoint
from torch.utils._python_dispatch import TorchDispatchMode

POLICIES = ("full", "convs", "dots")

_aten = torch.ops.aten
# what a saving policy saves: (the ops whose outputs it keeps, only inside
# a tagged call?, hand-written kernels' outputs too?)
_SAVES = {"convs": (frozenset({_aten.convolution.default}), True, True),
          "dots": (frozenset({_aten.mm.default, _aten.addmm.default}),
                   False, False)}
_LOCAL = threading.local()


def remat_policy(name):
    """Check a --remat-policy name; 'full' (or None) saves nothing."""
    if name is None:
        return "full"
    if name not in POLICIES:
        raise ValueError(f"unknown remat policy '{name}'")
    return name


class _Frame:
    """The values one checkpointed call keeps under a saving policy."""

    def __init__(self, policy):
        self.ops, self.tagged_only, self.kernels = _SAVES[policy]
        self.saved = []
        self.pos = None  # None: the forward records; an index: replaying
        self.tags = 0    # depth of tagged calls
        self.paused = 0  # inside a value being recorded as a whole

    def wants(self, func) -> bool:
        return (not self.paused and func in self.ops
                and (self.tags > 0 or not self.tagged_only))

    def take(self, compute):
        """``compute()`` recorded (the forward), or the value it gave there
        (a recomputation)."""
        if self.pos is None:
            self.paused += 1
            try:
                out = compute()
            finally:
                self.paused -= 1
            self.saved.append(out.detach())
            return out
        out = self.saved[self.pos]
        self.pos += 1
        return out.detach()


def _frames():
    if not hasattr(_LOCAL, "frames"):
        _LOCAL.frames = []
    return _LOCAL.frames


def _current():
    frames = _frames()
    return frames[-1] if frames else None


def tagged(fn, *args):
    """``fn(*args)``, a value ``convs`` saves (JAX's ``_ckpt``)."""
    frame = _current()
    if frame is None:
        return fn(*args)
    frame.tags += 1
    try:
        return fn(*args)
    finally:
        frame.tags -= 1


def reuse(compute):
    """``compute()``, a hand-written kernel's launch: under ``convs``,
    inside a tagged call, recorded in the forward and taken back in a
    recomputation, which then launches nothing."""
    frame = _current()
    if frame is None or not frame.kernels or frame.tags == 0:
        return compute()
    return frame.take(compute)


class _SaveMode(TorchDispatchMode):
    def __init__(self, frame):
        super().__init__()
        self.frame = frame

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.frame.wants(func):
            return self.frame.take(lambda: func(*args, **kwargs))
        return func(*args, **kwargs)


class _Context:
    """The forward's (``replay=False``) or the recomputation's context of
    one checkpointed call; the recomputation's is entered once for each
    recomputation."""

    def __init__(self, block, frame, replay):
        self.block, self.frame, self.replay = block, frame, replay
        self._stack = None

    def __enter__(self):
        stack = contextlib.ExitStack()
        if self.replay:
            stats = [m for m in self.block.modules()
                     if getattr(m, "update_stats", False)]
            for m in stats:
                m.update_stats = False
            stack.callback(_restore, stats)
        frame = self.frame
        if frame is not None:
            frame.pos = 0 if self.replay else None
            _frames().append(frame)
            stack.callback(_frames().pop)
            stack.enter_context(_SaveMode(frame))
        self._stack = stack
        return self

    def __exit__(self, *exc):
        stack, self._stack = self._stack, None
        return stack.__exit__(*exc)


def _restore(modules):
    for m in modules:
        m.update_stats = True


def checkpoint_block(block, fn, x, train, policy):
    """``fn(x, train)``, block ``block``'s forward, rematerialized under
    ``policy`` (None: not rematerialized). Without grad mode there is
    nothing to save, and it runs as it is."""
    if policy is None or not torch.is_grad_enabled():
        return fn(x, train)

    def contexts():
        frame = _Frame(policy) if policy in _SAVES else None
        return _Context(block, frame, False), _Context(block, frame, True)
    return checkpoint(fn, x, train, use_reentrant=False,
                      preserve_rng_state=False, context_fn=contexts)
