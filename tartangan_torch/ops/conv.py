"""A 2-D convolution (stride 1, any padding) whose derivatives of every
order are ordinary convolutions: forward (fprop), input gradient (dgrad)
and weight gradient (wgrad).

Autograd differentiates its own ``ConvolutionBackward`` node through ATen's
generic ``_convolution_double_backward``. That function computes the
derivative of the input gradient with respect to the weight (R1's weight
term, ``models/losses.py``) as a forward convolution of the transposed
tensors ggI^T (Cin, B, H, W) and gO^T (Cout, B, H, W): a filter the size
of the image, with the batch as its channels, which cuDNN runs through a
slow "indexed" implicit GEMM. The same term is a weight gradient,
wgrad(input=ggI, grad_output=gO), which cuDNN runs on the ordinary layout.

Three ``torch.autograd.Function``s whose backwards call each other:

- ``_Conv(x, w, b)``: ``F.conv2d``; backward ``_Dgrad(gO, w)`` for x,
  ``_Wgrad(x, gO)`` for w and gO summed for b;
- ``_Dgrad(gO, w)``: the input gradient, a transposed convolution; backward
  ``_Conv(ggI, w)`` for gO and ``weight_term``, ``_Wgrad(ggI, gO)``, for w;
- ``_Wgrad(x, gO)``: the weight gradient; backward ``_Dgrad(gO, ggW)`` for x
  and ``_Conv(x, ggW)`` for gO.

``_Conv`` keeps x and w in a node of their own ahead of it, ``_Keep``,
which saves them before the convolution runs, as autograd's own node saves
its inputs: a rematerialized region (``torch.utils.checkpoint``, ``ops/
remat.py``) stops recomputing at its last saved tensor, so it does not
recompute a convolution that ends it.

A backward computes only the gradients the engine will use: those of the
inputs that need one (``needs_input_grad``) along the edges the current
backward runs (``torch._C._will_engine_execute_node``, the engine's own
test; R1's ``autograd.grad`` with respect to the input runs no weight
edge). Where no graph is being built (a first-order backward) ``_Conv``'s
backward is one ``aten.convolution_backward`` with that output mask, the
call autograd's own node makes. Outside autograd (grad mode off, or neither
x nor w requires a gradient) ``conv2d`` is ``F.conv2d``, so serving,
sampling and export keep their graphs and kernels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.nn.modules.utils import _pair

from ..utils import tracing

_aten = torch.ops.aten


def _graph(*ts) -> bool:
    """Whether an op on ``ts`` is recorded for autograd."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _runs(node) -> bool:
    """Whether the current backward runs ``node``. The engine refuses to say
    for a leaf that ``autograd.grad`` captures, and runs it."""
    try:
        return torch._C._will_engine_execute_node(node)
    except RuntimeError:
        return True


def _mask(node) -> list:
    """For each tensor input of a Function's backward ``node``, in order,
    whether the current backward uses its gradient."""
    return [need and _runs(edge) for need, (edge, _)
            in zip(node.needs_input_grad, node.next_functions)]


def _backward(gO, x, w, padding, mask, bias=None):
    """``aten.convolution_backward``, the call autograd's own node makes;
    ``bias`` is the bias's size."""
    return _aten.convolution_backward(gO, x, w, bias, [1, 1], padding,
                                      [1, 1], False, [0, 0], 1, mask)


def _dgrad(gO, w, padding):
    """The gradient of ``conv(x, w)`` with respect to x."""
    if _graph(gO, w):
        return _Dgrad.apply(gO, w, padding)
    return F.conv_transpose2d(gO, w, None, 1, padding)


def _wgrad(x, gO, w, padding):
    """The gradient of ``conv(x, w)`` with respect to w, which only lends
    its shape."""
    if _graph(x, gO):
        return _Wgrad.apply(x, gO, w.detach(), padding)
    return _backward(gO, x, w, padding, [False, True, False])[1]


@tracing.counted
def weight_term(ggI, gO, w, padding):
    """R1's weight term: the derivative of the input gradient
    ``_dgrad(gO, w)``, contracted with ``ggI``, with respect to w, as a
    weight gradient. ``launches`` counts its calls."""
    tracing.count_launch(weight_term, gO.dtype)
    return _wgrad(ggI, gO, w, padding)


class _Keep(torch.autograd.Function):
    """x and w passed on, saved for ``_Conv``'s backward."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return x, w

    @staticmethod
    def backward(ctx, gx, gw):
        return gx, gw


class _Conv(torch.autograd.Function):
    """Applied to ``_Keep``'s outputs, whose node holds x and w."""

    @staticmethod
    def forward(ctx, x, w, b, padding):
        ctx.padding, ctx.bias = padding, b is not None
        return F.conv2d(x, w, b, 1, padding)

    @staticmethod
    def backward(ctx, gO):
        keep = ctx.next_functions[0][0]
        x, w = keep.saved_tensors
        padding = ctx.padding
        need_x, need_w = _mask(keep)
        need_b = ctx.needs_input_grad[2] and _runs(ctx.next_functions[2][0])
        if not torch.is_grad_enabled():
            gx, gw, gb = _backward(gO, x, w, padding,
                                   [need_x, need_w, need_b],
                                   [w.shape[0]] if ctx.bias else None)
            return gx, gw, gb, None
        return (_dgrad(gO, w, padding) if need_x else None,
                _wgrad(x, gO, w, padding) if need_w else None,
                gO.sum((0, 2, 3)) if need_b else None, None)


class _Dgrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gO, w, padding):
        ctx.save_for_backward(gO, w)
        ctx.padding = padding
        return _dgrad(gO, w, padding)

    @staticmethod
    def backward(ctx, ggI):
        gO, w = ctx.saved_tensors
        need_gO, need_w = _mask(ctx)
        return (conv2d(ggI, w, None, ctx.padding) if need_gO else None,
                weight_term(ggI, gO, w, ctx.padding) if need_w else None,
                None)


class _Wgrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gO, w, padding):
        ctx.save_for_backward(x, gO)
        ctx.padding = padding
        return _wgrad(x, gO, w, padding)

    @staticmethod
    def backward(ctx, ggW):
        x, gO = ctx.saved_tensors
        need_x, need_gO, _ = _mask(ctx)
        return (_dgrad(gO, ggW, ctx.padding) if need_x else None,
                conv2d(x, ggW, None, ctx.padding) if need_gO else None,
                None, None)


def conv2d(x, w, b=None, padding=0):
    """``F.conv2d(x, w, b, padding=padding)``; while a graph is being
    built, through ``_Keep`` and ``_Conv``."""
    if not _graph(x, w):
        return F.conv2d(x, w, b, 1, padding)
    return _Conv.apply(*_Keep.apply(x, w), b, _pair(padding))
