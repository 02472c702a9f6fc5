"""The mesh's collectives as autograd Functions, and the reductions built
on them.

Two families, one for each mesh axis (``parallel/mesh.py``), differ in
what a rank's graph stands for:

- **data axis.** Each rank's graph computes its share of the global loss
  (its rows, divided by the global batch). ``data_sum`` all-reduces a
  tensor (BatchNorm's moment sums); its backward all-reduces the incoming
  gradients, because every rank's share depends on the sum. It is its own
  backward, so it differentiates to any order (R1's double backward).
- **model axis** (``--tp``). The ranks of a model group compute the same
  thing on the same rows, apart from the output-channel slices of the
  sharded weights. ``tp_gather`` all-gathers slices along a dimension; its
  backward takes the rank's slice of the gradient (every rank holds the
  whole gradient already), which is ``tp_split``, whose backward is
  ``tp_gather``. ``tp_copy`` is the identity whose backward all-reduces
  (the input of a column-parallel layer gets a partial gradient from each
  slice), which is ``tp_reduce``, whose backward is ``tp_copy``.

Each backward is made of the same Functions, so all of them differentiate
again. ``broadcast`` (from one rank; backward: the all-reduce of the
gradients, kept on the source) completes the set. The Functions take
their group explicitly and are called through the helpers below, which
read the current mesh and are the identity without one.

``batch_mean`` and ``batch_moments`` are what the losses and the
BatchNorms call: the mean over the global batch, and the global per-
channel mean and biased variance, with no collective at world size 1
(``mesh.current()`` is None there, and the code is today's). Gloo carries
these collectives on CPU and CUDA tensors, NCCL on CUDA tensors.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from . import mesh as _mesh


# ------------------------------------------------------------ raw collectives
def _all_reduce(x, group):
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


def _all_gather(x, dim, group):
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def _chunk(x, dim, group):
    n = dist.get_world_size(group)
    i = dist.get_rank(group)
    return x.detach().chunk(n, dim)[i].contiguous()


# -------------------------------------------------------- autograd Functions
class DataSum(torch.autograd.Function):
    """All-reduce (sum) over the data group; backward: the same."""

    @staticmethod
    def forward(x, group):
        return _all_reduce(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return DataSum.apply(g, ctx.group), None


class Broadcast(torch.autograd.Function):
    """Broadcast from global rank ``src``; backward: the all-reduce of the
    gradients on ``src``, zero elsewhere."""

    @staticmethod
    def forward(x, src, group):
        out = x.detach().clone(memory_format=torch.contiguous_format)
        dist.broadcast(out, src, group=group)
        return out

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.src, ctx.group = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        total = DataSum.apply(g, ctx.group)
        keep = float(dist.get_rank() == ctx.src)
        return total * keep, None, None


class TPCopy(torch.autograd.Function):
    """Identity into a column-parallel layer; backward: all-reduce over the
    model group."""

    @staticmethod
    def forward(x, group):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return TPReduce.apply(g, ctx.group), None


class TPReduce(torch.autograd.Function):
    """All-reduce over the model group of partial results that every rank
    then uses alike; backward: the identity (``TPCopy``)."""

    @staticmethod
    def forward(x, group):
        return _all_reduce(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return TPCopy.apply(g, ctx.group), None


class TPGather(torch.autograd.Function):
    """All-gather of the model group's slices along ``dim``; backward: the
    rank's slice of the gradient (``TPSplit``)."""

    @staticmethod
    def forward(x, dim, group):
        return _all_gather(x, dim, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dim, ctx.group = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return TPSplit.apply(g, ctx.dim, ctx.group), None, None


class TPSplit(torch.autograd.Function):
    """The rank's slice along ``dim`` of a tensor every rank of the model
    group holds; backward: the all-gather of the slices' gradients."""

    @staticmethod
    def forward(x, dim, group):
        return _chunk(x, dim, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dim, ctx.group = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return TPGather.apply(g, ctx.dim, ctx.group), None, None


# ------------------------------------------------------------------ helpers
def data_reducing():
    """The current mesh when the data-axis reductions are on: a mesh is set
    up and the caller is not inside ``mesh.replicated()``."""
    m = _mesh.current()
    return m if m is not None and not _mesh.is_replicated() else None


def data_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data group (differentiable), or ``x``."""
    m = data_reducing()
    return x if m is None else DataSum.apply(x, m.data_group)


def data_size() -> int:
    """How many data shards the batch is split into here (1 without a mesh
    or inside ``mesh.replicated()``)."""
    m = data_reducing()
    return 1 if m is None else m.dp


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """``x.mean()`` over the global batch: without a mesh ``x.mean()``;
    with one, this rank's share of it, ``x.sum() / (x.numel() * dp)``, so
    that the ranks' shares add up to the global mean (the gradient
    all-reduce sums them)."""
    m = data_reducing()
    if m is None:
        return x.mean()
    return x.sum() / (x.numel() * m.dp)


def batch_moments(x2d: torch.Tensor):
    """Per-column mean and biased variance of ``x2d`` (rows, C) over the
    rows of every data shard, as ``mean(x^2) - mean^2`` from one all-reduce
    of the sums; differentiable."""
    s = data_sum(torch.stack([x2d.sum(0), x2d.square().sum(0)]))
    n = x2d.shape[0] * data_size()
    mean = s[0] / n
    return mean, s[1] / n - mean.square()


def tp_copy(x, tp):
    return TPCopy.apply(x, tp.group)


def tp_gather(x, dim, tp):
    return TPGather.apply(x, dim, tp.group)


def broadcast(x: torch.Tensor, src: int = 0) -> torch.Tensor:
    """``x`` from global rank ``src`` on every rank (differentiable), or
    ``x`` without a mesh."""
    m = _mesh.current()
    return x if m is None else Broadcast.apply(x, src, None)


@torch.no_grad()
def all_reduce_grads(params, group) -> None:
    """Sum the gradients of ``params`` over ``group`` in one flat bucket
    (parameters without a gradient are left out, alike on every rank)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n


@torch.no_grad()
def sum_metrics(metrics: dict) -> dict:
    """A step's 0-d or (K,) metric tensors summed over the data group in
    one all-reduce: each rank's are its share of the global-batch means."""
    m = _mesh.current()
    if m is None or not metrics:
        return metrics
    names = list(metrics)
    dtype = metrics[names[0]].dtype
    flat = torch.stack([metrics[n].to(dtype) for n in names])
    dist.all_reduce(flat, group=m.data_group)
    return {n: flat[i] for i, n in enumerate(names)}
