"""Tensor parallelism (``--tp``): the weights' output channels sharded over
the model group.

Counterpart of ``tartangan_tpu/parallel/mesh.py:38-76``
(``TP_SHARDED_LEAVES``, ``param_sharding``). The JAX package shards every
leaf named ``kernel``, ``embedding_u`` or ``embedding_v`` whose trailing
(output-feature) dimension divides by ``tp``; everything else (biases,
BatchNorm's parameters and statistics, attention's gamma, the fused
block's flat ``*_kernel`` convs, the shared filter bank) is replicated.
Here the same leaves are the ``weight`` of every conv and dense layer
(``models/layers.py``: output channels first, in torch's layout) and the
SkipGram's two tables (their last dimension). Each rank keeps its slice as
the parameter, so Adam's moments are sharded alike and the EMA target,
sharded as G, updates slice by slice.

A sharded layer computes its slice of the output from the whole input and
all-gathers it along the channel dimension (``layers.py``), then adds the
bias; code that reads a sharded weight whole (the parity blocks' packers)
gathers it first (``layers.full_weight``). The gathers' backward takes the
rank's slice of the gradient (``collectives.TPGather``), so every weight's
gradient is exact on every rank, and the gradient all-reduce runs over the
data group only.

``unsharded`` makes the models whole for a while (checkpoints are written
and read in the one-process layout, which the JAX trainer reads too).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn

from ..models.layers import _Conv1d, _Conv2d, _Linear
from ..models.text import SkipGram
from .collectives import _all_gather, _chunk

TP_SHARDED_LEAVES = ("kernel", "embedding_u", "embedding_v")


def shard_module_(module: nn.Module, tp) -> int:
    """Replace each weight of ``module`` that ``--tp`` shards (a conv or
    dense layer's, along its output channels; the SkipGram's tables, along
    their last dimension) and whose dimension divides by ``tp.size`` with
    this rank's slice, in place, before any optimizer holds it; returns how
    many were sharded. ``tp`` is the mesh's ``TPGroup``."""
    shardable = []
    for m in module.modules():
        if isinstance(m, (_Conv1d, _Conv2d, _Linear)):
            shardable.append((m, "weight", 0))
        elif isinstance(m, SkipGram):
            shardable += [(m, "embedding_u", 1), (m, "embedding_v", 1)]
    count = 0
    for m, name, dim in shardable:
        p = getattr(m, name)
        if p.dim() < 2 or p.shape[dim] % tp.size:
            continue
        piece = p.detach().chunk(tp.size, dim)[tp.rank].clone()
        setattr(m, name, nn.Parameter(piece, requires_grad=p.requires_grad))
        m.tp = tp
        m.tp_dims = {**getattr(m, "tp_dims", {}), name: dim}
        count += 1
    return count


def _sharded(module):
    for m in module.modules():
        for name, dim in getattr(m, "tp_dims", {}).items():
            yield m, name, dim


@contextlib.contextmanager
def unsharded(modules, optimizers=()):
    """Within the block the sharded weights of ``modules`` (and their Adam
    moments in ``optimizers``) hold the whole tensors, gathered over the
    model group; on exit each keeps its slice of whatever it then holds
    (a checkpoint loaded in the block included). Every rank of the model
    group enters it together."""
    entries = [e for mod in modules for e in _sharded(mod)]
    if not entries:
        yield
        return
    group = entries[0][0].tp.group

    @torch.no_grad()
    def swap(fn):
        for m, name, dim in entries:
            p = getattr(m, name)
            p.data = fn(p.data, dim)
            for opt in optimizers:
                state = opt.state.get(p, {})
                for key in ("exp_avg", "exp_avg_sq"):
                    if key in state:
                        state[key] = fn(state[key], dim)

    swap(lambda t, dim: _all_gather(t, dim, group))
    try:
        yield
    finally:
        swap(lambda t, dim: _chunk(t, dim, group))


def placement_counts(tree, tp: int) -> dict:
    """``param_sharding``'s counts over a flax-layout tree of arrays (the
    checkpoint artifacts: parameters, statistics, EMA target and Adam's
    moments and count): a leaf is sharded when its name is in
    ``TP_SHARDED_LEAVES``, it has two or more dimensions and its last
    divides by ``tp``."""
    counts = {"sharded": 0, "replicated": 0}

    def walk(node, name):
        if isinstance(node, dict):
            for key, value in node.items():
                walk(value, key)
            return
        arr = np.asarray(node)
        if name in TP_SHARDED_LEAVES and arr.ndim >= 2 \
                and arr.shape[-1] % tp == 0:
            counts["sharded"] += 1
        else:
            counts["replicated"] += 1
    walk(tree, None)
    return counts


def placement_summary(tree, tp: int) -> str:
    """The JAX package's one-line summary (``mesh.py:71-74``)."""
    c = placement_counts(tree, tp)
    return (f"[tp] model-axis placement (tp={tp}): {c['sharded']} weight "
            f"leaves sharded on their output-feature dim, "
            f"{c['replicated']} replicated")
