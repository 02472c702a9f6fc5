"""Carry generator weights between flax variable trees and torch modules.

A flax tree is ``{"params": ..., "batch_stats": ...}`` of nested dicts with
array leaves, as ``flax.serialization`` writes it. The torch modules of this
package keep flax's module names as attribute names, so the mapping is a
path rename plus a layout change per leaf:

- ``blocks_N`` <-> ``blocks.N`` (the generator's ``nn.ModuleList``);
- ``NormAct_i/BatchNorm_0/BatchNorm_0/{scale,bias}`` <->
  ``NormAct_i.BatchNorm_0.{weight,bias}``, and the ``batch_stats``
  ``{mean,var}`` <-> ``{running_mean,running_var}``;
- conv ``kernel`` HWIO <-> ``weight`` OIHW; dense ``kernel`` (in, out) <->
  ``weight`` (out, in); attention ``theta/phi/g/o`` are (1, 1, Cin, Cout)
  convs without bias; ``gamma`` is a 0-d array.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

_BN = "BatchNorm_0"
_STATS = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _torch_path(path):
    out = []
    for part in path:
        if part.startswith("blocks_") and part[7:].isdigit():
            out += ["blocks", part[7:]]
        elif part == _BN and out and out[-1] == _BN:
            continue  # flax nests nn.BatchNorm inside the BatchNorm wrapper
        else:
            out.append(part)
    return out


def from_flax(variables) -> dict[str, torch.Tensor]:
    """A flax ``{"params", "batch_stats"}`` tree -> a torch ``state_dict``."""
    state = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(collection, {})):
            t = leaf if isinstance(leaf, torch.Tensor) else \
                torch.from_numpy(np.array(leaf))
            *parents, name = _torch_path(path)
            if name == "kernel":
                t = t.permute(3, 2, 0, 1) if t.dim() == 4 else t.T
                name = "weight"
            elif name == "scale":
                name = "weight"
            elif collection == "batch_stats":
                name = _STATS[name]
            state[".".join(parents + [name])] = t.contiguous()
    return state


def to_flax(module: nn.Module) -> dict:
    """A torch module -> a flax ``{"params", "batch_stats"}`` tree of numpy
    arrays (the inverse of ``from_flax``)."""
    tree = {"params": {}, "batch_stats": {}}
    stats = {v: k for k, v in _STATS.items()}
    for key, t in module.state_dict().items():
        parts = key.split(".")
        *parents, name = parts
        path = []
        i = 0
        while i < len(parents):
            if parents[i] == "blocks" and i + 1 < len(parents):
                path.append(f"blocks_{parents[i + 1]}")
                i += 2
                continue
            path.append(parents[i])
            if parents[i] == _BN:
                path.append(_BN)
            i += 1
        arr = t.detach().cpu().numpy()
        collection = "params"
        if name in stats:
            collection, name = "batch_stats", stats[name]
        elif name == "weight" and parents and parents[-1] == _BN:
            name = "scale"
        elif name == "weight":
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
            name = "kernel"
        node = tree[collection]
        for part in path:
            node = node.setdefault(part, {})
        node[name] = np.array(arr, order="C")  # ascontiguousarray makes 0-d 1-d
    if not tree["batch_stats"]:
        del tree["batch_stats"]
    return tree
