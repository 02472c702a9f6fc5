"""Carry weights and Adam state between flax variable trees and torch modules.

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

The fused generator block keeps the reference's flat names in both trees:
``conv1_kernel``, ``conv2_kernel``, ``project_kernel`` (HWIO <-> OIHW, the
name unchanged), ``bn1_scale`` etc. as they are, and the ``batch_stats``
``bn1_mean``, ``bn1_var``, ``bn2_mean``, ``bn2_var`` as buffers of those
names. The parity blocks have the plain blocks' trees.

The same mapping covers the discriminator (``input_block``, ``blocks_N``,
``output_block/Dense_0``, ``project_input``) and the Adam state: flax's
serializer writes optax's ``adam`` state as ``{"0": {"count": int32,
"mu": <params tree>, "nu": <params tree>}, "1": {}}``, and torch's
``Adam`` keeps ``step``, ``exp_avg`` and ``exp_avg_sq`` per parameter.
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
            elif name.endswith("_kernel"):  # the fused block's flat convs
                t = t.permute(3, 2, 0, 1)
            elif name == "scale":
                name = "weight"
            elif collection == "batch_stats":
                name = _STATS.get(name, name)
            state[".".join(parents + [name])] = t.contiguous()
    return state


def to_flax(module: nn.Module) -> dict:
    """A torch module -> a flax ``{"params", "batch_stats"}`` tree of numpy
    arrays (the inverse of ``from_flax``)."""
    tree = _to_tree(module.state_dict().items())
    if not tree["batch_stats"]:
        del tree["batch_stats"]
    return tree


def _to_tree(named_tensors) -> dict:
    tree = {"params": {}, "batch_stats": {}}
    stats = {v: k for k, v in _STATS.items()}
    for key, t in named_tensors:
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
        elif name.endswith(("_mean", "_var")):  # the fused block's stats
            collection = "batch_stats"
        elif name == "weight" and parents and parents[-1] == _BN:
            name = "scale"
        elif name == "weight":
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
            name = "kernel"
        elif name.endswith("_kernel"):
            arr = arr.transpose(2, 3, 1, 0)
        node = tree[collection]
        for part in path:
            node = node.setdefault(part, {})
        node[name] = np.array(arr, order="C")  # ascontiguousarray makes 0-d 1-d
    return tree


def adam_to_flax(module: nn.Module, opt: torch.optim.Adam) -> dict:
    """``opt``'s state for ``module``'s parameters as flax serializes
    ``optax.adam``'s: ``{"0": {"count", "mu", "nu"}, "1": {}}``. A
    parameter that has no state yet (no step taken) has zero moments."""
    named = list(module.named_parameters())
    states = [opt.state.get(p, {}) for _, p in named]
    steps = {int(s["step"]) for s in states if "step" in s}
    if len(steps) > 1:
        raise ValueError(f"Adam state has parameters at steps {sorted(steps)}")

    def moment(key):
        return _to_tree((name, s[key] if key in s else torch.zeros_like(p))
                        for (name, p), s in zip(named, states))["params"]
    count = np.array(steps.pop() if steps else 0, np.int32)
    return {"0": {"count": count, "mu": moment("exp_avg"),
                  "nu": moment("exp_avg_sq")}, "1": {}}


def adam_from_flax(module: nn.Module, opt: torch.optim.Adam, tree) -> None:
    """Load an ``adam_to_flax`` tree (or one the JAX trainer wrote) into
    ``opt``'s state for ``module``'s parameters."""
    state = tree["0"]
    mu = from_flax({"params": state["mu"]})
    nu = from_flax({"params": state["nu"]})
    step = float(np.asarray(state["count"]))
    for name, p in module.named_parameters():
        opt.state[p] = {
            "step": torch.tensor(step, dtype=torch.float32),
            "exp_avg": mu[name].to(p.device, p.dtype).clone(),
            "exp_avg_sq": nu[name].to(p.device, p.dtype).clone(),
        }
