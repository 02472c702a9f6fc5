"""Carry weights and Adam state between flax variable trees and torch modules.

A flax tree is ``{"params": ..., "batch_stats": ...}`` of nested dicts with
array leaves, as ``flax.serialization`` writes it. The torch modules of this
package keep flax's module names as attribute names, so the mapping is a
path rename plus a layout change per leaf:

- ``blocks_N`` <-> ``blocks.N`` (the generator's ``nn.ModuleList``);
- ``NormAct_i/BatchNorm_0/BatchNorm_0/{scale,bias}`` <->
  ``NormAct_i.BatchNorm_0.{weight,bias}``, and the ``batch_stats``
  ``{mean,var}`` <-> ``{running_mean,running_var}``;
- conv ``kernel`` HWIO <-> ``weight`` OIHW, and in 1-D (the text GAN's
  convs) WIO <-> OIW; dense ``kernel`` (in, out) <-> ``weight`` (out, in);
  attention ``theta/phi/g/o`` are (1, 1, Cin, Cout) convs without bias;
  ``gamma`` is a 0-d array.

The fused generator block keeps the reference's flat names in both trees:
``conv1_kernel``, ``conv2_kernel``, ``project_kernel`` (HWIO <-> OIHW, the
name unchanged), ``bn1_scale`` etc. as they are, and the ``batch_stats``
``bn1_mean``, ``bn1_var``, ``bn2_mean``, ``bn2_var`` as buffers of those
names. The parity blocks have the plain blocks' trees.

The shared-filter models keep flax's auto-names as attribute names
(``SharedResidualGeneratorBlock_0/SharedConvBlock_1/bias``, ...), and
their one bank ``shared_filters`` is HWIO (3, 3, max_in, max_out) <-> OIHW
under its own name. The scene generator's trees are plain dense and conv
leaves (``structure_generator/patch_transforms``, ``SceneBlock_3/patch/
alpha``, ``refine_canvas``, ...), and the SkipGram's tables
``embedding_u`` and ``embedding_v`` are (V, D) in both trees.

The same mapping covers the discriminator (``input_block``, ``blocks_N``,
``output_block/Dense_0``, ``project_input``), the IQN discriminator's head
(``output_block/IQN_0/quantile_embedding/to_state`` and
``output_block/to_output``, dense layers) and the InfoGAN discriminator's
heads (``output_block/LinearOutput_0/Dense_0`` and ``LinearOutput_1``),
the quantile embedding's ``BatchNorm_1`` as any ``BatchNorm_k`` wrapper,
and the Adam state: flax's
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


# a flax ``kernel`` by its rank -> torch's ``weight``, and back: conv HWIO
# <-> OIHW, 1-D conv WIO <-> OIW, dense (in, out) <-> (out, in)
_KERNEL_TO_TORCH = {4: lambda t: t.permute(3, 2, 0, 1),
                    3: lambda t: t.permute(2, 1, 0), 2: lambda t: t.T}
_KERNEL_TO_FLAX = {4: lambda a: a.transpose(2, 3, 1, 0),
                   3: lambda a: a.transpose(2, 1, 0), 2: lambda a: a.T}


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _is_bn(part: str) -> bool:
    """A ``BatchNorm_k`` wrapper (``NormAct``'s ``BatchNorm_0``, the
    quantile embedding's ``BatchNorm_0`` and ``BatchNorm_1``)."""
    return part.startswith("BatchNorm_") and part[10:].isdigit()


def _torch_path(path):
    out = []
    for part in path:
        if part.startswith("blocks_") and part[7:].isdigit():
            out += ["blocks", part[7:]]
        elif part == _BN and out and _is_bn(out[-1]):
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
                t = _KERNEL_TO_TORCH[t.dim()](t)
                name = "weight"
            elif name.endswith("_kernel") or name == "shared_filters":
                # the fused block's flat convs and the shared bank, HWIO
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
            if _is_bn(parents[i]):
                path.append(_BN)
            i += 1
        arr = t.detach().cpu().numpy()
        collection = "params"
        if name in stats:
            collection, name = "batch_stats", stats[name]
        elif name.endswith(("_mean", "_var")):  # the fused block's stats
            collection = "batch_stats"
        elif name == "weight" and parents and _is_bn(parents[-1]):
            name = "scale"
        elif name == "weight":
            arr = _KERNEL_TO_FLAX[arr.ndim](arr)
            name = "kernel"
        elif name.endswith("_kernel") or name == "shared_filters":
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
    ``opt``'s state for ``module``'s parameters, replacing it; a
    capturable Adam keeps its step count on the parameter's device. The
    trainer resumes before its first call, so before any CUDA graph
    captures the state (``train/multi.py``)."""
    state = tree["0"]
    mu = from_flax({"params": state["mu"]})
    nu = from_flax({"params": state["nu"]})
    step = float(np.asarray(state["count"]))
    on_device = opt.defaults.get("capturable", False)
    for name, p in module.named_parameters():
        opt.state[p] = {
            "step": torch.tensor(step, dtype=torch.float32,
                                 device=p.device if on_device else "cpu"),
            "exp_avg": mu[name].to(p.device, p.dtype).clone(),
            "exp_avg_sq": nu[name].to(p.device, p.dtype).clone(),
        }
