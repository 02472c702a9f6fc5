"""The weights a run starts from, made by the benchmark from the seed.

Both sides take these: the program has them copied into its modules, the
reference loads them. Names and shapes are those of the reference's G and
D ``state_dict`` (the program's names), which a model module hands to
``make``. All parameters come from one ``torch.randn`` on the device, from
a generator seeded by the run's seed, in float32 (the parameters' type in
either precision), and are scaled by leaf:

- convolution and dense weights N(0, 1 / (3 fan_in)), as torch's default
  uniform init has it, and their biases likewise;
- BatchNorm scales 1 + 0.1 N(0, 1), shifts 0.1 N(0, 1); running
  statistics 0 and 1;
- the attention's ``gamma`` 1 + 0.1 N(0, 1): the model starts it at 0,
  where the attention adds nothing and the comparison could not see it.
"""
from __future__ import annotations

import torch


def _scale(name: str, shapes: dict) -> tuple[float, float]:
    """(std, mean) of the leaf ``name``."""
    if name.endswith("gamma"):
        return 0.1, 1.0
    if "BatchNorm_0" in name:
        return 0.1, (1.0 if name.endswith("weight") else 0.0)
    weight = shapes[name.rsplit(".", 1)[0] + ".weight"]
    fan_in = 1
    for n in weight[1:]:
        fan_in *= n
    return (3.0 * fan_in) ** -0.5, 0.0


def make(models: tuple, seed: int, device) -> dict:
    """{"g": state_dict, "d": state_dict} for the reference's ``models``,
    (G, D)."""
    g, d = models
    out = {}
    gen = torch.Generator(device=device).manual_seed(seed)
    for key, model in (("g", g), ("d", d)):
        state = model.state_dict()
        shapes = {n: tuple(t.shape) for n, t in state.items()}
        params = [n for n, _ in model.named_parameters()]
        total = sum(state[n].numel() for n in params)
        flat = torch.randn(total, generator=gen, device=device)
        sd, at = {}, 0
        for n in params:
            k = state[n].numel()
            std, mean = _scale(n, shapes)
            sd[n] = (flat[at:at + k] * std + mean).view(shapes[n])
            at += k
        for n, t in state.items():
            if n not in sd:  # BatchNorm's running statistics
                sd[n] = t.to(device)
        out[key] = sd
    return out
