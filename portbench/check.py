"""The comparison that decides a run's ``correct``.

The program's first steps (the set-up's, through the window's own loop)
are held against the same steps of the model's plain reference (the
SA-GAN's: ``portbench/reference.py``) on the same weights, rows and draws
(the latents, and any other draw the step takes). Four numbers, each
steady from seed to seed (``PERF.md`` gives the readings, and the look
that led from the worst leaf to these):

- ``loss``: the first step's D loss (BCE on reals and fakes + weight R1),
  |program - reference| / |reference|: G's and D's forwards, R1's input
  gradient, before any update.
- ``grad``: D's first gradient as the optimizer got it (Adam's first
  moment after step 1: with beta1 0 it is the gradient), its leaves taken
  as one vector: |program - reference| / |reference|.
- ``g_grad``: G's first gradient, taken alike, against the reference's
  on the program's own D after step 1 (the D that the program's G step
  saw: D's step is held by ``loss`` and ``grad``), from the weights, at
  step 1's latents: G's forward and backward through D, K1/K2 at G's
  shape included. Taken on the reference's own D instead, it would carry
  the rounding of D's gradient into G's through Adam's signs.
- ``change``: the change of each parameter, running statistic and EMA
  target leaf over the steps, the gap between the program's norm and the
  reference's over the larger of the leaf's and its group's median leaf;
  the median leaf.

Parameters whose reference first gradient is under a thousandth of their
model's median leaf's (a convolution's bias ahead of a train-mode
BatchNorm, whose gradient is 0 to rounding) are left out of all three
last: the program's gradient there is rounding noise, and Adam moves them
by round-off alone. A cell's limits are in ``limits/<workload>.json``.
"""
from __future__ import annotations

import statistics

import torch

NUMBERS = ("loss", "grad", "g_grad", "change")
TINY_GRAD = 1e-3


def _norms(tensors: dict) -> dict:
    return {n: float(t.double().norm()) for n, t in tensors.items()}


def leaf_gaps(prog: dict, ref: dict, names) -> dict:
    """name -> |norm(prog) - norm(ref)| / max(norm(ref), median norm(ref)
    over ``names``)."""
    p = _norms({n: prog[n] for n in names})
    r = _norms({n: ref[n] for n in names})
    med = statistics.median(r.values())
    return {n: abs(p[n] - r[n]) / max(r[n], med, 1e-30) for n in names}


def moved(ref_grads: dict) -> list:
    """The leaves whose reference gradient is not 0 to rounding."""
    r = _norms(ref_grads)
    med = statistics.median(r.values())
    return [n for n, v in r.items() if v >= TINY_GRAD * med]


def _median(values: dict) -> float:
    """The median, a NaN among them reading as the worst."""
    vals = [float("inf") if v != v else v for v in values.values()]
    return statistics.median(vals)


def gradient_gap(prog: dict, ref: dict) -> float:
    """|prog - ref| / |ref| over the leaves of ``ref`` that ``moved``,
    taken as one vector (NaN reads as infinite)."""
    names = moved(ref)
    diff = sum(float((prog[n].double() - ref[n].double()).square().sum())
               for n in names)
    whole = sum(float(ref[n].double().square().sum()) for n in names)
    gap = (diff / max(whole, 1e-300)) ** 0.5
    return float("inf") if gap != gap else gap


def change_leaves(prog: dict, ref: dict) -> dict:
    """Each compared leaf's gap of the norms of its change over the steps
    (``leaf_gaps`` within its ``change_groups`` group)."""
    out = {}
    for names in change_groups(ref).values():
        d_prog = {n: prog["after"][n] - prog["before"][n] for n in names}
        d_ref = {n: ref["after"][n] - ref["before"][n] for n in names}
        out.update(leaf_gaps(d_prog, d_ref, names))
    return out


def compare(prog: dict, ref: dict) -> dict:
    """The check's numbers. ``prog`` and ``ref`` hold ``losses`` (a list
    of dicts a step), ``grads`` ({"g": {name: tensor}, "d": ...}, the
    first step's), ``before`` and ``after`` ({key: tensor} of
    ``Trainer.state``'s names); ``ref`` also ``g_grads_on_prog``, its
    first G gradient on the program's D after step 1."""
    lp, lr = prog["losses"][0]["d_loss"], ref["losses"][0]["d_loss"]
    loss = abs(lp - lr) / max(abs(lr), 1e-30)
    return {"loss": float("inf") if loss != loss else loss,
            "grad": gradient_gap(prog["grads"]["d"], ref["grads"]["d"]),
            "g_grad": gradient_gap(prog["grads"]["g"],
                                   ref["g_grads_on_prog"]),
            "change": _median(change_leaves(prog, ref))}


def change_groups(ref: dict) -> dict:
    """{group: [state names]}: the parameters of G and D that moved, the
    EMA target's, and the running statistics, each compared against its
    own group's median."""
    groups = {"g": [], "d": [], "g_target": [], "stats": []}
    kept = {key: set(moved(ref["grads"][key])) for key in ("g", "d")}
    for name in ref["after"]:
        key, leaf = name.split(".", 1)
        if leaf.endswith(("running_mean", "running_var")):
            groups["stats"].append(name)
        elif leaf in kept["g" if key == "g_target" else key]:
            groups[key].append(name)
    return {k: v for k, v in groups.items() if v}


def judge(numbers: dict, limits: dict) -> bool:
    """Every number at or under its limit."""
    return all(numbers[k] <= limits[k] for k in NUMBERS)


def state_of(g, d, g_target) -> dict:
    """The program's modules as ``Trainer.state`` names them (float32
    copies)."""
    out = {}
    for key, model in (("g", g), ("d", d)):
        for name, t in model.state_dict().items():
            out[f"{key}.{name}"] = t.detach().float().clone()
    for name, t in g_target.named_parameters():
        out[f"g_target.{name}"] = t.detach().float().clone()
    return out


def first_grads(model, opt) -> dict:
    """name -> the gradient Adam took at its first step (its first moment
    with beta1 0); zeros where it holds no state."""
    out = {}
    for name, p in model.named_parameters():
        m = opt.state.get(p, {}).get("exp_avg")
        out[name] = (torch.zeros_like(p) if m is None else m).detach().clone()
    return out
