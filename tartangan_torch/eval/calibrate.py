"""Data-dependent calibration of the surrogate InceptionV3's BatchNorm
statistics.

Counterpart of ``tartangan_tpu/eval/calibrate.py``, with the same CLI and
the same output. Without torchvision's pretrained weights the FID network
is the seed-0 template (``models/inception.py::init_inception``), whose
activations collapse or blow up through 94 random conv + BN + ReLU
layers. This sets every BatchNorm's running statistics to the moments of
its conv's output on a reference image set, one dependency level at a
time (``_bn_levels``): round r measures the convs of level r, whose
upstream statistics are all final, so every written statistic is exact
under the final weights. The weights stay random.

Forward hooks on the convs (``BasicConv2d.conv``) take the place of flax's
``capture_intermediates``; each conv's sibling BatchNorm is named by the
JAX package's variable path, from ``torch_key_map``, so that the levels
are computed from the same names and the output npz has the JAX
package's flat keys (``batch_stats.<module path>.{mean,var}``): it loads
in both packages' ``load_weights_npz`` and wherever
``--inception-weights`` is taken.

CLI:
  python -m tartangan_torch.eval.calibrate DATA.npz OUT.npz \\
      [--rounds N] [--batch-size 16] [--seed 0] [--validate] \\
      [--validate-n 2048] [--device cuda|cpu]

``--validate`` prints the three-way check: FID between two disjoint halves
of the set, against a blurred copy and against uniform noise (a usable
surrogate orders them holdout < blurred < noise), with Inception on the
device and the distance from ``eval/fid.py``.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from ..models.inception import (
    BasicConv2d,
    init_inception,
    torch_key_map,
)
from ..ops.resize import resize_bilinear
from .inception import VGG_MEAN, VGG_STD


def _prep_batch(u8, size=299, device="cpu"):
    """uint8 (B, H, W, 3) -> the wrapper's VGG-normalized float32 NCHW
    batch at ``size`` (bilinear, align_corners)."""
    x = torch.from_numpy(np.ascontiguousarray(u8)).to(device)
    x = x.permute(0, 3, 1, 2).float() / 255.0
    mean = torch.from_numpy(VGG_MEAN).to(device).reshape(1, 3, 1, 1)
    std = torch.from_numpy(VGG_STD).to(device).reshape(1, 3, 1, 1)
    return resize_bilinear((x - mean) / std, size, size, align_corners=True)


def bn_paths(model) -> dict:
    """torch BatchNorm module name -> its JAX variable path (a tuple, the
    ``batch_stats`` tree's path without the leaf), from ``torch_key_map``."""
    out = {}
    for flax_key, torch_key in torch_key_map(model).items():
        parts = flax_key.split(".")
        if parts[0] == "batch_stats" and parts[-1] == "mean":
            out[torch_key.rsplit(".", 1)[0]] = tuple(parts[1:-1])
    return out


def conv_outputs(model, x):
    """[(the sibling BatchNorm's JAX path, the conv's output)] in call
    order, from forward hooks on every ``BasicConv2d``'s conv."""
    paths = bn_paths(model)
    captured, hooks = [], []
    for name, mod in model.named_modules():
        if isinstance(mod, BasicConv2d):
            path = paths[f"{name}.bn"]
            hooks.append(mod.conv.register_forward_hook(
                lambda _m, _i, y, path=path: captured.append((path, y))))
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return captured


def _bn_levels(order):
    """Topological level of each BatchNorm path (level-k statistics are
    exact once every level below k is final), from InceptionV3's names, as
    the JAX package derives them: the stem convs are sequential; within a
    Mixed block the branches are parallel chains whose position is the
    trailing ``_<n><a|b>?`` tag (``branch1x1`` and ``branch_pool`` are
    position 1, ``branch3x3dbl_3a`` and ``_3b`` both position 3), and each
    block stacks on the previous block's deepest chain."""
    levels = {}
    base = 0
    cur_block = None
    block_max = 0
    for path in order:
        top = path[0]
        if top.startswith("Conv2d"):  # sequential stem
            base += 1
            levels[path] = base
            cur_block, block_max = None, 0
            continue
        if top != cur_block:  # a new Mixed block
            base += block_max
            cur_block, block_max = top, 0
        m = re.search(r"_(\d+)[ab]?$", path[1])
        local = int(m.group(1)) if m else 1
        block_max = max(block_max, local)
        levels[path] = base + local
    return levels


def _scaled_moments(y):
    """Per-channel (mean, variance, scale) of NCHW ``y`` divided by its
    per-channel max-abs (at least 1), so the moments of a tensor far off
    scale stay inside float32; the caller rebuilds them in float64."""
    y32 = y.float()
    s = y32.abs().amax(dim=(0, 2, 3)).clamp(min=1.0)
    yn = y32 / s[None, :, None, None]
    mn = yn.mean(dim=(0, 2, 3))
    vn = yn.square().mean(dim=(0, 2, 3)) - mn.square()
    return mn, vn, s


@torch.no_grad()
def calibrate_variables(images_u8, rounds=None, batch_size=8, seed=0,
                        var_floor=1e-3, device="cpu"):
    """The template network (on ``device``) with calibrated BatchNorm
    statistics, level by level: round r draws ``batch_size`` images
    (``np.random.default_rng(seed)``, without replacement, as the JAX
    package draws them), forwards them and writes the statistics of the
    level-r BatchNorms only; a non-finite moment (a layer whose input
    overflowed before its upstream was calibrated) is skipped. ``rounds``
    caps the levels (None: all, about 47)."""
    model = init_inception().to(device)
    rng = np.random.default_rng(seed)
    f32_cap = np.float64(1e37)
    modules = dict(model.named_modules())
    by_path = {path: modules[name] for name, path in bn_paths(model).items()}
    order = [p for p, _ in conv_outputs(
        model, _prep_batch(images_u8[:1], device=device))]
    levels = _bn_levels(order)
    level_list = sorted(set(levels.values()))
    if rounds is not None:
        level_list = level_list[:rounds]
    for lv in level_list:
        active = {p for p, plv in levels.items() if plv == lv}
        idx = rng.choice(len(images_u8), size=batch_size, replace=False)
        x = _prep_batch(images_u8[idx], device=device)
        for path, y in conv_outputs(model, x):
            if path not in active:
                continue  # upstream levels are final, later ones wait
            mn, vn, s = (t.double().cpu().numpy()
                         for t in _scaled_moments(y))
            m, v = mn * s, vn * s * s
            if not (np.isfinite(m).all() and np.isfinite(v).all()):
                continue
            bn = by_path[path]
            bn.running_mean.copy_(torch.from_numpy(
                np.clip(m, -f32_cap, f32_cap).astype(np.float32)))
            bn.running_var.copy_(torch.from_numpy(
                np.clip(v, var_floor, f32_cap).astype(np.float32)))
    return model


def save_stats_npz(model, path) -> None:
    """Only the BatchNorm statistics, under the JAX package's flat keys
    (``batch_stats.<path>.mean``/``.var``): the weights are the
    deterministic template. ``load_weights_npz`` takes the stats-only
    archive."""
    state = model.state_dict()
    np.savez(path, **{k: state[t].detach().cpu().numpy()
                      for k, t in torch_key_map(model).items()
                      if k.startswith("batch_stats.")})


def _pool_features(net, images_u8, batch_size=64):
    """pool features of a uint8 set through an ``InceptionWrapper``, full
    batches only."""
    feats = []
    n = (len(images_u8) // batch_size) * batch_size
    for i in range(0, n, batch_size):
        x = torch.from_numpy(images_u8[i:i + batch_size]).to(net.device)
        pool, _ = net(x.permute(0, 3, 1, 2).float() / 127.5 - 1.0)
        feats.append(pool.cpu().numpy())
    return np.concatenate(feats, axis=0)


def fid_between(net, a_u8, b_u8, batch_size=64):
    from .fid import numpy_frechet_distance
    fa = _pool_features(net, a_u8, batch_size)
    fb = _pool_features(net, b_u8, batch_size)
    return float(numpy_frechet_distance(
        fa.mean(0), np.cov(fa, rowvar=False),
        fb.mean(0), np.cov(fb, rowvar=False)))


def validate_weights(weights_path, images_u8, n=2048, batch_size=64,
                     seed=0, device="cpu"):
    """The three-way check; returns the FIDs and whether they are
    ordered (the JAX package's ``validate_weights``)."""
    from scipy.ndimage import uniform_filter

    from .inception import InceptionWrapper
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(images_u8))
    half = min(n, len(images_u8) // 2)
    a = images_u8[idx[:half]]
    b = images_u8[idx[half:2 * half]]
    blurred = uniform_filter(
        a.astype(np.float32), size=(1, 5, 5, 1)).astype(np.uint8)
    noise = rng.integers(0, 256, a.shape, dtype=np.uint8)
    net = InceptionWrapper(weights=weights_path, device=device)
    out = {
        "fid_holdout": fid_between(net, a, b, batch_size),
        "fid_blurred": fid_between(net, a, blurred, batch_size),
        "fid_noise": fid_between(net, a, noise, batch_size),
    }
    out["ordered"] = (out["fid_holdout"] < out["fid_blurred"]
                      < out["fid_noise"])
    return out


def main(argv=None):
    import argparse

    from ..utils.fs import smart_open
    from ..utils.precision import full_float32

    p = argparse.ArgumentParser(
        description="Calibrate surrogate Inception weights on an image "
                    "archive (BN running stats <- data moments).")
    p.add_argument("dataset", help="npz archive with an 'images' array")
    p.add_argument("destination", help="output weights npz")
    p.add_argument("--rounds", type=int, default=None,
                   help="cap the number of levels calibrated (default: "
                        "all of them)")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--validate", action="store_true",
                   help="run the three-way discriminativeness check on "
                        "the calibrated weights")
    p.add_argument("--validate-n", type=int, default=2048)
    p.add_argument("--device", default="cuda",
                   help="torch device for Inception (cuda or cpu)")
    args = p.parse_args(argv)

    full_float32()
    with smart_open(args.dataset, "rb") as f:
        images = np.load(f)["images"]
    model = calibrate_variables(images, rounds=args.rounds,
                                batch_size=args.batch_size, seed=args.seed,
                                device=args.device)
    save_stats_npz(model, args.destination)
    print(f"calibrated BN stats (levels) -> {args.destination}")
    if args.validate:
        checks = validate_weights(args.destination, images,
                                  n=args.validate_n, device=args.device)
        print("discriminativeness:", checks)
        return checks
    return None


if __name__ == "__main__":
    main()
