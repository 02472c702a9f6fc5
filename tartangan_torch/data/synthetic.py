"""Synthetic tartan-pattern dataset generator.

A copy of ``tartangan_tpu/data/synthetic.py`` (numpy only): a tartan is a
sett (stripe color/width sequence) repeated horizontally and vertically
with the perpendicular overlay blended like woven cloth (twill). A
stand-in for the scraped tartan images of the reference, with similar
statistics (axis-aligned stripes, limited palettes); the same seed gives
the same archive as the JAX package's generator.

CLI: python -m tartangan_torch.data.synthetic OUT.npz --num 2048 --size 64
"""
from __future__ import annotations

import numpy as np


def _random_sett(rng, max_colors=5):
    n_colors = rng.integers(2, max_colors + 1)
    palette = rng.integers(0, 256, size=(n_colors, 3)).astype(np.float32)
    n_stripes = rng.integers(3, 9)
    colors = rng.integers(0, n_colors, size=n_stripes)
    widths = rng.integers(2, 13, size=n_stripes)
    return palette[colors], widths


def tartan_image(rng, size: int) -> np.ndarray:
    """One (size, size, 3) uint8 tartan."""
    colors, widths = _random_sett(rng)
    # symmetric sett: mirror the stripe sequence (traditional tartans)
    colors = np.concatenate([colors, colors[::-1]], axis=0)
    widths = np.concatenate([widths, widths[::-1]], axis=0)
    stripe_of = np.repeat(np.arange(len(widths)), widths)
    period = len(stripe_of)
    idx = np.arange(size) % period
    warp = colors[stripe_of[idx]]         # (size, 3) column colors
    weft = warp.copy()                    # same sett both directions

    # twill weave: alternate which thread is on top along diagonals
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    over = ((yy + xx) // 2) % 2           # 2-thread twill diagonal
    img = np.where(over[..., None] == 0, warp[None, :, :],
                   weft[:, None, :])
    # slight blend to mimic thread mixing
    blend = 0.25
    mixed = (1 - blend) * img + blend * (warp[None, :, :] / 2
                                         + weft[:, None, :] / 2)
    return np.clip(mixed, 0, 255).astype(np.uint8)


def make_archive(num: int, size: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([tartan_image(rng, size) for _ in range(num)])


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="Generate a synthetic tartan image archive.")
    p.add_argument("destination")
    p.add_argument("--num", type=int, default=2048)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    data = make_archive(args.num, args.size, args.seed)
    np.savez_compressed(args.destination, images=data)
    print(f"wrote {data.shape} archive to {args.destination}")


if __name__ == "__main__":
    main()
