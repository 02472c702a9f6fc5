"""Offline dataset Inception-moments CLI.

Counterpart of ``tartangan_tpu/eval/moments.py`` (reference
calculate_inception_moments.py): the dataset's Inception pool activations'
mu and sigma, and its IS, saved as an npz that ``--inception-moments``
reads. Usage:

    python -m tartangan_torch.eval.moments DATASET OUT.npz [--batch-size N]
        [--inception-weights W.npz] [--device cuda|cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from ..data.image_bytes import ImageBytesDataset
from ..utils.fs import smart_open
from ..utils.precision import full_float32
from .fid import inception_score
from .inception import InceptionWrapper, accumulate_activations


def calculate_inception_moments(dataset, net, batch_size=32, quiet=False):
    """(mu, sigma) of the dataset's Inception pool activations through
    ``net`` (an ``InceptionWrapper``); prints the dataset IS (reference
    calculate_inception_moments.py:28-55). The batches are those of the JAX
    package's CLI (shuffled with seed 0); each goes to the network's device
    as uint8 and is scaled to [-1, 1] there."""
    rng = np.random.default_rng(0)
    n = len(dataset)
    order = rng.permutation(n)
    num_batches = n // batch_size
    pos = {"i": 0}

    def sample_fn():
        i = pos["i"] % num_batches
        pos["i"] += 1
        idx = order[i * batch_size:(i + 1) * batch_size]
        u8 = torch.from_numpy(dataset.batch(idx, rng)).to(net.device)
        return u8.permute(0, 3, 1, 2).float() / 127.5 - 1.0

    total = num_batches * batch_size
    if total <= 2048 and not quiet:
        print(f"WARNING: only {total} activations — the 2048-dim pool "
              "covariance is rank-deficient; FID against these moments "
              "leans on the eps-offset fallback (use > 2048 images for "
              "trustworthy numbers)")
    probs, mu, sigma = accumulate_activations(sample_fn, net, total)
    if not quiet:
        is_mean, is_std = inception_score(probs)
        print("Training data from dataset has IS of "
              f"{is_mean:.5f} +/- {is_std:.5f}")
    return mu, sigma


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="Calculate Inception moments of a dataset.")
    p.add_argument("source", help="Root path of dataset (npz archive)")
    p.add_argument("destination", help="Output npz location")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--quiet-logs", action="store_true")
    p.add_argument("--inception-weights", default=None,
                   help="Ported Inception-weights npz (see "
                        "tartangan_torch.eval.port_weights); falls back to "
                        "$TARTANGAN_INCEPTION_WEIGHTS")
    p.add_argument("--device", default="cuda",
                   help="torch device of the network (cuda or cpu)")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available; "
                           "pass --device cpu to run on the CPU")
    full_float32()
    print(f"Loading dataset from {args.source}")
    dataset = ImageBytesDataset.from_path(args.source)
    net = InceptionWrapper(weights=args.inception_weights, device=device)
    if not net.pretrained:
        print("WARNING: no pretrained Inception weights — the moments below "
              "come from a random-init network and are not comparable to "
              "published FID numbers")
    mu, sigma = calculate_inception_moments(
        dataset, net, batch_size=args.batch_size, quiet=args.quiet_logs)
    print(f'Saving calculated means and covariances to "{args.destination}"')
    with smart_open(args.destination, "wb") as outfile:
        np.savez(outfile, mu=mu, sigma=sigma)


if __name__ == "__main__":
    main()
