"""Inception wrapper and activation accumulation for FID and IS.

Counterpart of ``tartangan_tpu/eval/inception.py`` (reference
inception_utils.py:35-92 and :249-268): images in [-1, 1] are mapped to the
VGG statistics, resized to 299 (bilinear, align_corners=True) and run
through InceptionV3, which gives the pool features and the softmax.

The moments stream on the device: float32 sums of the pool features and of
``pool.T @ pool``, and the softmax rows, stay there until one readback after
the last batch; the mean and the unbiased covariance are then formed in
float64 on the host. A sample function that returns tensors on the card
(the trainer's G samples) thus never sends an image to the host.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.inception import init_inception, resolve_pretrained
from ..ops import consts
from ..ops.resize import resize_bilinear

VGG_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
VGG_STD = np.array([0.229, 0.224, 0.225], np.float32)


class InceptionWrapper:
    """Callable (B, 3, H, W) tensor in [-1, 1] -> (pool (B, 2048) float32,
    softmax (B, 1000)), on ``device``. Images elsewhere are moved there;
    any float dtype is cast to float32 once.

    ``weights`` names a ported-weights npz (``tartangan_torch.eval.
    port_weights``); without it the TARTANGAN_INCEPTION_WEIGHTS variable
    and an installed torchvision are tried before the seed-0 template is
    kept (``self.pretrained`` says which: FID from the template is not
    comparable to published numbers).
    """

    def __init__(self, weights: str | None = None, device="cuda"):
        self.device = torch.device(device)
        model, self.pretrained = resolve_pretrained(init_inception(), weights)
        self.model = model.to(self.device)

    def __call__(self, images: torch.Tensor):
        x = images.to(self.device, torch.float32)
        mean = _channel_constant("vgg_mean", VGG_MEAN, self.device)
        std = _channel_constant("vgg_std", VGG_STD, self.device)
        with torch.no_grad():
            x = ((x + 1.0) / 2.0 - mean) / std
            x = resize_bilinear(x, 299, 299, align_corners=True)
            pool, logits = self.model(x)
            return pool, torch.softmax(logits, dim=-1)


def _channel_constant(key, values, device):
    """(3, 1, 1) float32 on ``device``, copied from the host once
    (``ops/consts.py``)."""
    return consts.device_constant(key, lambda: values.reshape(3, 1, 1),
                                  torch.float32, device)


def stream_activations(sample_fn, net, num_images: int):
    """Run ``sample_fn()`` batches through ``net`` until ``num_images``
    activations are gathered. Returns device tensors (softmax rows (N,
    1000), sum of pool (P,), sum of pool.T @ pool (P, P), both float32)
    and N, with no host synchronization of its own."""
    probs, n = [], 0
    sum_x = sum_xxt = None
    while n < num_images:
        images = sample_fn()
        pool, p = net(images)
        if sum_x is None:
            sum_x = torch.zeros(pool.shape[-1], device=pool.device)
            sum_xxt = torch.zeros(pool.shape[-1], pool.shape[-1],
                                  device=pool.device)
        sum_x += pool.sum(0)
        sum_xxt.addmm_(pool.T, pool)
        probs.append(p)
        n += images.shape[0]
    return torch.cat(probs), sum_x, sum_xxt, n


def finish_moments(probs, sum_x, sum_xxt, n):
    """The one readback: (softmax rows as numpy, mu (P,), sigma (P, P)),
    the moments in float64 with the unbiased covariance (np.cov's
    1 / (n - 1))."""
    probs = probs.cpu().numpy()
    sum_x = sum_x.cpu().numpy().astype(np.float64)
    sum_xxt = sum_xxt.cpu().numpy().astype(np.float64)
    mu = sum_x / n
    sigma = (sum_xxt - n * np.outer(mu, mu)) / max(n - 1, 1)
    return probs, mu, sigma


def accumulate_activations(sample_fn, net, num_images: int):
    """(softmax rows (N, 1000), mu (P,), sigma (P, P)) over ``num_images``
    activations of ``sample_fn()`` batches (the JAX package's
    ``accumulate_activations``)."""
    return finish_moments(*stream_activations(sample_fn, net, num_images))
