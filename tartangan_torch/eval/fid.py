"""FID and Inception Score math.

Counterpart of ``tartangan_tpu/eval/fid.py`` (reference
inception_utils.py): the Newton-Schulz matrix square root (20 iterations,
:129-144, :232) and the Frechet distance on the device in float32, the
float64 ``eigh`` form on the host as the fallback (:149-202), and the
split-KL Inception Score (:239-246).

The device products must be IEEE float32 (``utils/precision.py::
full_float32``): TF32 keeps ten mantissa bits, and the trace of a 2048-dim
square root taken through 40 products would move by far more than FID's
noise.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

logger = logging.getLogger(__name__)


def sqrt_newton_schulz(a: torch.Tensor, num_iters: int = 20) -> torch.Tensor:
    """Matrix square root of a (single) PSD matrix by Newton-Schulz, in
    float32 on ``a``'s device."""
    a = a.float()
    norm_a = torch.sqrt(torch.sum(a * a))
    y = a / norm_a
    eye = torch.eye(a.shape[0], dtype=torch.float32, device=a.device)
    z = eye
    for _ in range(num_iters):
        t = 0.5 * (3.0 * eye - z @ y)
        y, z = y @ t, t @ z
    return y * torch.sqrt(norm_a)


def frechet_distance(mu1, sigma1, mu2, sigma2) -> torch.Tensor:
    """d^2 = ||mu1 - mu2||^2 + Tr(s1 + s2 - 2 sqrt(s1 s2)) in float32, a
    0-d tensor on the inputs' device (reference inception_utils.py:205-235)."""
    mu1, mu2, sigma1, sigma2 = (t.float() for t in (mu1, mu2, sigma1, sigma2))
    diff = mu1 - mu2
    covmean = sqrt_newton_schulz(sigma1 @ sigma2, 20)
    return (diff @ diff + torch.trace(sigma1) + torch.trace(sigma2)
            - 2.0 * torch.trace(covmean))


def numpy_frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6):
    """Float64 host form of the Frechet distance (the JAX package's
    ``numpy_frechet_distance``): the trace of the square root through the
    symmetric form ``tr sqrt(S1 S2) = tr sqrt(R2 S1 R2)``, ``R2 =
    sqrt(S2)``, both by ``eigh`` with negative eigenvalues clipped; the
    eps offset only as a retry for materially indefinite inputs (relative
    to the spectrum's scale); the result clamped at 0."""
    mu1 = np.atleast_1d(np.asarray(mu1, np.float64))
    mu2 = np.atleast_1d(np.asarray(mu2, np.float64))
    sigma1 = np.atleast_2d(np.asarray(sigma1, np.float64))
    sigma2 = np.atleast_2d(np.asarray(sigma2, np.float64))

    def _psd_sqrt(m):
        vals, vecs = np.linalg.eigh((m + m.T) / 2.0)
        vals = np.sqrt(np.clip(vals, 0.0, None))
        return (vecs * vals) @ vecs.T

    def _tr_sqrt(s1, s2):
        r2 = _psd_sqrt(s2)
        inner = r2 @ s1 @ r2
        vals = np.linalg.eigvalsh((inner + inner.T) / 2.0)
        return (float(np.sum(np.sqrt(np.clip(vals, 0.0, None)))),
                float(vals.min(initial=0.0)),
                float(np.abs(vals).max(initial=0.0)))

    tr_covmean, min_eig, scale = _tr_sqrt(sigma1, sigma2)
    if min_eig < -1e-6 * max(scale, np.finfo(np.float64).tiny):
        logger.info(
            "FID sqrtm retry with eps=%g offset (min eigenvalue %.3g)",
            eps, min_eig)
        eye = np.eye(sigma1.shape[0])
        tr_covmean, _, _ = _tr_sqrt(sigma1 + eye * eps, sigma2 + eye * eps)
    diff = mu1 - mu2
    value = float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                  - 2.0 * tr_covmean)
    if value < 0:
        logger.info(
            "FID clamped to 0 (raw %.4g: below numerical resolution — "
            "distributions match to within noise)", value)
        value = 0.0
    return value


def inception_score(probs: np.ndarray, num_splits: int = 10):
    """Split-KL Inception Score over softmax rows (reference
    inception_utils.py:239-246), probabilities floored at 1e-16 so that a
    float32 softmax's exact zeros give no nan."""
    scores = []
    chunk = probs.shape[0] // num_splits
    eps = np.float64(1e-16)
    for index in range(num_splits):
        part = np.maximum(probs[index * chunk:(index + 1) * chunk], eps)
        kl = part * (np.log(part) - np.log(np.mean(part, axis=0, keepdims=True)))
        scores.append(np.exp(np.mean(np.sum(kl, axis=1))))
    return float(np.mean(scores)), float(np.std(scores))


def robust_frechet(mu, sigma, data_mu, data_sigma, device="cuda"):
    """FID by Newton-Schulz on ``device``, falling back to the float64
    host form when the float32 iteration fails: a non-finite or a
    negative distance (the squared distance is nonnegative), as
    rank-deficient covariances (2048 activations or fewer) give."""
    fid = float(frechet_distance(
        *(torch.as_tensor(a, device=device)
          for a in (mu, sigma, data_mu, data_sigma))))
    if not np.isfinite(fid) or fid < 0:
        fid = numpy_frechet_distance(mu, sigma, data_mu, data_sigma)
    return fid


def prepare_inception_metrics(moments_path, device="cuda", weights=None):
    """Load the dataset moments and return ``get_inception_metrics(
    sample_fn, num_inception_images, num_splits=10)`` -> (IS mean, IS std,
    FID) (reference inception_utils.py:285-328), with the network on
    ``device``; ``weights`` optionally names a ported Inception-weights
    npz. The JAX package's ``no_fid``, ``prints`` and ``use_jax`` options
    and its mesh have no caller here and are left out."""
    from ..utils.fs import smart_open
    from .inception import InceptionWrapper, accumulate_activations

    with smart_open(moments_path, "rb") as infile:
        data = np.load(infile)
        data_mu = np.asarray(data["mu"])
        data_sigma = np.asarray(data["sigma"])
    net = InceptionWrapper(weights=weights, device=device)

    def get_inception_metrics(sample_fn, num_inception_images,
                              num_splits=10):
        probs, mu, sigma = accumulate_activations(
            sample_fn, net, num_inception_images)
        is_mean, is_std = inception_score(probs, num_splits)
        fid = robust_frechet(mu, sigma, data_mu, data_sigma, device)
        return is_mean, is_std, fid

    return get_inception_metrics
