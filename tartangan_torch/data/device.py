"""Device-resident dataset (``--device-data``): the uint8 archive on the
device, each step's batch gathered and cropped there.

Counterpart of ``tartangan_tpu/data/device.py:33-72``. The pre-resized
archive is copied to the device once; each step draws B rows uniformly
with replacement and a random crop offset per image, and gathers the crops
with plain torch indexing on the device: no host-to-device copy and no host
synchronization per step. An epoch keeps the host path's length,
``len(dataset) // batch_size`` steps. The JAX package does this outside
Pallas, so no kernel of its own is needed here.

The draw and the gather are two functions, so a caller (the K-step call's
CUDA graph, or a test holding the gather against the JAX sampler's output)
can make the draws outside the gather: ``draw`` takes an explicit device
``torch.Generator``; ``gather_crop`` is pure.
"""
from __future__ import annotations

import torch


def crop_size_of(archive_shape, crop_size: int | None) -> int:
    """The crop's side (the archive's height when ``crop_size`` is None);
    ``ValueError`` when it exceeds the archive's images."""
    _, h, w, _ = archive_shape
    s = crop_size or h
    if s > h or s > w:
        raise ValueError(f"crop size {s} exceeds archive images ({h}x{w})")
    return s


def draw(n: int, h: int, w: int, s: int, batch: int,
         generator: torch.Generator, k: int = 1):
    """Row indices (k, batch) in [0, n) and crop offsets ys in
    [0, h - s], xs in [0, w - s], int64 on the generator's device."""
    def randint(high):
        return torch.randint(0, high, (k, batch), generator=generator,
                             device=generator.device)
    return randint(n), randint(h - s + 1), randint(w - s + 1)


def gather_crop(archive: torch.Tensor, idx: torch.Tensor, ys: torch.Tensor,
                xs: torch.Tensor, s: int) -> torch.Tensor:
    """``archive[idx[i], ys[i]:ys[i] + s, xs[i]:xs[i] + s]`` for each i:
    uint8 (B, s, s, C) from an (N, H, W, C) archive and (B,) indices."""
    _, h, w, _ = archive.shape
    if h == s and w == s:
        return archive[idx]
    r = torch.arange(s, device=archive.device)
    rows = (ys[:, None] + r)[:, :, None]
    cols = (xs[:, None] + r)[:, None, :]
    return archive[idx[:, None, None], rows, cols]


def wrap_step_with_device_data(train_step, s: int):
    """A ``(state, batch_u8, z_d, z_g, **extra)`` step -> ``(state,
    archive, z_d, z_g, idx, ys, xs, **extra)``, which gathers its batch
    from the archive on the device first; ``extra`` (the IQN step's taus)
    passes through."""
    def device_step(state, archive, z_d, z_g, idx, ys, xs, **extra):
        return train_step(state, gather_crop(archive, idx, ys, xs, s),
                          z_d, z_g, **extra)
    return device_step
