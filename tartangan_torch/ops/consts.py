"""Constant tensors made once per (key, dtype, device).

The parity packers (``ops/parity.py``) and the parity downsamplers
(``ops/resize.py``) multiply by small constant matrices built in numpy.
Copying such a matrix to the card on every call is a pageable
host-to-device copy, which PyTorch finishes with a stream synchronization:
the host then waits for everything queued before it. ``device_constant``
makes the tensor at the first call for its key and returns that same tensor
afterwards, so later calls neither copy nor synchronize. The JAX package
gets the same from ``jit``, which folds such constants into the program.
"""
from __future__ import annotations

import threading

import torch

_CACHE: dict = {}
_LOCK = threading.Lock()


def device_constant(key, make_numpy, dtype: torch.dtype,
                    device) -> torch.Tensor:
    """``make_numpy()`` as a ``dtype`` tensor on ``device``, made at the
    first call for (``key``, ``dtype``, ``device``) and the same object at
    every later one. Callers must not modify it. It never requires grad,
    and it is made outside inference mode, so autograd may save it for a
    backward (R1 differentiates the packers' einsums twice)."""
    full = (key, dtype, torch.device(device))
    with _LOCK:
        out = _CACHE.get(full)
        if out is None:
            with torch.inference_mode(False):
                out = torch.as_tensor(make_numpy(), dtype=dtype,
                                      device=device)
            _CACHE[full] = out
        return out
