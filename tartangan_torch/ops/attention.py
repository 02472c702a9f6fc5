"""Fused attention forward o = softmax(q k^T) v (unscaled): the CUDA kernel
``csrc/attention_fwd.cu`` and its plain PyTorch version.

Counterpart of ``tartangan_tpu/ops/pallas/attention.py::_fused_attention_fwd_impl``
(kernel body ``_attn_kernel``). Layout is JAX's: q (B, Lq, Ck),
k (B, Lk, Ck), v (B, Lk, Cv) -> (B, Lq, Cv).

``attention`` launches the kernel for CUDA tensors and raises if it cannot;
for CPU tensors it computes ``attention_plain``. ``attention.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import build

MAX_CK = 64  # widest q/k head the kernel instantiates
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_COUNT_LOCK = threading.Lock()


def attention_plain(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """The same math in plain torch ops: f32 logits, exact row softmax,
    p cast to v's dtype, f32 accumulation, output in q's dtype."""
    logits = torch.bmm(q.float(), k.float().transpose(1, 2))
    p = torch.softmax(logits, dim=-1)
    return torch.bmm(p.to(v.dtype).float(), v.float()).to(q.dtype)


def _check(q, k, v):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("attention takes (B, L, C) tensors, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, ck = q.shape
    if k.shape[0] != b or v.shape[0] != b or k.shape[2] != ck \
            or v.shape[1] != k.shape[1]:
        raise ValueError("attention shapes disagree: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if min(q.shape[1], k.shape[1], ck, v.shape[2], b) < 1:
        raise ValueError("attention needs non-empty tensors")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError("attention takes float32 or bfloat16 q/k/v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")


def attention(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T) v: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"attention runs on cuda or cpu, not {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the attention kernel takes contiguous q/k/v")
    b, lq, ck = q.shape
    lk, cv = v.shape[1], v.shape[2]
    if ck > MAX_CK:
        raise ValueError(f"the attention kernel takes Ck <= {MAX_CK}, got {ck}")
    if b > 65535:
        raise ValueError(f"the attention kernel takes B <= 65535, got {b}")
    lib = build.load("attention_fwd")
    fn = lib.tt_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((b, lq, cv), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, lq, lk, ck, cv, _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"attention_fwd kernel launch failed: cudaError {err}")
    with _COUNT_LOCK:
        attention.launches += 1
    return out


attention.launches = 0
