"""Fused attention o = softmax(q k^T) v (unscaled), differentiable to any
order: the CUDA kernels ``csrc/attention_fwd.cu`` (K1) and
``csrc/attention_bwd.cu`` (K2), and their plain PyTorch versions.

Counterpart of ``tartangan_tpu/ops/pallas/attention.py``: the forward is
``_fused_attention_fwd_impl`` (kernel body ``_attn_kernel``), the backward
``_attn_bwd_impl`` (``_attn_bwd_kernel``) and its plain form
``_fused_attention_bwd_xla``. Layout is JAX's: q (B, Lq, Ck), k (B, Lk, Ck),
v (B, Lk, Cv) -> (B, Lq, Cv).

Gradients go through two ``torch.autograd.Function``s:

- ``_Attention``: forward is K1, backward is ``_AttentionBwd.apply``;
- ``_AttentionBwd``: forward is K2, backward is the vector-Jacobian
  product (``torch.func.vjp``) of ``attention_bwd_plain``, the closed form
  that ``_attn_bwd_core_bwd`` differentiates; so the R1 penalty's
  second-order gradient works, and any higher order at plain cost.

JAX needs three ``custom_vjp``s for the same (``fused_attention``,
``_fused_attention_l1``, ``_attn_bwd_core``): it linearizes a forward rule,
so the kernel call inside the rule needs a rule of its own. Torch records a
Function applied inside a backward run with ``create_graph=True`` like any
other op, so two are enough.

For CUDA tensors the wrappers launch the kernels or raise; for CPU tensors
the same two Functions run the plain versions, so the CPU tests exercise
the double-backward wiring itself. ``attention.launches`` and
``attention_bwd.launches`` count kernel launches.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import build

MAX_CK = 64   # widest q/k head the kernels instantiate
MAX_CV = 128  # widest v head the backward kernel instantiates
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_COUNT_LOCK = threading.Lock()


def attention_plain(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """The same math in plain torch ops: f32 logits, exact row softmax,
    p cast to v's dtype, f32 accumulation, output in q's dtype."""
    logits = torch.bmm(q.float(), k.float().transpose(1, 2))
    p = torch.softmax(logits, dim=-1)
    return torch.bmm(p.to(v.dtype).float(), v.float()).to(q.dtype)


def attention_bwd_plain(q, k, v, do):
    """(dq, dk, dv) of ``attention`` for the output cotangent ``do``, in
    plain torch ops (``_fused_attention_bwd_xla``): p recomputed in f32,
    ds = p * (dp - sum(dp * p)), outputs in the input dtypes."""
    p = torch.softmax(torch.bmm(q.float(), k.float().transpose(1, 2)), -1)
    do32 = do.float()
    dv = torch.bmm(p.transpose(1, 2), do32).to(v.dtype)
    dp = torch.bmm(do32, v.float().transpose(1, 2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.bmm(ds, k.float()).to(q.dtype)
    dk = torch.bmm(ds.transpose(1, 2), q.float()).to(k.dtype)
    return dq, dk, dv


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


def _check_kernel(name, *ts):
    """What both kernels take: CUDA, contiguous, Ck <= MAX_CK, B <= 65535."""
    q = ts[0]
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {q.device}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"the {name} kernel takes contiguous tensors")
    if q.shape[2] > MAX_CK:
        raise ValueError(f"the {name} kernel takes Ck <= {MAX_CK}, "
                         f"got {q.shape[2]}")
    if q.shape[0] > 65535:
        raise ValueError(f"the {name} kernel takes B <= 65535, "
                         f"got {q.shape[0]}")


def _count(fn):
    with _COUNT_LOCK:
        fn.launches += 1


def _fwd(q, k, v):
    """K1 for CUDA tensors, ``attention_plain`` for CPU tensors."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    _check_kernel("attention", q, k, v)
    b, lq, ck = q.shape
    lk, cv = v.shape[1], v.shape[2]
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
    _count(attention)
    return out


def _bwd(q, k, v, do):
    """K2 for CUDA tensors, ``attention_bwd_plain`` for CPU tensors."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, do)
    _check_kernel("attention_bwd", q, k, v, do)
    b, lq, ck = q.shape
    lk, cv = v.shape[1], v.shape[2]
    if cv > MAX_CV:
        raise ValueError(f"the attention_bwd kernel takes Cv <= {MAX_CV}, "
                         f"got {cv}")
    lib = build.load("attention_bwd")
    fn = lib.tt_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    stats = torch.empty((2, b, lq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 stats[0].data_ptr(), stats[1].data_ptr(),
                 b, lq, lk, ck, cv, _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"attention_bwd kernel launch failed: cudaError {err}")
    _count(attention_bwd)
    return dq, dk, dv


class _AttentionBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, do):
        ctx.save_for_backward(q, k, v, do)
        return _bwd(q, k, v, do)

    @staticmethod
    def backward(ctx, gdq, gdk, gdv):
        # the vector-Jacobian product of the closed form, itself
        # differentiable when the caller builds a graph (create_graph)
        _, vjp = torch.func.vjp(attention_bwd_plain, *ctx.saved_tensors)
        return vjp((gdq, gdk, gdv))


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _fwd(q, k, v)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return _AttentionBwd.apply(q, k, v, do.contiguous())


def attention(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T) v, differentiable: the CUDA kernels for CUDA tensors,
    the plain versions for CPU tensors."""
    _check(q, k, v)
    return _Attention.apply(q, k, v)


def attention_bwd(q, k, v, do):
    """(dq, dk, dv) of ``attention``, itself differentiable: K2 for CUDA
    tensors, the plain version for CPU tensors."""
    _check(q, k, v)
    if do.shape != (q.shape[0], q.shape[1], v.shape[2]) \
            or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"do must be {tuple(q.shape[:2]) + (v.shape[2],)} "
                         f"of {q.dtype} on {q.device}, got {tuple(do.shape)} "
                         f"of {do.dtype} on {do.device}")
    return _AttentionBwd.apply(q, k, v, do)


attention.launches = 0
attention_bwd.launches = 0
