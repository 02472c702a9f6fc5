"""Fused attention o = softmax(q k^T) v (unscaled), differentiable to any
order: the CUDA kernels ``csrc/attention_fwd.cu`` (K1) and
``csrc/attention_bwd.cu`` (K2), and their plain PyTorch versions.

Counterpart of ``tartangan_tpu/ops/pallas/attention.py``: the forward is
``_fused_attention_fwd_impl`` (kernel body ``_attn_kernel``), the backward
``_attn_bwd_impl`` (``_attn_bwd_kernel``) and its plain form
``_fused_attention_bwd_xla``. Layout is JAX's: q (B, Lq, Ck), k (B, Lk, Ck),
v (B, Lk, Cv) -> (B, Lq, Cv).

Gradients go through two ``torch.autograd.Function``s:

- ``_Attention``: forward is K1, which also stores each row's log-sum-exp
  (lse, (B, Lq) f32 in the log2 domain); it saves q, k, v, o and lse, and
  its backward is ``_AttentionBwd.apply(q, k, v, do, o, lse)``;
- ``_AttentionBwd``: forward is K2, which takes p from lse and
  delta = do . o once a row, so it never sweeps the keys to rebuild them
  (its dq pass corrects delta to the one consistent with its p, where
  ``delta_fixed``);
  backward is the vector-Jacobian product (``torch.func.vjp``) of
  ``attention_bwd_plain``, the closed form that ``_attn_bwd_core_bwd``
  differentiates; so the R1 penalty's second-order gradient works, and any
  higher order at plain cost.

JAX needs three ``custom_vjp``s for the same (``fused_attention``,
``_fused_attention_l1``, ``_attn_bwd_core``): it linearizes a forward rule,
so the kernel call inside the rule needs a rule of its own. Torch records a
Function applied inside a backward run with ``create_graph=True`` like any
other op, so two are enough.

Outside autograd (no input requires a gradient, or grad mode is off, as
when serving) ``attention`` calls the custom op ``torch.ops.tartangan.
attention``: its CUDA implementation launches K1 without the lse store,
its CPU implementation is ``attention_plain``, and its fake implementation
gives the output's shape, so ``torch.export`` records the op by name
(``export/web.py``) and a loaded program launches K1 when it runs on the
card. The public ``attention_bwd(q, k, v, do)`` runs K1 for (o, lse) and
then K2.

For CUDA tensors the wrappers launch the kernels or raise; for CPU tensors
the same code runs the plain versions (``attention_plain`` with
``attention_lse_plain``, and ``attention_bwd_from_stats_plain``, K2's own
math from o and lse), so the CPU tests exercise the wiring itself.
``attention.launches`` and ``attention_bwd.launches`` count kernel
launches (one per call of either kernel; K2's three launches count once).
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from . import build

MAX_CK = 64   # widest q/k head the kernels instantiate
MAX_CV = 128  # widest v head the backward kernel instantiates
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_COUNT_LOCK = threading.Lock()
LOG2E = 1.0 / math.log(2.0)


def attention_plain(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """The same math in plain torch ops: f32 logits, exact row softmax,
    p cast to v's dtype, f32 accumulation, output in q's dtype."""
    logits = torch.bmm(q.float(), k.float().transpose(1, 2))
    p = torch.softmax(logits, dim=-1)
    return torch.bmm(p.to(v.dtype).float(), v.float()).to(q.dtype)


def attention_lse_plain(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Each row's log-sum-exp of the f32 logits in the log2 domain, as K1
    stores it: (B, Lq) f32."""
    logits = torch.bmm(q.float(), k.float().transpose(1, 2))
    return torch.logsumexp(logits, -1) * LOG2E


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


def delta_fixed(ck: int, cv: int) -> bool:
    """Whether K2's dq pass replaces delta = do . o by the delta consistent
    with its own p (its narrow-head instance, Ck <= 8 and Cv <= 32, whose
    key rows run longest: ``csrc/attention_bwd.cu`` dq_kernel)."""
    return ck <= 8 and cv <= 32


def attention_bwd_from_stats_plain(q, k, v, do, o, lse):
    """(dq, dk, dv) as K2 computes them, in plain torch ops: p from the
    forward's lse (log2 domain) and delta = do . o once a row, all in f32;
    outputs in the input dtypes. Where ``delta_fixed``, dq takes delta as
    sum(p dp) / sum(p) instead, as the kernel's dq pass does."""
    q32, k32, do32 = q.float(), k.float(), do.float()
    s2 = torch.bmm(q32, k32.transpose(1, 2)) * LOG2E
    p = torch.exp2(s2 - lse.unsqueeze(-1))
    delta = (do32 * o.float()).sum(-1, keepdim=True)
    dv = torch.bmm(p.transpose(1, 2), do32).to(v.dtype)
    ds = p * (torch.bmm(do32, v.float().transpose(1, 2)) - delta)
    dq = torch.bmm(ds, k32)
    if delta_fixed(q.shape[2], v.shape[2]):
        fix = ds.sum(-1, keepdim=True) / p.sum(-1, keepdim=True)
        dq = dq - fix * torch.bmm(p, k32)
    dk = torch.bmm(ds.transpose(1, 2), q32).to(k.dtype)
    return dq.to(q.dtype), dk, dv


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


def _count(fn, dtype):
    """One launch of ``fn``'s kernel, in ``dtype``: ``fn.launches`` counts
    them all, ``fn.launches_by_dtype`` each dtype's."""
    with _COUNT_LOCK:
        fn.launches += 1
        fn.launches_by_dtype[dtype] = fn.launches_by_dtype.get(dtype, 0) + 1


def _fwd(q, k, v, with_lse):
    """(o, lse): K1 for CUDA tensors, ``attention_plain`` (and
    ``attention_lse_plain``) for CPU tensors; lse is None unless
    ``with_lse``."""
    if q.device.type == "cpu":
        return (attention_plain(q, k, v),
                attention_lse_plain(q, k) if with_lse else None)
    _check_kernel("attention", q, k, v)
    b, lq, ck = q.shape
    lk, cv = v.shape[1], v.shape[2]
    lib = build.load("attention_fwd")
    fn = lib.tt_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((b, lq, cv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, lq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 b, lq, lk, ck, cv, _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"attention_fwd kernel launch failed: cudaError {err}")
    _count(attention, q.dtype)
    return out, lse


def _bwd(q, k, v, do, o, lse):
    """K2 for CUDA tensors, ``attention_bwd_from_stats_plain`` for CPU
    tensors; o and lse are K1's (or the plain forward's) for q, k, v."""
    if q.device.type == "cpu":
        return attention_bwd_from_stats_plain(q, k, v, do, o, lse)
    _check_kernel("attention_bwd", q, k, v, do, o, lse)
    b, lq, ck = q.shape
    lk, cv = v.shape[1], v.shape[2]
    if cv > MAX_CV:
        raise ValueError(f"the attention_bwd kernel takes Cv <= {MAX_CV}, "
                         f"got {cv}")
    if o.shape != do.shape or o.dtype != q.dtype \
            or lse.shape != (b, lq) or lse.dtype != torch.float32:
        raise ValueError(f"attention_bwd needs o {tuple(do.shape)} of "
                         f"{q.dtype} and lse {(b, lq)} of float32, got "
                         f"{tuple(o.shape)} of {o.dtype} and "
                         f"{tuple(lse.shape)} of {lse.dtype}")
    lib = build.load("attention_bwd")
    fn = lib.tt_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((b, lq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 o.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), delta.data_ptr(),
                 b, lq, lk, ck, cv, _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"attention_bwd kernel launch failed: cudaError {err}")
    _count(attention_bwd, q.dtype)
    return dq, dk, dv


class _AttentionBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, do, o, lse):
        ctx.save_for_backward(q, k, v, do)
        return _bwd(q, k, v, do, o, lse)

    @staticmethod
    def backward(ctx, gdq, gdk, gdv):
        # the vector-Jacobian product of the closed form, itself
        # differentiable when the caller builds a graph (create_graph). The
        # closed form recomputes p from q and k, so its vjp over (q, k, v,
        # do) is the whole derivative: o and lse, functions of q, k and v
        # that K2 only reads, get none
        _, vjp = torch.func.vjp(attention_bwd_plain, *ctx.saved_tensors)
        return (*vjp((gdq, gdk, gdv)), None, None)


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = _fwd(q, k, v, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return _AttentionBwd.apply(q, k, v, do.contiguous(), o.detach(), lse)


@torch.library.custom_op("tartangan::attention", mutates_args=(),
                         device_types="cuda")
def attention_op(q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T) v without a gradient: K1, without the lse store."""
    return _fwd(q, k, v, with_lse=False)[0]


@attention_op.register_kernel("cpu")
def _attention_op_cpu(q, k, v):
    return attention_plain(q, k, v)


@attention_op.register_fake
def _attention_op_fake(q, k, v):
    return q.new_empty((q.shape[0], q.shape[1], v.shape[2]))


def attention(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T) v, differentiable: the CUDA kernels for CUDA tensors,
    the plain versions for CPU tensors; outside autograd, the custom op."""
    _check(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Attention.apply(q, k, v)
    return attention_op(q, k, v)


def attention_bwd(q, k, v, do):
    """(dq, dk, dv) of ``attention``, itself differentiable: K1 for o and
    lse, then K2, for CUDA tensors; the plain versions for CPU tensors."""
    _check(q, k, v)
    if do.shape != (q.shape[0], q.shape[1], v.shape[2]) \
            or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"do must be {tuple(q.shape[:2]) + (v.shape[2],)} "
                         f"of {q.dtype} on {q.device}, got {tuple(do.shape)} "
                         f"of {do.dtype} on {do.device}")
    with torch.no_grad():
        o, lse = _fwd(q, k, v, with_lse=True)
    return _AttentionBwd.apply(q, k, v, do, o, lse)


attention.launches = 0
attention.launches_by_dtype = {}
attention_bwd.launches = 0
attention_bwd.launches_by_dtype = {}
