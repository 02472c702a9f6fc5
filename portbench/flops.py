"""Operations and bytes of a training step, counted from a model's layers,
and the least time the chip could take for them.

A model module (``portbench/models/<model>.py``) lists its convolutions,
dense layers and attentions (``Conv``, ``Attention``) and how many
forward-sized operations a step makes of each (``conv_ops``,
``attention_ops``) and its launches of K1 and K2 (``kernel_launches``);
``counts`` gathers them for one step, and the sums here read them. Each
operation reads its two inputs and writes its output once: the
activations, weights and outputs of the layer, ``itemsize`` bytes each. An
attention of forward FLOPs A = 2 B Lq Lk (Ck + Cv) has a backward of 2 B Lq
Lk (2 Ck + 2 Cv) (dp, dv, dq, dk; p kept), and its backward's backward, in
R1, twice that. The bounds of K1 and K2 (the attention's kernels) are
``attention_bound_ms``, a copy of the port's
``chip_smoke.attention_bound_ms``.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())


def peak_flops(dtype: str) -> float:
    return PEAKS["flops"][dtype]


def bound_ms(nbytes: float, flops: float, peak: float) -> float:
    """The least ms: the bytes at the memory bandwidth against the
    operations at ``peak`` (the port's ``chip_smoke._bound``)."""
    return max(nbytes / PEAKS["bytes_per_s"], flops / peak) * 1e3


@dataclasses.dataclass(frozen=True)
class Conv:
    """A convolution (or a dense layer: k 1, H = W = 1) with output H W."""
    name: str
    b: int
    cin: int
    cout: int
    k: int
    h: int
    w: int
    h_in: int
    w_in: int
    dense: bool = False

    @property
    def flops(self) -> int:
        return 2 * self.b * self.h * self.w * self.cin * self.cout * self.k ** 2

    def nbytes(self, itemsize: int) -> int:
        x = self.b * self.cin * self.h_in * self.w_in
        y = self.b * self.cout * self.h * self.w
        return itemsize * (x + y + self.cout * self.cin * self.k ** 2)


@dataclasses.dataclass(frozen=True)
class Attention:
    name: str
    b: int
    lq: int
    lk: int
    ck: int
    cv: int

    @property
    def fwd_flops(self) -> int:
        return 2 * self.b * self.lq * self.lk * (self.ck + self.cv)

    @property
    def bwd_flops(self) -> int:
        return 2 * self.b * self.lq * self.lk * (2 * self.ck + 2 * self.cv)


@dataclasses.dataclass(frozen=True)
class Step:
    """One step's counts: ``conv_ops`` [(Conv, operations)],
    ``attention_ops`` [(Attention, forward multiples, backward multiples)]
    and ``launches`` ({"k1": [(Attention, with_lse, n)], "k2":
    [(Attention, n)]})."""
    conv_ops: list
    attention_ops: list
    launches: dict


def counts(model, arch: dict, b: int, r1: bool) -> Step:
    """The counts of model module ``model``'s step at batch ``b``, with R1
    or not."""
    return Step(model.conv_ops(arch, b, r1), model.attention_ops(arch, b, r1),
                model.kernel_launches(arch, b, r1))


def step_flops(step: Step) -> int:
    """The FLOPs one step needs: its convolutions, dense layers and
    attention products."""
    convs = sum(layer.flops * n for layer, n in step.conv_ops)
    attn = sum(a.fwd_flops * f + a.bwd_flops * k
               for a, f, k in step.attention_ops)
    return convs + attn


def conv_bound_ms(step: Step, itemsize: int, peak: float) -> float:
    """The least time of a step's convolutions (not its dense layers),
    each operation bounded alone."""
    return sum(n * bound_ms(layer.nbytes(itemsize), layer.flops, peak)
               for layer, n in step.conv_ops if not layer.dense)


def attention_bound_ms(b, lq, lk, ck, cv, itemsize, backward=False,
                       with_lse=True, peak=PEAKS["flops"]["f32"]):
    """Least time for the attention on an H100: each input read once and
    each output written once, against the float32 FLOPs the JAX kernel
    does: 2*B*Lq*Lk*(Ck+Cv) forward, with q, k, v in and o and (when
    training, ``with_lse``) the f32 lse out; 2*B*Lq*Lk*(3*Ck+2*Cv) backward
    (s, dp, dq, dk, dv), with q, k, v, do, o and lse in and dq, dk, dv
    out; the FLOPs at ``peak``. (A copy of the port's
    ``chip_smoke.attention_bound_ms``.)"""
    qkv = b * lq * ck + b * lk * ck + b * lk * cv
    if backward:
        nbytes = itemsize * (2 * qkv + 2 * b * lq * cv) + 4 * b * lq
        flops = 2 * b * lq * lk * (3 * ck + 2 * cv)
    else:
        nbytes = itemsize * (qkv + b * lq * cv) + 4 * b * lq * with_lse
        flops = 2 * b * lq * lk * (ck + cv)
    return bound_ms(nbytes, flops, peak)


def kernel_bound_ms(step: Step, itemsize: int, peak: float) -> dict:
    """{"k1": ms, "k2": ms}: the least time of a step's K1 and K2
    launches."""
    launches = step.launches
    k1 = sum(n * attention_bound_ms(a.b, a.lq, a.lk, a.ck, a.cv, itemsize,
                                    with_lse=lse, peak=peak)
             for a, lse, n in launches["k1"])
    k2 = sum(n * attention_bound_ms(a.b, a.lq, a.lk, a.ck, a.cv, itemsize,
                                    backward=True, peak=peak)
             for a, n in launches["k2"])
    return {"k1": k1, "k2": k2}
