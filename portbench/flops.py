"""Operations and bytes of a training step, counted from a configuration's
shapes, and the least time the chip could take for them.

A step (``portbench/reference.py``) is a D step, on reals (with R1 when
its weight is not 0) and on G's fakes, then a G step through D. Each
convolution or dense layer of forward FLOPs F = 2 B H W Cin Cout k^2
(output H W) is counted, with no recomputation, as:

- G in the D step: forward (F).
- D on the reals with R1: forward, the input gradient R1 takes (F each),
  then the backward through both: the input-gradient convolution's two
  derivatives (2F) and the forward's weight and input gradients (2F; the
  image's input gradient is not needed). Without R1: forward, weight and
  input gradient (3F; the first layer's input gradient not needed).
- D on the fakes: forward, weight and input gradient (3F; not the first
  layer's input gradient).
- The G step: G forward, weight and input gradient (3F; not the dense
  input layer's input gradient), D forward and input gradient (2F).

Each of these operations reads its two inputs and writes its output once:
the activations, weights and outputs of the layer, ``itemsize`` bytes
each. An attention of forward FLOPs A = 2 B Lq Lk (Ck + Cv) has a backward
of 2 B Lq Lk (2 Ck + 2 Cv) (dp, dv, dq, dk; p kept), and its backward's
backward, in R1, twice that. The bounds of K1 and K2 (the attention's
kernels) are ``attention_bound_ms``, a copy of the port's
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


def _attention(name, b, c, res):
    return Attention(name, b, res * res, res * res // 4, max(c // 8, 1),
                     max(c // 2, 1))


def _attention_convs(name, b, c, res):
    ck, cv = max(c // 8, 1), max(c // 2, 1)
    return [Conv(f"{name}.{n}", b, ci, co, 1, res, res, res, res)
            for n, ci, co in (("theta", c, ck), ("phi", c, ck),
                              ("g", c, cv), ("o", cv, c))]


def generator_layers(cfg: dict, b: int):
    """(convs and dense layers in forward order, attentions) of G."""
    base, blocks = cfg["base_size"], cfg["blocks"]
    convs = [Conv("g.dense", b, cfg["latent_dims"], base * base * blocks[0],
                  1, 1, 1, 1, 1, dense=True)]
    attns, cin, res = [], blocks[0], base
    for i, cout in enumerate(blocks):
        r = res * 2
        convs += [Conv(f"g.{i}.conv0", b, cin, cout, 3, r, r, r, r),
                  Conv(f"g.{i}.conv1", b, cout, cout, 3, r, r, r, r)]
        if cin != cout:
            convs.append(Conv(f"g.{i}.proj", b, cin, cout, 1, r, r, r, r))
        if i in cfg["attention"]:
            convs += _attention_convs(f"g.{i}.attn", b, cout, r)
            attns.append(_attention(f"g.{i}.attn", b, cout, r))
        cin, res = cout, r
    convs.append(Conv("g.out", b, cin, cfg["data_dims"], 1, res, res, res,
                      res))
    return convs, attns


def discriminator_layers(cfg: dict, b: int):
    """(convs and dense layers in forward order, attentions) of D."""
    blocks = cfg["blocks"]
    res = cfg["base_size"] * 2 ** len(blocks)
    convs = [Conv("d.in", b, cfg["data_dims"], blocks[-1], 1, res, res, res,
                  res)]
    attns, cin = [], blocks[-1]
    for i in reversed(range(len(blocks))):
        cout, half = blocks[i], res // 2
        convs += [Conv(f"d.{i}.conv0", b, cin, cout, 3, res, res, res, res),
                  Conv(f"d.{i}.conv1", b, cout, cout, 3, res, res, res, res)]
        if cin != cout:
            convs.append(Conv(f"d.{i}.proj", b, cin, cout, 1, half, half,
                              half, half))
        if i in cfg["attention"]:
            convs += _attention_convs(f"d.{i}.attn", b, cout, half)
            attns.append(_attention(f"d.{i}.attn", b, cout, half))
        cin, res = cout, half
    convs.append(Conv("d.dense", b, cin, 1, 1, 1, 1, 1, 1, dense=True))
    return convs, attns


def conv_ops(cfg: dict, b: int, r1: bool):
    """[(layer, count)]: how many F-sized operations of each convolution
    and dense layer one step needs (see the module's docstring)."""
    g, _ = generator_layers(cfg, b)
    d, _ = discriminator_layers(cfg, b)
    ops = []
    for i, layer in enumerate(g):
        ops.append((layer, 1 + 3 - (i == 0)))
    for i, layer in enumerate(d):
        first = i == 0
        real = 6 - first if r1 else 3 - first
        ops.append((layer, real + (3 - first) + 2))
    return ops


def attention_ops(cfg: dict, b: int, r1: bool):
    """[(attention, forward FLOPs multiples, backward multiples)] of a
    step: G forward twice and backward once; D forward three times, and
    backward: reals (with R1: the input gradient, the backward through it,
    twice a backward, and through the forward), fakes, the G step."""
    _, ga = generator_layers(cfg, b)
    _, da = discriminator_layers(cfg, b)
    return ([(a, 2, 1) for a in ga]
            + [(a, 3, (1 + 2 + 1 if r1 else 1) + 1 + 1) for a in da])


def step_flops(cfg: dict, b: int, r1: bool) -> int:
    """The FLOPs one step needs: its convolutions, dense layers and
    attention products."""
    convs = sum(layer.flops * n for layer, n in conv_ops(cfg, b, r1))
    attn = sum(a.fwd_flops * f + a.bwd_flops * k
               for a, f, k in attention_ops(cfg, b, r1))
    return convs + attn


def conv_bound_ms(cfg: dict, b: int, r1: bool, itemsize: int,
                  peak: float) -> float:
    """The least time of a step's convolutions (not its dense layers),
    each operation bounded alone."""
    return sum(n * bound_ms(layer.nbytes(itemsize), layer.flops, peak)
               for layer, n in conv_ops(cfg, b, r1) if not layer.dense)


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


def kernel_launches(cfg: dict, b: int, r1: bool):
    """{"k1": [(attention, with_lse, launches)], "k2": [(attention,
    launches)]}: the launches of the attention's kernels a step makes,
    K1 for each forward (G's in the D step without lse), K2 for each
    backward that is not the backward's own backward."""
    _, ga = generator_layers(cfg, b)
    _, da = discriminator_layers(cfg, b)
    k1 = ([(a, False, 1) for a in ga] + [(a, True, 1) for a in ga]
          + [(a, True, 3) for a in da])
    k2 = [(a, 1) for a in ga] + [(a, 4 if r1 else 3) for a in da]
    return {"k1": k1, "k2": k2}


def kernel_bound_ms(cfg: dict, b: int, r1: bool, itemsize: int,
                    peak: float) -> dict:
    """{"k1": ms, "k2": ms}: the least time of a step's K1 and K2
    launches."""
    launches = kernel_launches(cfg, b, r1)
    k1 = sum(n * attention_bound_ms(a.b, a.lq, a.lk, a.ck, a.cv, itemsize,
                                    with_lse=lse, peak=peak)
             for a, lse, n in launches["k1"])
    k2 = sum(n * attention_bound_ms(a.b, a.lq, a.lk, a.ck, a.cv, itemsize,
                                    backward=True, peak=peak)
             for a, n in launches["k2"])
    return {"k1": k1, "k2": k2}
