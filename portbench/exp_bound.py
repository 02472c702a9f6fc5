"""The least time of the attention's kernels K1 and K2 with their
exponentials counted.

``flops.attention_bound_ms`` bounds a launch by its bytes at the memory
bandwidth and its products at the tensor cores' peak. At narrow heads
(the scene generator's Ck 2, Cv 8) neither is what limits it: each logit
takes one exponential on the SM's special-function units, whose rate on an
H100 SXM is 132 SMs x 16 ``ex2`` results a clock x 1.98 GHz (the CUDA C
Programming Guide's throughput table, compute capability 9.0). K1 takes
one a logit; K2 recomputes the probabilities once, one a logit too. A
launch's bound here is the largest of the three.
"""
from __future__ import annotations

from portbench import flops

SMS, EX2_PER_CLOCK, CLOCK_HZ = 132, 16, 1.98e9
EX2_PER_S = SMS * EX2_PER_CLOCK * CLOCK_HZ  # 4.18e12


def exp_ms(b: int, lq: int, lk: int) -> float:
    """The ms of one exponential for each of ``b`` x ``lq`` x ``lk``
    logits."""
    return b * lq * lk / EX2_PER_S * 1e3


def kernel_bound_ms(step: flops.Step, dtype: str) -> dict:
    """{"k1": ms, "k2": ms}: the least time of a step's K1 and K2
    launches in ``dtype``, each launch the largest of its bytes, its
    products (``flops.attention_bound_ms``) and its exponentials."""
    itemsize, peak = flops.PEAKS["itemsize"][dtype], flops.peak_flops(dtype)

    def bound(a, **kw):
        return max(flops.attention_bound_ms(a.b, a.lq, a.lk, a.ck, a.cv,
                                            itemsize, peak=peak, **kw),
                   exp_ms(a.b, a.lq, a.lk))
    launches = step.launches
    return {"k1": sum(n * bound(a, with_lse=lse)
                      for a, lse, n in launches["k1"]),
            "k2": sum(n * bound(a, backward=True)
                      for a, n in launches["k2"])}
