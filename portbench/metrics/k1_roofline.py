"""K1's share of its roofline, %: the least time of the traced steps' K1
launches (``flops.kernel_bound_ms``) over K1's device time; nothing where
no K1 ran."""
from portbench import flops


def read(run):
    t = run.trace
    if t is None or not t.k1_ns:
        return None
    dtype = run.cfg["dtype"]
    bound = sum(flops.kernel_bound_ms(run.counts(r1),
                                      flops.PEAKS["itemsize"][dtype],
                                      flops.peak_flops(dtype))["k1"]
                for r1 in run.trace_r1)
    return 100.0 * bound / (t.k1_ns / 1e6)
