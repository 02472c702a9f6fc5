"""The convolutions' share of their roofline, %: the least time of the
traced steps' convolutions (``flops.conv_bound_ms``, each operation the
larger of its FLOPs at the peak and its bytes at the bandwidth) over the
device time of the kernels launched inside convolution ops."""
from portbench import flops


def read(run):
    t = run.trace
    if t is None or not t.conv_ns:
        return None
    dtype = run.cfg["dtype"]
    bound = sum(flops.conv_bound_ms(run.counts(r1),
                                    flops.PEAKS["itemsize"][dtype],
                                    flops.peak_flops(dtype))
                for r1 in run.trace_r1)
    return 100.0 * bound / (t.conv_ns / 1e6)
