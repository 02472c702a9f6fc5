"""Device time a step outside the convolutions and the attention kernels
K1 and K2, ms: BatchNorm, activations, casts, the attention's plain
double backward, Adam, the EMA, copies."""


def read(run):
    t = run.trace
    if t is None or not run.trace_r1:
        return None
    other_ns = t.device_ns - t.conv_ns - t.k1_ns - t.k2_ns
    return other_ns / 1e6 / len(run.trace_r1)
