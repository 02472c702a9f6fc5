"""The step's share of the chip's peak, %: the FLOPs the window's steps
need (the model's counts, ``portbench/flops.py``: forward, backward and
R1's double backward, no recomputation) over the window (host clock, as
``train_images_per_s``), against the dense peak of the configuration's
compute type. Reported in the traced run, from its window, which comes
before its traced steps."""
from portbench import flops


def read(run):
    if run.trace is None or not run.steps:
        return None
    work = sum(flops.step_flops(run.counts(r1)) for r1 in run.step_r1)
    return 100.0 * work / run.window_s / flops.peak_flops(run.cfg["dtype"])
