"""Kernel-launch API calls the host makes a step, from the profiler's CPU
events (``kernels.json``'s ``host_launches``)."""


def read(run):
    if run.trace is None or not run.trace_r1:
        return None
    return run.trace.launches / len(run.trace_r1)
