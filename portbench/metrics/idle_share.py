"""The device's idle share of the traced steps: 1 - the union of its
events' intervals over their window. The profiler's CPU tracing slows
the host there (``run.py`` prints by how much against the measured
window), so a host-paced step reads idler than it runs untraced."""


def read(run):
    t = run.trace
    if t is None or not t.busy_s:
        return None
    return 1.0 - t.busy_s / t.window_s
