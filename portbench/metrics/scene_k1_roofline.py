"""K1's share of its roofline, %: the least time of the traced steps' K1
launches, each the largest of its bytes, its products and its
exponentials (``exp_bound.kernel_bound_ms``), over K1's device time;
nothing where no K1 ran."""
from portbench import exp_bound


def read(run):
    t = run.trace
    if t is None or not t.k1_ns:
        return None
    bound = sum(exp_bound.kernel_bound_ms(run.counts(r1),
                                          run.cfg["dtype"])["k1"]
                for r1 in run.trace_r1)
    return 100.0 * bound / (t.k1_ns / 1e6)
