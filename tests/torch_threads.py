"""Torch's CPU threads in a test process: the process's share of the cores.

pytest-xdist runs N worker processes on the machine, and torch would give
each of them a thread a core, N x cores OpenMP threads in all, whose
spin-waits slow every worker many times over (``tests/test_torch_
metrics.py`` took 23 s alone on 8 cores and 507 s inside a 6-worker run of
the whole suite). Each port test module imports this module, which gives
its process ``cores // N`` threads (all of them outside xdist). The
mesh's ranks take their share of these (``parallel/mesh.py::launch``).

``read_at_eight_threads`` runs a test on eight threads: a float32
comparison whose tolerance was read there (the port's sums run in another
order on one or two threads, which moves the train steps' batch
statistics past it). Torch splits a sum by its thread count, not by the
cores under it, so the test sums in the same order on any machine.
"""
import functools
import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
torch.set_num_threads(max(1, (os.cpu_count() or 1) // WORKERS))
TOLERANCE_THREADS = 8


def read_at_eight_threads(test):
    """Run ``test`` on ``TOLERANCE_THREADS`` threads, then give the
    process its share back."""
    @functools.wraps(test)
    def run(*args, **kwargs):
        share = torch.get_num_threads()
        torch.set_num_threads(TOLERANCE_THREADS)
        try:
            return test(*args, **kwargs)
        finally:
            torch.set_num_threads(share)
    return run
