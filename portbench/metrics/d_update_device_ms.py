"""The device's milliseconds a traced step in the program's ``step.d``
spans (``gan_update``'s D updates: G's forward, D on the reals with R1's
input gradient and on the fakes, the backward with R1's double backward,
D's Adam)."""
from portbench import spans


def read(run):
    return spans.device_ms_a_step("step.d")
