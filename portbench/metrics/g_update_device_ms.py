"""The device's milliseconds a traced step in the program's ``step.g``
span (``gan_update``'s G update: G and D forward, the backward into G,
G's Adam)."""
from portbench import spans


def read(run):
    return spans.device_ms_a_step("step.g")
