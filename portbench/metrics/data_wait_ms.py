"""The device's milliseconds a traced step in the program's ``train.data``
span (taking the next batch in ``Trainer.train``): the batch's copy to the
device and the time the drained device waited for the host's crop."""
from portbench import spans


def read(run):
    return spans.device_ms_a_step("train.data")
