"""Host seconds in the program's ``setup.models`` and ``setup.data``
spans: the models' construction and placement, and the archive's load."""
from portbench import spans


def read(run):
    return spans.host_s("setup.models", "setup.data")
