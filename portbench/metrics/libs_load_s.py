"""Host seconds in the program's ``setup.libs`` spans: the build or load
of its compiled libraries (the kernels', the native crop's), most inside
the first step."""
from portbench import spans


def read(run):
    return spans.host_s("setup.libs")
