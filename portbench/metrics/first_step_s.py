"""Host seconds of the process's first ``train.step`` span: lazy module
loading, cuDNN's choice of algorithms, the kernels' libraries' load, the
allocator's growth, on top of a step."""
from portbench import spans


def read(run):
    first = [r for r in spans.records()
             if r.name == "train.step" and r.end_ns is not None][:1]
    return first[0].host_s if first else None
