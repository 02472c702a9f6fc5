"""The program's own spans (``tartangan_torch/utils/tracing.py``), as the
per-layer metrics that read them take them: nothing where the program has
no such module or no such span."""


def records() -> list:
    """Every span the program recorded in this process; none where the
    program records none."""
    try:
        from tartangan_torch.utils import tracing
    except ImportError:
        return []
    return tracing.records()


def traced(name: str) -> list:
    """The closed spans ``name`` recorded under the profiler: the traced
    steps'."""
    return [r for r in records()
            if r.name == name and r.profiled and r.end_ns is not None]


def device_ms_a_step(name: str):
    """The device milliseconds of the spans ``name`` a traced step; None
    without traced steps or without device times (the CPU)."""
    steps = len(traced("train.step"))
    times = [r.device_ms for r in traced(name)]
    if not steps or not times or None in times:
        return None
    return sum(times) / steps


def host_s(*names: str):
    """The host seconds of every closed span of ``names``, traced or not;
    None where there is none."""
    spans = [r for r in records()
             if r.name in names and r.end_ns is not None]
    return sum(r.host_s for r in spans) if spans else None
