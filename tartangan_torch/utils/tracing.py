"""Spans at the port's layer boundaries, and the kernels' launch counters.

``span(name)`` marks one stretch of the program: the trainer's loop
(``train.data``, ``train.step``, ``train.hooks``), the step's updates
(``step.d``, ``step.g``), the scene generator's structure block
(``scene.structure``), the set-up (``setup.models``, ``setup.data``) and
the build or load of a compiled library (``setup.libs``). A span is
recorded only while a ``torch.profiler`` records in this process
(``--profile-dir``'s steps, a benchmark's traced steps), with two
exceptions that make a handful of records a process: a span opened with
``always=True`` (the set-up's) and every span of the process's first step
(``begin_step``). Off, ``span`` checks its flags and returns one shared null
context: it allocates nothing and opens nothing.

A recorded span keeps, in memory (``records()``): its name, its host start
and end from ``time.time_ns()`` (the clock of the profiler's events), the
index of its parent span, the step it belongs to, whether a profiler was
recording, the notes it was given (``set``) and, once CUDA is initialized,
two timing events recorded on the current stream at its entry and exit,
whose distance is its ``device_ms``: the stream's time from the span's
first to its last work, idle included. Kernels that autograd's backward
launches from its own thread run on the same stream, so a span open around
``backward()`` on the main thread times them. While a profiler records, a
span also opens the operators of ``torch.profiler.record_function`` under
its name (called directly, at a third of the wrapper's cost), so it shows
on the profiler's CPU timeline and names the device's idle gaps there.

A span records no CUDA events while the current stream is being captured
into a CUDA graph: under ``--steps-per-call K > 1`` on the card the step's
spans exist at the capture alone, with host times and no device time, and a
replay has none.

``count_launch(fn, dtype)`` counts one launch of a hand-written kernel on
the function that launches it (made a counter by ``counted``):
``fn.launches`` counts them all, ``fn.launches_by_dtype`` each dtype's.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import torch

_LOCK = threading.Lock()  # the records' and the launch counters'
_RECORDS: list = []
_OPEN: list = []   # the open spans' indices, innermost last
_step = None       # the step the spans belong to (``begin_step``)
_first = None      # None before the process's first step, True in it
# the two operators of ``torch.profiler.record_function``
_ENTER = torch.ops.profiler._record_function_enter_new.default
_EXIT = torch.ops.profiler._record_function_exit._RecordFunction


@dataclass(eq=False)
class Record:
    """One recorded span; ``parent`` indexes ``records()``, ``step`` is the
    step of the ``train.step`` span it belongs to (None in the set-up)."""
    name: str
    parent: int | None
    step: int | None
    profiled: bool
    start_ns: int = 0
    end_ns: int | None = None
    meta: dict = field(default_factory=dict)
    events: tuple | None = None

    @property
    def host_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    @property
    def device_ms(self) -> float | None:
        """The current stream's milliseconds from entry to exit; None
        without CUDA events (the CPU, a capture, a span left open)."""
        if self.events is None or self.events[1] is None:
            return None
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end)


def _no_events() -> bool:
    """No CUDA events to record: CUDA is not in use, or the current stream
    is being captured."""
    return (not torch.cuda.is_initialized()
            or torch.cuda.is_current_stream_capturing())


class _Span:
    __slots__ = ("name", "record", "index", "handle")

    def __init__(self, name: str):
        self.name = name
        self.handle = None

    def __enter__(self):
        profiled = torch.autograd._profiler_enabled()
        with _LOCK:
            self.index = len(_RECORDS)
            self.record = Record(self.name, _OPEN[-1] if _OPEN else None,
                                 _step, profiled)
            _RECORDS.append(self.record)
            _OPEN.append(self.index)
        if profiled:  # (its event's clock starts inside the call)
            self.handle = _ENTER(self.name, None)
        self.record.start_ns = time.time_ns()
        if not _no_events():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self.record.events = (start, None)
        return self

    def set(self, **notes):
        """Add ``notes`` to the span's record (``meta``)."""
        self.record.meta.update(notes)

    def __exit__(self, *exc):
        rec = self.record
        if rec.events is not None:
            if _no_events():
                rec.events = None
            else:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                rec.events = (rec.events[0], end)
        if self.handle is not None:
            _EXIT(self.handle)
        rec.end_ns = time.time_ns()
        with _LOCK:
            if self.index in _OPEN:
                _OPEN.remove(self.index)
        return False


class _Off:
    """The span that is off: one shared instance."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **notes):
        pass


_OFF = _Off()


def span(name: str, always: bool = False):
    """A context manager that records the stretch it covers as ``name``
    while a profiler records, in the process's first step, or ``always``."""
    if always or _first or torch.autograd._profiler_enabled():
        return _Span(name)
    return _OFF


def begin_step(step: int) -> None:
    """The spans from here to the next call belong to step ``step``; those
    of the process's first step are recorded without a profiler too."""
    global _step, _first
    _step = step
    _first = _first is None


def records() -> list:
    """Every recorded span of the process, in the order they opened."""
    with _LOCK:
        return list(_RECORDS)


def reset() -> None:
    """Forget the records and the first step (for tests)."""
    global _step, _first
    with _LOCK:
        _RECORDS.clear()
        _OPEN.clear()
    _step = _first = None


def counted(fn):
    """``fn`` with its launch counters at zero."""
    fn.launches = 0
    fn.launches_by_dtype = {}
    return fn


def count_launch(fn, dtype) -> None:
    """One launch of ``fn``'s kernel in ``dtype``."""
    with _LOCK:
        fn.launches += 1
        fn.launches_by_dtype[dtype] = fn.launches_by_dtype.get(dtype, 0) + 1
