"""What the benchmark reads from the profiler's trace of a window.

``Trace`` reduces one ``torch.profiler`` session (CPU and CUDA
activities) to the quantities the per-layer metrics read: the device's
busy time (the union of its events' intervals), the device time of the
convolutions (kernels the host launched inside a CPU op that matches
``kernels.json``'s ``conv_ops``, on any thread), of K1 and of K2 (by kernel
name), the host's kernel launches, the device operations that took most
time, and the idle gaps by the CPU op the host was in at their middle.
"""
from __future__ import annotations

import bisect
import json
import re
from collections import Counter
from pathlib import Path

PATTERNS = json.loads((Path(__file__).parent / "kernels.json").read_text())


def kernel_names(*names):
    """Substrings that pick out the device events of the named kernels, as
    the profiler names them demangled (``ns::name<...>``, ``ns::name(...)``)
    or mangled (length and name); a copy of the port's
    ``chip_smoke.kernel_names``."""
    return tuple(p for n in names
                 for p in (f"::{n}<", f"::{n}(", f"{len(n)}{n}"))


def _union(spans):
    """[(start, end)] merged, sorted."""
    out = []
    for start, end in sorted(spans):
        if out and start <= out[-1][1]:
            if end > out[-1][1]:
                out[-1][1] = end
        else:
            out.append([start, end])
    return out


def _top(counter, n=10):
    return [[name, ns / 1e9] for name, ns in counter.most_common(n)]


class Trace:
    """The reduction of profile ``prof`` of a window that ran from
    ``t0_ns`` to ``t1_ns`` (``time.time_ns()``, the trace's clock)."""

    def __init__(self, prof, t0_ns: int, t1_ns: int):
        from torch.autograd import DeviceType
        conv_re = re.compile("|".join(PATTERNS["conv_ops"]))
        k1, k2 = (kernel_names(*PATTERNS[k]) for k in ("k1", "k2"))
        launches = set(PATTERNS["host_launches"])
        ops, dev = {}, []
        conv_spans = {}
        self.launches = 0
        for e in prof.profiler.kineto_results.events():
            start, end, name = e.start_ns(), e.end_ns(), e.name()
            if e.device_type() == DeviceType.CPU:
                tid = e.start_thread_id()
                ops[e.correlation_id()] = (start, end, name, tid)
                if name in launches:
                    self.launches += 1
                if conv_re.search(name):
                    conv_spans.setdefault(tid, []).append((start, end))
            elif end > start and not e.is_user_annotation():
                # (a record_function range shows on the device's timeline
                # too, as a user annotation spanning its kernels)
                dev.append((start, end, name, e.linked_correlation_id()))
        conv_spans = {t: _union(s) for t, s in conv_spans.items()}
        conv_starts = {t: [s[0] for s in v] for t, v in conv_spans.items()}

        def in_conv(corr):
            op = ops.get(corr)
            if op is None:
                return False
            start, _, _, tid = op
            spans = conv_spans.get(tid, ())
            i = bisect.bisect_right(conv_starts.get(tid, ()), start) - 1
            return i >= 0 and spans[i][0] <= start <= spans[i][1]

        by_name = Counter()
        self.conv_ns = self.k1_ns = self.k2_ns = self.device_ns = 0
        self.k1_events = self.k2_events = 0
        for start, end, name, corr in dev:
            ns = end - start
            by_name[name[:160]] += ns
            self.device_ns += ns
            if any(p in name for p in k1):
                self.k1_ns += ns
                self.k1_events += 1
            elif any(p in name for p in k2):
                self.k2_ns += ns
                self.k2_events += 1
            elif in_conv(corr):
                self.conv_ns += ns
        busy = [(max(s, t0_ns), min(e, t1_ns)) for s, e, _, _ in dev]
        busy = _union([(s, e) for s, e in busy if e > s])
        self.busy_s = sum(e - s for s, e in busy) / 1e9
        self.window_s = (t1_ns - t0_ns) / 1e9
        self.device_ops = _top(by_name)
        self.idle_gaps = _top(self._gaps(busy, ops, t0_ns, t1_ns))

    @staticmethod
    def _gaps(busy, ops, t0_ns, t1_ns):
        """Idle device time by the innermost CPU op covering each gap's
        middle ("no host op" where none does)."""
        spans = sorted((s, e, n) for s, e, n, _ in ops.values())
        starts = [s[0] for s in spans]
        edges = [t0_ns] + [x for se in busy for x in se] + [t1_ns]
        out = Counter()
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2
            i = bisect.bisect_right(starts, mid) - 1
            name = "no host op"
            for j in range(i, max(i - 256, -1), -1):
                if spans[j][1] >= mid:
                    name = spans[j][2]
                    break
            out[name[:160]] += b - a
        return out
