"""The traced window: ``torch.profiler`` over part of a run, reduced to the
device's busy time, its operations by name and its idle gaps by the
benchmark span that was open on the host.

Device operations are the trace's device events (kernels, copies, sets)
that are not annotations; ``busy_s`` is the length of the union of their
intervals. An idle gap is a stretch of the traced window with no device
operation; it is named by the innermost benchmark span (a
``record_function`` of the driver) open on the host when it began."""

from __future__ import annotations

import bisect
import collections
import dataclasses
import time
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    ops: Dict[str, float]  # device seconds by operation name
    gaps: Dict[str, float]  # idle seconds by the host span open
    units: int = 0  # passes, polls or steps inside the traced window

    def op_seconds(self, fragment: str, exclude: Tuple[str, ...] = ()) -> float:
        """Device seconds of the operations whose name holds ``fragment``
        (case-insensitive) and none of ``exclude``."""
        f = fragment.lower()
        return sum(s for name, s in self.ops.items() if f in name.lower()
                   and not any(e.lower() in name.lower() for e in exclude))

    def breakdown(self) -> dict:
        top = lambda d: [[n, s] for n, s in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
        return {"device_ops": top(self.ops), "idle_gaps": top(self.gaps)}


class Tracer:
    """Starts and stops the profiler; ``summary`` after ``stop``."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = 0.0
        self.summary: Optional[TraceSummary] = None

    @property
    def active(self) -> bool:
        return self.prof is not None and self.summary is None

    @staticmethod
    def prime() -> None:
        """A first, empty profiling session, in set-up: the first start of
        the device's tracer takes seconds, which would otherwise fall into
        the window."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda" if torch.cuda.is_available() else "cpu").add_(1)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self, units: int, run=None) -> TraceSummary:
        """Stop tracing after ``units`` of the window; with ``run``, what the
        window does from here on is what its host-clock readers see (the
        traced part runs slower): its spans are cleared and ``run.rest``
        marks the time and units at the stop."""
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.summary = summarize(self.prof, self.t1 - self.t0)
        self.summary.units = units
        self.prof = None
        if run is not None:
            run.spans.clear()
            run.rest = (time.perf_counter(), units)
        return self.summary


def _events(prof):
    """(name, on_device, annotation, start_ns, end_ns) of every event."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    kineto = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if kineto is not None:
        for e in kineto.events():
            start = e.start_ns()
            yield (e.name(), e.device_type() == cuda,
                   bool(getattr(e, "is_user_annotation", lambda: False)()),
                   start, start + e.duration_ns())
        return
    for e in prof.events():  # older profilers
        tr = e.time_range
        yield (e.name, e.device_type == cuda, False,
               int(tr.start * 1e3), int(tr.end * 1e3))


def summarize(prof, window_s: float) -> TraceSummary:
    ops: Dict[str, float] = collections.Counter()
    intervals: List[Tuple[int, int]] = []
    host: List[Tuple[int, int, str]] = []
    for name, on_device, annotation, start, end in _events(prof):
        if on_device:
            if annotation or name.startswith("bench."):
                continue
            ops[name[:120]] += (end - start) / 1e9
            intervals.append((start, end))
        elif name.startswith("bench."):
            host.append((start, end, name[len("bench."):]))
    intervals.sort()
    merged = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    gaps: Dict[str, float] = collections.Counter()
    host.sort()
    starts = [h[0] for h in host]
    lo = min([s for s, _ in merged] + starts) if (merged or starts) else 0
    hi = max([e for _, e in merged] + [h[1] for h in host]) if (merged or host) else 0
    edges = [lo] + [x for m in merged for x in m] + [hi]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        label = "no benchmark span"
        i = bisect.bisect_right(starts, g0) - 1
        best = None
        while i >= 0:  # the innermost span open at g0: the latest that covers it
            s, e, name = host[i]
            if e > g0:
                best = name
                break
            i -= 1
        if best is not None:
            label = best
        gaps[label] += (g1 - g0) / 1e9
    return TraceSummary(window_s=window_s, busy_s=busy / 1e9, ops=dict(ops),
                        gaps=dict(gaps))
