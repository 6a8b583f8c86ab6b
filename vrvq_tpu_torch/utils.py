"""Spans, counters and profiler helpers: the port's one tracing facility.

``annotate(name, payload=None, **ids)`` is a span: a context manager that
always appends a ``Record`` (name, host start and end on
``time.perf_counter_ns``, the enclosing span, an optional integer payload
such as windows, rows or bytes, and the ``ids``) to a ring of
``CAPACITY`` records that drops the oldest when full (``RING.dropped``
counts them). While a ``torch.profiler`` records, the span also enters
``record_function("vrvq.<name>")``, so it lies on the trace's own clock
beside the kernels it launched; otherwise it costs a few microseconds.
``add_span`` appends a record whose times were taken elsewhere (a window's
wait in a queue).

``count(name, n=1)`` adds to a counter table, grouped by the part of the
name before its first dot; ``counter(group)`` is one group's
``collections.Counter`` (``kernels.LAUNCHES`` is ``counter("launches")``).

Readers: ``records(name, since_ns, until_ns)``, ``self_ns`` (a span less
its children), ``reset()``, and ``idle_by_span(prof)``, which splits a
finished profile's device idle time over the innermost ``vrvq.`` span open
at each instant. ``profile_trace`` traces a block into a directory that
TensorBoard reads.

JAX's ``enable_compilation_cache`` has no counterpart: the port compiles
nothing per shape at run time, and its one build cache is the kernel build
directory of ``kernels/build.py`` (``kernels/_build/``, reused by every
process of a checkout).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, Iterable, Iterator, List, NamedTuple, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

CAPACITY = 1 << 16
PREFIX = "vrvq."
NO_SPAN = "(no span)"  # idle_by_span's label where no span was open

_clock = time.perf_counter_ns


class Record(NamedTuple):
    seq: int  # the span's number, in the order spans were entered
    name: str
    start_ns: int
    end_ns: int
    parent: int  # the enclosing span's seq, -1 at the top
    payload: Optional[int]
    ids: Optional[dict]

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


class Ring:
    """A fixed number of records (held as plain tuples, ``Record``'s
    fields); the oldest is overwritten when full. Threads may add at once."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.slots: List[Optional[tuple]] = [None] * capacity
        self.written = 0
        self._lock = threading.Lock()

    def add(self, rec: tuple) -> None:
        with self._lock:
            self.slots[self.written % self.capacity] = rec
            self.written += 1

    @property
    def dropped(self) -> int:
        return max(0, self.written - self.capacity)

    def __iter__(self) -> Iterator[Record]:
        """The records held, oldest first."""
        start = self.written % self.capacity if self.dropped else 0
        for i in range(min(self.written, self.capacity)):
            yield Record._make(self.slots[(start + i) % self.capacity])

    def clear(self) -> None:
        with self._lock:
            self.slots = [None] * self.capacity
            self.written = 0


RING = Ring(CAPACITY)
COUNTERS: Dict[str, collections.Counter] = {}
_seq = itertools.count()
_open = threading.local()  # each thread's stack of open spans


def _stack() -> list:
    try:
        return _open.stack
    except AttributeError:
        _open.stack = []
        return _open.stack


class annotate:
    """A span: ``with annotate("stream_pool.poll", payload=n) as span:``.
    ``span.payload`` may be set inside the block; ``span.ns`` is its length
    after it."""

    __slots__ = ("name", "payload", "ids", "seq", "parent", "start_ns", "end_ns", "_rf",
                 "_stack")

    def __init__(self, name: str, payload: Optional[int] = None, **ids):
        self.name = name
        self.payload = payload
        self.ids = ids or None

    def __enter__(self) -> "annotate":
        self._stack = stack = _stack()
        self.parent = stack[-1].seq if stack else -1
        self.seq = next(_seq)
        stack.append(self)
        self._rf = None
        if _autograd_profiler._is_profiler_enabled:
            self._rf = torch.autograd.profiler.record_function(PREFIX + self.name)
            self._rf.__enter__()
        self.start_ns = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = _clock()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        self._stack.pop()
        RING.add((self.seq, self.name, self.start_ns, self.end_ns,
                  self.parent, self.payload, self.ids))
        return False

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


def add_span(name: str, start_ns: int, end_ns: int, payload: Optional[int] = None,
             **ids) -> None:
    """A record of a stretch timed elsewhere on ``time.perf_counter_ns``,
    under the span open now."""
    stack = _stack()
    RING.add((next(_seq), name, start_ns, end_ns,
              stack[-1].seq if stack else -1, payload, ids or None))


def counter(group: str) -> collections.Counter:
    """One group of the counter table (created empty on first use)."""
    return COUNTERS.setdefault(group, collections.Counter())


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``, ``"<group>.<key>"``."""
    group, _, key = name.partition(".")
    counter(group)[key] += n


def records(name: Optional[str] = None, since_ns: Optional[int] = None,
            until_ns: Optional[int] = None) -> List[Record]:
    """The records held of span ``name`` (all without it) that started at or
    after ``since_ns`` and ended by ``until_ns``, in the order they ended."""
    return [r for r in RING if (name is None or r.name == name)
            and (since_ns is None or r.start_ns >= since_ns)
            and (until_ns is None or r.end_ns <= until_ns)]


def self_ns(recs: Iterable[Record], among: Optional[Iterable[Record]] = None) -> List[int]:
    """Each record's length less its children's (the spans it encloses),
    the children found among ``among`` (the ring's records without it)."""
    children: Dict[int, int] = collections.Counter()
    for r in RING if among is None else among:
        children[r.parent] += r.ns
    return [r.ns - children[r.seq] for r in recs]


def reset() -> None:
    """Empty the ring and every counter group (the groups stay the same
    objects)."""
    RING.clear()
    for group in COUNTERS.values():
        group.clear()


def profile_events(prof) -> Iterator[Tuple[str, bool, bool, int, int]]:
    """(name, on_device, annotation, start_ns, end_ns) of a finished
    ``torch.profiler`` profile's events."""
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
        yield (e.name, e.device_type == cuda, False, int(tr.start * 1e3), int(tr.end * 1e3))


def is_device_op(name: str, on_device: bool, annotation: bool) -> bool:
    """A device event that is an operation (a kernel, copy or set), not an
    annotation of a span."""
    return on_device and not annotation and not name.startswith(PREFIX)


def idle_split(events: Iterable[Tuple[str, bool, bool, int, int]]) -> Dict[str, float]:
    """Idle seconds of the device by span, from ``(name, on_device,
    annotation, start_ns, end_ns)`` events: from the first event to the last
    (device operations and ``vrvq.`` host spans), every instant that no
    device operation covers is charged to the innermost ``vrvq.`` host span
    open at it (the latest begun), or to ``NO_SPAN``."""
    busy, spans = [], []
    for name, on_device, annotation, start, end in events:
        if is_device_op(name, on_device, annotation):
            busy.append((start, end))
        elif not on_device and name.startswith(PREFIX):
            spans.append((start, end, name[len(PREFIX):]))
    # sweep over every boundary: +1/-1 device depth, spans opened and closed
    points = collections.defaultdict(lambda: [0, [], []])
    for s, e in busy:
        points[s][0] += 1
        points[e][0] -= 1
    for i, (s, e, _) in enumerate(spans):
        points[s][1].append(i)
        points[e][2].append(i)
    idle: Dict[str, float] = collections.Counter()
    depth, active = 0, []
    edges = sorted(points)
    for t0, t1 in zip(edges, edges[1:]):
        step, opened, closed = points[t0]
        depth += step
        active += opened
        for i in closed:
            active.remove(i)
        if depth == 0:
            inner = max(active, key=lambda i: (spans[i][0], -spans[i][1]), default=None)
            idle[NO_SPAN if inner is None else spans[inner][2]] += (t1 - t0) / 1e9
    return dict(idle)


def idle_by_span(prof) -> Dict[str, float]:
    """A finished ``torch.profiler`` profile's device idle seconds, split
    over the innermost ``vrvq.`` span open at each instant of each gap
    (``idle_split``)."""
    return idle_split(profile_events(prof))


@contextlib.contextmanager
def profile_trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Trace the enclosed block with ``torch.profiler`` (the host, and the
    card where CUDA is available) into ``logdir`` for TensorBoard's profile
    plugin (or a Chrome trace viewer); yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)) as prof:
        yield prof
