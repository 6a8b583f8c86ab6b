"""Timers and profiler helpers.

Counterpart of ``vrvq_tpu/utils.py``: ``PhaseTimer`` and ``StepTimer`` for a
loop's wall clock (``StepTimer`` waits for the card before it reads the
clock), ``annotate`` for a named region of a trace
(``torch.profiler.record_function``) and ``profile_trace``, which traces a
block with ``torch.profiler`` into a log directory that TensorBoard reads.

JAX's ``enable_compilation_cache`` has no counterpart: the port compiles
nothing per shape at run time, and its one build cache is the kernel build
directory of ``kernels/build.py`` (``kernels/_build/``, reused by every
process of a checkout).
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import torch


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


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region inside a profiler trace."""
    with torch.profiler.record_function(name):
        yield


class PhaseTimer:
    """Per-phase wall-clock accounting for a loop: ``mark(name)`` charges
    the time since the previous mark to ``name``; ``report()`` returns the
    mean ms per phase since the last report and resets."""

    def __init__(self):
        self._sums: dict = {}
        self._counts: dict = {}
        self._t = time.perf_counter()

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self._sums[name] = self._sums.get(name, 0.0) + (now - self._t)
        self._counts[name] = self._counts.get(name, 0) + 1
        self._t = now

    def report(self) -> str:
        parts = [
            f"{k}={1000.0 * self._sums[k] / max(self._counts[k], 1):.0f}ms"
            for k in self._sums
        ]
        self._sums.clear()
        self._counts.clear()
        self._t = time.perf_counter()
        return " ".join(parts)


def _sync() -> None:
    """Wait for the work queued on the current card (none on the CPU)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class StepTimer:
    """Rolling wall-clock timer of the last ``window`` steps. ``start`` and
    ``stop`` first wait for the card, so a step is timed from its first
    launch to its last result."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: list = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        _sync()
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        _sync()
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    def steps_per_sec(self) -> float:
        return 1.0 / self.mean if self.times else 0.0
