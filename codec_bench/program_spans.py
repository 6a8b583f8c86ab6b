"""The program's own span records (``vrvq_tpu_torch.utils``: ``records``,
``self_ns``) from the untraced part of a run's window, for the per-layer
readers of ``metrics/``. A program that keeps no records gives None, and
the reader leaves its metric out."""

from __future__ import annotations

from typing import List, Optional, Tuple


def untraced_ns(run) -> Tuple[int, int]:
    """The untraced part of the window on ``time.perf_counter_ns``: where
    the trace came first (``run.rest``), from its stop for
    ``counters["rest_s"]``; else from the window's start (set-up, the
    loop's 0.05 s lead and the mix's ``warmup_s``) to where the trace began,
    the mix's ``trace_s`` before the window's end."""
    if run.rest is not None:
        t0 = run.rest[0]
        return int(t0 * 1e9), int((t0 + run.counters["rest_s"]) * 1e9)
    w0 = run.started + run.setup_s + 0.05 + run.mix.get("warmup_s", 0.0)
    traced = run.mix.get("trace_s", 0.0) if run.trace else 0.0
    return int(w0 * 1e9), int((w0 + run.seconds - traced) * 1e9)


def window(run) -> Optional[List]:
    """Every record that began and ended in the untraced part, or None where
    the program keeps none."""
    try:
        from vrvq_tpu_torch.utils import records
    except ImportError:
        return None
    lo, hi = untraced_ns(run)
    return records(since_ns=lo, until_ns=hi)


def named(recs: List, name: str) -> List:
    return [r for r in recs if r.name == name]


def under(recs: List, parents: List, name: str) -> List:
    """The records named ``name`` whose enclosing span is one of
    ``parents``."""
    seqs = {p.seq for p in parents}
    return [r for r in recs if r.name == name and r.parent in seqs]


def total_ms(recs: List) -> float:
    return sum(r.end_ns - r.start_ns for r in recs) / 1e6


def self_ms(recs: List, among: List) -> float:
    """The records' time less their children's (found among ``among``)."""
    from vrvq_tpu_torch.utils import self_ns

    return sum(self_ns(recs, among)) / 1e6
