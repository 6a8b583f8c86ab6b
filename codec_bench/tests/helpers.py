"""What the harness's CPU tests share: a small configuration with the
flagship's topology, and a run of one cell's driver on it."""

from __future__ import annotations

import json
from pathlib import Path

from codec_bench import harness

TINY = json.loads((Path(__file__).resolve().parent / "tiny.json").read_text())

# each cell's traffic cut to what a CPU test holds
SMALL = {
    "oneshot": {"rows": 2, "clip_s": 0.5, "pool": 4, "sample_passes": 2, "trace_s": 0.3},
    "live": {"streams": 3, "clip_s": 2.0, "warmup_s": 0.3, "sample_windows": 6,
             "max_batch": 4, "trace_s": 0.5, "grace_s": 20.0},
    "train": {"rows": 4, "excerpt_s": 0.1, "clips": 4, "clip_s": 1.0, "trace_s": 0.3},
}


def cell_run(workload: str, seed: int = 12345, seconds: float = 1.0, fault=None,
             impl: str = "program", trace: bool = False, drive: bool = True):
    """A run of ``workload``'s driver on the CPU at the small configuration,
    with the cell's limits; the chip check is skipped."""
    from codec_bench.run import build_run

    run = build_run(workload, seed, seconds, trace, device="cpu", fault=fault)
    run.config = TINY
    run.mix.update(SMALL[run.mix["driver"]], impl=impl)
    if drive:
        harness.driver(run.mix["driver"]).drive(run)
    return run
