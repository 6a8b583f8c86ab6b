"""What every cell shares: finding its files by name, the run's record
(spans, counters, work, the traced window), the checks that decide
``correct``, the result line, and the guard against the JAX package.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``, whose ``driver`` names the
module of ``drivers/`` that runs it); its limits are ``checks/<cell>.json``;
each per-layer metric is read by ``metrics/<metric>.py``. Nothing here
names a cell, a configuration, a mix or a metric."""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
# top-level module names that no run may load (the JAX package and JAX)
FORBIDDEN = ("jax", "jaxlib", "flax", "vrvq_tpu")


def spec() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def cell(name: str, bench: Optional[dict] = None) -> dict:
    bench = bench or spec()
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def read_json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def driver(name: str):
    return importlib.import_module(f"{__package__}.drivers.{name}")


def reader(metric: str):
    path = HERE / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(f"{__package__}.metrics.{metric}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read


def metrics_of(bench: dict, workload: str, kind: str) -> List[dict]:
    """The metrics of ``kind`` (``end_to_end`` or ``per_layer``) that the
    cell reports: those that list it, or list no cells."""
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that are JAX's or the JAX
    package's, compared whole (``vrvq_tpu_torch`` is not ``vrvq_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Run:
    """One run of one cell: its inputs, and what the driver records."""

    workload: str
    seed: int
    seconds: float
    trace: bool
    config: dict
    mix: dict
    limits: dict
    chips: int = 1
    device: str = "cuda"
    fault: Optional[str] = None  # a planted fault, for the harness's tests
    started: float = dataclasses.field(default_factory=time.perf_counter)
    setup_s: float = 0.0
    window_s: float = 0.0
    units: int = 0  # passes, windows or steps in the window
    attempted: int = 0
    failed: int = 0
    e2e: Dict[str, float] = dataclasses.field(default_factory=dict)
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    work: Dict[str, float] = dataclasses.field(default_factory=dict)
    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    checks: Dict[str, Tuple[float, float]] = dataclasses.field(default_factory=dict)
    memory_peak_bytes: int = 0
    traced: Any = None  # tracing.TraceSummary
    rest: Any = None  # (host time, units) where the traced part ended

    def untraced(self, end: float) -> Tuple[float, int]:
        """(seconds, units) of the window that ran untraced, the window
        ending at host time ``end`` after ``units``."""
        if self.rest is None:
            return self.window_s, self.units
        return end - self.rest[0], self.units - self.rest[1]

    @property
    def keys(self) -> dict:
        return self.config["keys"]

    @contextlib.contextmanager
    def span(self, name: str, record: bool = True):
        """A benchmark span: a ``record_function`` named ``bench.<name>``
        for the trace and, with ``record``, its host seconds (the block
        must end in a synchronization for them to be the device's too)."""
        from torch.profiler import record_function

        t0 = time.perf_counter()
        with record_function(f"bench.{name}"):
            yield
        if record:
            self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def check(self, name: str, value: float) -> None:
        """A compared number, against ``limits[name]``."""
        self.checks[name] = (float(value), float(self.limits[name]))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            v == v and v <= lim for v, lim in self.checks.values())


def device_record(run: Run, count: int) -> dict:
    import torch

    out = {"platform": "gpu" if run.device == "cuda" else run.device,
           "kind": torch.cuda.get_device_name(0) if run.device == "cuda" else "cpu",
           "count": count, "memory_peak_bytes": int(run.memory_peak_bytes)}
    if run.traced is not None:
        out["busy_s"] = run.traced.busy_s
        out["window_s"] = run.traced.window_s
    return out


def result(run: Run, bench: dict) -> dict:
    """The result line's object. With ``trace`` the cell's per-layer
    metrics (a reader that finds nothing leaves its metric out), else its
    end-to-end metrics; the compared numbers last."""
    metrics = {}
    if run.trace:
        for m in metrics_of(bench, run.workload, "per_layer"):
            value = reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = dict(run.e2e, setup_s=run.setup_s)
        for m in metrics_of(bench, run.workload, "end_to_end"):
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    out = {"correct": run.correct, "attempted": int(run.attempted),
           "failed": int(run.failed), "metrics": metrics,
           "device": device_record(run, run.chips)}
    if run.trace and run.traced is not None:
        out["breakdown"] = run.traced.breakdown()
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    return out
