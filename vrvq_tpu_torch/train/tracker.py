"""A minimal metrics tracker (counterpart of ``vrvq_tpu/train/tracker.py``):
the step, per-phase means, ``log.txt``, the best of a watched metric, and a
state dict for checkpoints. No TensorBoard. In a process group every rank
keeps the same sums (the metrics are the ranks' means); only rank 0 prints
and writes the log."""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, Optional


class Tracker:
    def __init__(self, log_file: Optional[str] = None, log_every: int = 50,
                 rank: int = 0):
        self.step = 0
        self.rank = rank
        self.log_every = log_every
        self.log_file = log_file
        self.history: Dict[str, list] = defaultdict(list)
        self._sums: Dict[str, Dict[str, float]] = defaultdict(lambda: defaultdict(float))
        self._counts: Dict[str, int] = defaultdict(int)
        self._best: Dict[str, float] = {}

    def print(self, msg: str) -> None:
        if self.rank != 0:
            return
        print(msg, flush=True)
        if self.log_file:
            with open(self.log_file, "a") as f:
                f.write(f"{msg}\n")

    def log_metrics(self, phase: str, metrics: Dict[str, float]) -> None:
        """Add one step's scalars to the phase's running sums."""
        for k, v in metrics.items():
            self._sums[phase][k] += float(v)
        self._counts[phase] += 1
        if phase == "train" and self.step % self.log_every == 0:
            parts = " ".join(f"{k}={float(v):.4f}" for k, v in sorted(metrics.items()))
            self.print(f"[{phase}] step {self.step}: {parts}")

    def done(self, phase: str, message: str = "") -> Dict[str, float]:
        """The phase's means since the last ``done``, kept in ``history``."""
        count = max(self._counts[phase], 1)
        means = {k: v / count for k, v in self._sums[phase].items()}
        self.history[phase].append({"step": self.step, **means})
        if message:
            parts = " ".join(f"{k}={v:.4f}" for k, v in sorted(means.items()))
            self.print(f"{message} [{phase} mean] {parts}")
        self._sums[phase].clear()
        self._counts[phase] = 0
        return means

    def is_best(self, phase: str, key: str) -> bool:
        """Whether the latest mean of ``key`` is the lowest so far."""
        if not self.history[phase]:
            return False
        latest = self.history[phase][-1].get(key)
        if latest is None:
            return False
        tag = f"{phase}/{key}"
        if tag not in self._best or latest < self._best[tag]:
            self._best[tag] = latest
            return True
        return False

    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step, "history": dict(self.history),
                "best": dict(self._best)}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.step = sd.get("step", 0)
        self.history = defaultdict(list, sd.get("history", {}))
        self._best = dict(sd.get("best", {}))
