"""A minimal metrics tracker (counterpart of ``vrvq_tpu/train/tracker.py``):
the step, per-phase means, ``log.txt``, the best of a watched metric, a state
dict for checkpoints, and TensorBoard scalars through ``writer`` (a
``SummaryWriter``): each logged step's metrics as ``{name}/{phase}`` at its
step, the tags, values and steps that the JAX tracker's ``_flush`` writes.
In a process group every rank keeps the same sums (the metrics are the
ranks' means); only rank 0 prints, writes the log and writes to ``writer``.
``when`` is the JAX module's decorator; ``read_events``
reads an event file back (for the tests and the smoke).
"""

from __future__ import annotations

import struct
from collections import defaultdict
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple


class Tracker:
    def __init__(self, log_file: Optional[str] = None, log_every: int = 50,
                 rank: int = 0, writer=None):
        self.step = 0
        self.rank = rank
        self.log_every = log_every
        self.log_file = log_file
        self.writer = writer if rank == 0 else None
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
        """Add one step's scalars to the phase's running sums (and to
        TensorBoard, at the tracker's step)."""
        for k, v in metrics.items():
            self._sums[phase][k] += float(v)
            if self.writer is not None:
                self.writer.add_scalar(f"{k}/{phase}", float(v), self.step)
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
        if self.writer is not None:
            self.writer.flush()
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


def when(condition: Callable[[], bool]):
    """Decorator: run the function only when ``condition()`` is true (else
    return None)."""

    def deco(fn):
        def wrapped(*args, **kwargs):
            if condition():
                return fn(*args, **kwargs)
            return None

        return wrapped

    return deco


def read_events(logdir) -> Dict[str, List[Tuple[int, str, Any]]]:
    """Every summary value of the event files under ``logdir``, by tag: a
    list of ``(step, kind, value)``, ``kind`` the value's field (``simple_value``
    with the float, ``audio`` or ``image`` with the message). Reads the
    TFRecord framing itself (length, CRC, payload, CRC; the CRCs unchecked)
    and parses with TensorBoard's protobuf classes (``tensorboard``, else
    ``tensorboardX``'s copy)."""
    try:
        from tensorboard.compat.proto.event_pb2 import Event
    except ImportError:
        from tensorboardX.proto.event_pb2 import Event
    out: Dict[str, List[Tuple[int, str, Any]]] = defaultdict(list)
    for path in sorted(Path(logdir).glob("**/events.out.tfevents.*")):
        data = path.read_bytes()
        pos = 0
        while pos + 12 <= len(data):
            (length,) = struct.unpack("<Q", data[pos:pos + 8])
            event = Event.FromString(data[pos + 12:pos + 12 + length])
            pos += 12 + length + 4
            for value in event.summary.value:
                kind = value.WhichOneof("value")
                out[value.tag].append((event.step, kind, getattr(value, kind)))
    return dict(out)
