"""Learning-rate schedule (counterpart of ``vrvq_tpu/train/schedule.py``):
per-step exponential decay with an optional linear warmup, in float32 as
the JAX schedule computes it."""

from __future__ import annotations

from typing import Callable

import numpy as np


def exponential_lr(base_lr: float, gamma: float = 1.0,
                   warmup: int = 0) -> Callable[[int], float]:
    """``step -> lr``: ``base_lr * gamma ** max(step - warmup, 0)``, ramping
    linearly from 0 over the first ``warmup`` steps."""
    base, g = np.float32(base_lr), np.float32(gamma)

    def schedule(step: int) -> float:
        step = np.float32(step)
        decay = base * np.power(g, np.maximum(step - np.float32(warmup),
                                              np.float32(0.0)))
        if warmup and step < warmup:
            return float(base * step / np.float32(max(1, warmup)))
        return float(decay)

    return schedule
