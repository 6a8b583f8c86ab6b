"""Batch collation (counterpart of ``vrvq_tpu/data/collate.py``): Signals
stack into one ``(B, C, T)`` Signal zero-padded to the longest, numbers and
arrays into arrays, dicts and lists recursively."""

from __future__ import annotations

import numpy as np

from ..audio import Signal


def collate(items):
    first = items[0]
    if isinstance(first, dict):
        return {k: collate([it[k] for it in items]) for k in first}
    if isinstance(first, Signal):
        batch = np.zeros((len(items), first.num_channels,
                          max(it.signal_length for it in items)), np.float32)
        for i, it in enumerate(items):
            data = np.asarray(it.audio_data)
            batch[i, :, :data.shape[-1]] = data[0]
        return Signal(batch, first.sample_rate)
    if isinstance(first, (int, float, np.integer, np.floating)):
        return np.array(items)
    if isinstance(first, np.ndarray):
        return np.stack(items)
    if isinstance(first, (list, tuple)):
        return [collate([it[j] for it in items]) for j in range(len(first))]
    return items
