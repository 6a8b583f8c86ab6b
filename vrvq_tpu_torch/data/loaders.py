"""Reproducible audio excerpts for training.

Counterpart of ``vrvq_tpu/data/loaders.py`` (itself audiotools' loader):
``AudioLoader`` scans source folders (every format of
``audio_io.AUDIO_EXTENSIONS``: wav, flac, mp3, mp4, m4a) into per-source file
lists and a shuffled flat index; ``AudioDataset[idx]`` seeds a ``numpy``
RandomState with ``idx`` and draws from it in the JAX package's order (the
item, the excerpt's offset, the transform's parameters), so both packages
give the same excerpt for the same index. An unreadable file, or one with no
decoder on this machine (``UnsupportedFormatError``), gives silence, with
one warning per path. ``AudioDataset(aligned=True)`` aligns its loaders'
per-source file lists at construction (``align_lists`` by ``matcher``,
``{"path": "none"}`` where a list has no counterpart), and every loader after
the first then reads the first one's file position and excerpt offset.
"""

from __future__ import annotations

import struct
import warnings
from pathlib import Path
from typing import Callable, Dict, List, Optional, Union

import numpy as np

from ..audio import Signal, random_state
from .audio_io import AUDIO_EXTENSIONS, choose_from_list_of_lists, read_sources

NONE_ITEM = {"path": "none"}


def default_matcher(x, y) -> bool:
    """Two paths match when their parent folders have the same name."""
    return Path(x).parent.name == Path(y).parent.name


def align_lists(lists: List[List[Dict]], matcher: Callable = default_matcher):
    """Pad the lists in place so that index i is a matching item in every
    list: a ``{"path": "none"}`` placeholder is inserted where an item does
    not match the longest list's, and appended where a list runs out."""
    longest = max(lists, key=len)
    for i, anchor in enumerate(longest):
        for lst in lists:
            if i >= len(lst):
                lst.append(dict(NONE_ITEM))
            elif lst[i]["path"] != "none" and not matcher(lst[i]["path"],
                                                          anchor["path"]):
                lst.insert(i, dict(NONE_ITEM))
    return lists


class AudioLoader:
    """Scans ``sources`` and draws reproducible excerpts from them."""

    def __init__(self, sources: Optional[List[str]] = None,
                 weights: Optional[List[float]] = None,
                 relative_path: str = "", ext: Optional[List[str]] = None,
                 shuffle: bool = True, shuffle_state: int = 0):
        self.sources = sources or []
        self.weights = weights
        self.audio_lists = read_sources(self.sources, relative_path=relative_path,
                                        ext=ext or AUDIO_EXTENSIONS)
        self.audio_indices = [(s, i) for s, src in enumerate(self.audio_lists)
                              for i in range(len(src))]
        if shuffle:
            random_state(shuffle_state).shuffle(self.audio_indices)
        self._warned: set = set()

    def _resolve(self, state, global_idx, source_idx=None, item_idx=None):
        if source_idx is not None and item_idx is not None:
            try:
                return self.audio_lists[source_idx][item_idx], source_idx, item_idx
            except (IndexError, KeyError):
                return dict(NONE_ITEM), source_idx, item_idx
        if global_idx is not None:
            s, i = self.audio_indices[global_idx % len(self.audio_indices)]
            return self.audio_lists[s][i], s, i
        return choose_from_list_of_lists(state, self.audio_lists, p=self.weights)

    def _load(self, path, state, sample_rate, duration, loudness_cutoff,
              num_channels, offset) -> Signal:
        if path == "none":
            return Signal.zeros(duration, sample_rate, num_channels)
        try:
            if offset is not None:
                return Signal.load(path, offset=offset, duration=duration)
            if duration is None:
                return Signal.load(path)
            return Signal.salient_excerpt(path, duration=duration, state=state,
                                          loudness_cutoff=loudness_cutoff)
        except (OSError, EOFError, ValueError, struct.error) as exc:
            if str(path) not in self._warned:
                self._warned.add(str(path))
                warnings.warn(
                    f"could not load audio file {path!r} ({type(exc).__name__}: "
                    f"{exc}); substituting silence for every draw of this file",
                    RuntimeWarning, stacklevel=3)
            return Signal.zeros(duration, sample_rate, num_channels)

    def __call__(self, state, sample_rate: int, duration: float,
                 loudness_cutoff: float = -40, num_channels: int = 1,
                 offset: Optional[float] = None,
                 global_idx: Optional[int] = None,
                 source_idx: Optional[int] = None,
                 item_idx: Optional[int] = None) -> Dict:
        """An excerpt of the item at ``(source_idx, item_idx)``, else of the
        ``global_idx``-th of the shuffled index, else of one drawn from
        ``state``."""
        state = random_state(state)
        info, source_idx, item_idx = self._resolve(state, global_idx, source_idx,
                                                   item_idx)
        path = info["path"]
        signal = self._load(path, state, sample_rate, duration,
                            loudness_cutoff, num_channels, offset)
        if num_channels == 1:
            signal = signal.to_mono()
        signal = signal.resample(sample_rate)
        if duration is not None:
            want = int(duration * sample_rate)
            if signal.signal_length < want:
                signal = signal.zero_pad_to(want)
            signal = signal.truncate_samples(want)
        signal.metadata.update(info)
        item = {
            "signal": signal,
            "source_idx": source_idx,
            "item_idx": item_idx,
            "source": str(self.sources[source_idx]) if self.sources else "",
            "path": str(path),
        }
        return item


class AudioDataset:
    """Item ``idx`` is drawn from ``RandomState(idx)``; with
    ``without_replacement`` the index also picks the file (through the
    loader's shuffled index), so every file comes round in turn. With
    ``aligned`` the loaders' lists are aligned by ``matcher`` and each item
    holds matching excerpts (the first loader's file position and offset)."""

    def __init__(self, loaders: Union[AudioLoader, List[AudioLoader],
                                      Dict[str, AudioLoader]],
                 sample_rate: int, n_examples: int = 1000,
                 duration: float = 0.5, offset: Optional[float] = None,
                 loudness_cutoff: float = -40, num_channels: int = 1,
                 transform: Optional[Callable] = None,
                 aligned: bool = False,
                 shuffle_loaders: bool = False,
                 matcher: Callable = default_matcher,
                 without_replacement: bool = True):
        if isinstance(loaders, list):
            loaders = dict(enumerate(loaders))
        elif isinstance(loaders, AudioLoader):
            loaders = {0: loaders}
        self.loaders = loaders
        self.sample_rate = sample_rate
        self.length = n_examples
        self.duration = duration
        self.offset = offset
        self.loudness_cutoff = loudness_cutoff
        self.num_channels = num_channels
        self.transform = transform
        self.aligned = aligned
        self.shuffle_loaders = shuffle_loaders
        self.without_replacement = without_replacement
        if aligned:
            first = next(iter(loaders.values()))
            for i in range(len(first.audio_lists)):
                align_lists([lo.audio_lists[i] for lo in loaders.values()], matcher)

    def __getitem__(self, idx: int) -> Dict:
        state = random_state(idx)
        keys = list(self.loaders)
        if self.shuffle_loaders:
            state.shuffle(keys)
        kwargs = dict(state=state, sample_rate=self.sample_rate,
                      duration=self.duration,
                      loudness_cutoff=self.loudness_cutoff,
                      num_channels=self.num_channels, offset=self.offset,
                      global_idx=idx if self.without_replacement else None)
        item = {keys[0]: self.loaders[keys[0]](**kwargs)}
        anchor = item[keys[0]]
        for key in keys[1:]:
            if self.aligned:
                kwargs.update(offset=anchor["signal"].metadata.get("offset"),
                              source_idx=anchor["source_idx"],
                              item_idx=anchor["item_idx"])
            item[key] = self.loaders[key](**kwargs)
        item = {k: item[k] for k in self.loaders}
        item["idx"] = idx
        if self.transform is not None:
            first = next(iter(self.loaders))
            item["transform_args"] = self.transform.instantiate(
                state=state, signal=item[first]["signal"])
        if len(self.loaders) == 1:
            item.update(item.pop(next(iter(self.loaders))))
        return item

    def __len__(self) -> int:
        return self.length

    @staticmethod
    def collate(list_of_dicts):
        from .collate import collate

        return collate(list_of_dicts)


class ConcatDataset(AudioDataset):
    """Round-robin over datasets by index."""

    def __init__(self, datasets: list):
        self.datasets = datasets

    def __len__(self) -> int:
        return sum(len(d) for d in self.datasets)

    def __getitem__(self, idx: int):
        return self.datasets[idx % len(self.datasets)][idx // len(self.datasets)]
