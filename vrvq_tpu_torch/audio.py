"""Signal: the audio container of the serving path and the data loader.

Counterpart of the part of ``vrvq_tpu/audio.py`` that ``compress``,
``decompress`` and the training loader touch: ``audio_data`` is a numpy
``(B, C, T)`` array, loudness is the BS.1770 meter of ``ops/loudness.py``,
and the gain and excerpt arithmetic is the JAX package's line for line, so
both packages hand the codec the same samples. Wav files are parsed here
(``read_wav``, the JAX package's numpy reader: only the excerpt's bytes are
read); ``resample`` goes through scipy's polyphase filter
(``ops/resample.py``). Wav only: flac and mp3 are not ported.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Optional, Tuple

import numpy as np

from .ops.loudness import integrated_loudness
from .ops.resample import resample_poly_np

GAIN_FACTOR = np.log(10) / 20
"""Multiply gain in dB by this to get the natural-log gain factor."""


@dataclasses.dataclass
class WavInfo:
    sample_rate: int
    num_channels: int
    num_frames: int
    bit_depth: int
    audio_format: int

    @property
    def duration(self) -> float:
        return self.num_frames / self.sample_rate


def _parse_wav_header(f) -> Tuple[WavInfo, int, int]:
    """RIFF/WAVE chunks -> (info, data offset, data size)."""
    riff = f.read(12)
    if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    fmt = data_offset = data_size = None
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            break
        cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
        if cid == b"fmt ":
            fmt = f.read(size)
            if size % 2:
                f.read(1)
        elif cid == b"data":
            data_offset, data_size = f.tell(), size
            f.seek(size + (size % 2), os.SEEK_CUR)
        else:
            f.seek(size + (size % 2), os.SEEK_CUR)
        if fmt is not None and data_offset is not None:
            break
    if fmt is None or data_offset is None:
        raise ValueError("missing fmt/data chunk")
    audio_format, channels, sample_rate = struct.unpack("<HHI", fmt[:8])
    bits = struct.unpack("<H", fmt[14:16])[0]
    if audio_format == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = struct.unpack("<H", fmt[24:26])[0]
    frame_bytes = channels * (bits // 8)
    frames = data_size // frame_bytes if frame_bytes else 0
    return (WavInfo(sample_rate, channels, frames, bits, audio_format),
            data_offset, data_size)


def wav_info(path) -> WavInfo:
    with open(path, "rb") as f:
        return _parse_wav_header(f)[0]


def read_wav(path, offset: float = 0.0,
             duration: Optional[float] = None) -> Tuple[np.ndarray, int]:
    """A wav file's excerpt -> ((C, T) float32 in [-1, 1], sample rate). PCM
    8/16/24/32-bit or float; seeks to ``offset`` seconds and reads
    ``duration`` seconds (to the end for None)."""
    with open(path, "rb") as f:
        info, data_offset, _ = _parse_wav_header(f)
        frame_bytes = (info.bit_depth // 8) * info.num_channels
        start = int(round(offset * info.sample_rate))
        n = (info.num_frames - start if duration is None
             else int(round(duration * info.sample_rate)))
        n = max(0, min(n, info.num_frames - start))
        f.seek(data_offset + start * frame_bytes)
        raw = f.read(n * frame_bytes)
    n_read = len(raw) // frame_bytes
    count = n_read * info.num_channels
    if info.audio_format == 1:
        if info.bit_depth == 16:
            data = np.frombuffer(raw, "<i2", count).astype(np.float32) / 32768.0
        elif info.bit_depth == 32:
            data = np.frombuffer(raw, "<i4", count).astype(np.float32) / 2147483648.0
        elif info.bit_depth == 24:
            b = np.frombuffer(raw, np.uint8, count * 3).reshape(-1, 3).astype(np.int32)
            vals = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            data = vals.astype(np.float32) / 8388608.0
        elif info.bit_depth == 8:
            data = (np.frombuffer(raw, np.uint8, count).astype(np.float32)
                    - 128.0) / 128.0
        else:
            raise ValueError(f"unsupported PCM bit depth {info.bit_depth}")
    elif info.audio_format == 3:
        dtype = "<f4" if info.bit_depth == 32 else "<f8"
        data = np.frombuffer(raw, dtype, count).astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV format {info.audio_format}")
    return data.reshape(n_read, info.num_channels).T.copy(), info.sample_rate


def random_state(state) -> np.random.RandomState:
    """``state`` itself if it is a RandomState, else one seeded with it."""
    if isinstance(state, np.random.RandomState):
        return state
    return np.random.RandomState(state)


class Signal:
    """Batched audio: ``audio_data`` (B, C, T), ``sample_rate`` in Hz, and a
    ``metadata`` dict (the excerpt's path, offset and duration)."""

    def __init__(self, audio_data, sample_rate: int,
                 metadata: Optional[dict] = None):
        audio_data = np.asarray(audio_data)
        if audio_data.ndim == 1:
            audio_data = audio_data[None, None, :]
        elif audio_data.ndim == 2:
            audio_data = audio_data[None, :, :]
        elif audio_data.ndim != 3:
            raise ValueError(f"audio_data must be 1/2/3-D, got {audio_data.ndim}")
        self.audio_data = audio_data
        self.sample_rate = int(sample_rate)
        self.metadata = dict(metadata or {})

    @property
    def batch_size(self) -> int:
        return self.audio_data.shape[0]

    @property
    def num_channels(self) -> int:
        return self.audio_data.shape[1]

    @property
    def signal_length(self) -> int:
        return self.audio_data.shape[-1]

    @property
    def signal_duration(self) -> float:
        return self.signal_length / self.sample_rate

    def clone(self) -> "Signal":
        return Signal(np.array(self.audio_data), self.sample_rate,
                      dict(self.metadata))

    @classmethod
    def zeros(cls, duration: float, sample_rate: int, num_channels: int = 1,
              batch_size: int = 1) -> "Signal":
        n = int(duration * sample_rate)
        return cls(np.zeros((batch_size, num_channels, n), np.float32),
                   sample_rate)

    @classmethod
    def excerpt(cls, path, offset: Optional[float] = None,
                duration: Optional[float] = None, state=None) -> "Signal":
        """An excerpt of ``duration`` seconds at ``offset``, or at an offset
        drawn uniformly from ``state`` over the file."""
        total = wav_info(path).duration
        if duration is None:
            duration = total
        state = random_state(state)
        if offset is None:
            offset = state.uniform(0.0, max(total - duration, 0.0))
        return cls.load(path, offset=offset, duration=duration)

    @classmethod
    def salient_excerpt(cls, path, loudness_cutoff: Optional[float] = None,
                        num_tries: int = 8, state=None, **kwargs) -> "Signal":
        """Excerpts drawn until one is louder than ``loudness_cutoff`` dB
        (the last of ``num_tries`` is kept)."""
        state = random_state(state)
        if loudness_cutoff is None:
            return cls.excerpt(path, state=state, **kwargs)
        loudness, tries, excerpt = -np.inf, 0, None
        while loudness <= loudness_cutoff:
            excerpt = cls.excerpt(path, state=state, **kwargs)
            loudness = excerpt.loudness()
            tries += 1
            if num_tries is not None and tries >= num_tries:
                break
        return excerpt

    def to_mono(self) -> "Signal":
        self.audio_data = self.audio_data.mean(axis=1, keepdims=True)
        return self

    def zero_pad(self, before: int, after: int) -> "Signal":
        self.audio_data = np.pad(np.asarray(self.audio_data),
                                 ((0, 0), (0, 0), (before, after)))
        return self

    def zero_pad_to(self, length: int, mode: str = "after") -> "Signal":
        pad = max(length - self.signal_length, 0)
        return self.zero_pad(pad, 0) if mode == "before" else self.zero_pad(0, pad)

    def truncate_samples(self, length: int) -> "Signal":
        self.audio_data = self.audio_data[..., :length]
        return self

    def resample(self, sample_rate: int) -> "Signal":
        if sample_rate == self.sample_rate:
            return self
        self.audio_data = resample_poly_np(
            np.asarray(self.audio_data), self.sample_rate, sample_rate)
        self.sample_rate = int(sample_rate)
        return self

    def loudness(self, block_size: float = 0.4) -> np.ndarray:
        """BS.1770 integrated loudness per batch item (LUFS), floored at -70."""
        data = np.asarray(self.audio_data, dtype=np.float32)
        out = integrated_loudness(
            data.astype(np.float64), self.sample_rate, block_size=block_size
        )
        return np.maximum(out, -70.0).astype(np.float32)

    def normalize(self, db: float = -24.0) -> "Signal":
        """Scale each batch item to ``db`` LUFS."""
        gain_db = db - self.loudness()
        gain = np.exp(gain_db * GAIN_FACTOR)
        self.audio_data = self.audio_data * np.reshape(gain, (-1, 1, 1))
        return self

    def ensure_max_of_audio(self, maximum: float = 1.0) -> "Signal":
        peak = np.abs(np.asarray(self.audio_data)).max(axis=(1, 2), keepdims=True)
        gain = np.minimum(maximum / np.maximum(peak, 1e-9), 1.0)
        self.audio_data = self.audio_data * gain
        return self

    @classmethod
    def load(cls, path, offset: float = 0.0,
             duration: Optional[float] = None) -> "Signal":
        """A wav file (or ``duration`` seconds of it from ``offset``) as
        float32 in [-1, 1]."""
        data, sr = read_wav(path, offset=offset, duration=duration)
        return cls(data[None], sr, {"path": str(path), "offset": offset,
                                    "duration": duration})

    def write(self, path) -> "Signal":
        """Write the first batch item as 16-bit PCM."""
        from scipy.io import wavfile

        frames = np.clip(np.asarray(self.audio_data[0], np.float32), -1.0, 1.0)
        pcm = np.round(frames * 32767.0).astype("<i2")
        wavfile.write(path, self.sample_rate, pcm.T)
        return self


def synthetic_clip(seconds: float, sample_rate: int, seed: int) -> np.ndarray:
    """A seeded test clip, (1, 1, T) float32: four tones under a slow
    envelope, plus noise."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * sample_rate)) / sample_rate
    x = np.zeros_like(t)
    for f, a in [(110.0, 0.2), (440.0, 0.15), (1250.0, 0.08), (3520.0, 0.04)]:
        x += a * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
    x *= 0.6 + 0.4 * np.sin(2 * np.pi * 0.5 * t)
    x += 0.02 * rng.randn(t.size)
    return x.astype(np.float32)[None, None, :]
