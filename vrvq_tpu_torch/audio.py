"""Signal: the minimal audio container the serving path uses.

Counterpart of the part of ``vrvq_tpu/audio.py`` that ``compress`` and
``decompress`` touch: ``audio_data`` is a numpy ``(B, C, T)`` array, loudness
is the BS.1770 meter of ``ops/loudness.py``, and the gain arithmetic is the
JAX package's line for line, so both packages hand the codec the same
samples. Wav files go through ``scipy.io.wavfile``; ``resample`` through
scipy's polyphase filter (``ops/resample.py``).
"""

from __future__ import annotations

import numpy as np

from .ops.loudness import integrated_loudness
from .ops.resample import resample_poly_np

GAIN_FACTOR = np.log(10) / 20
"""Multiply gain in dB by this to get the natural-log gain factor."""


class Signal:
    """Batched audio: ``audio_data`` (B, C, T), ``sample_rate`` in Hz."""

    def __init__(self, audio_data, sample_rate: int):
        audio_data = np.asarray(audio_data)
        if audio_data.ndim == 1:
            audio_data = audio_data[None, None, :]
        elif audio_data.ndim == 2:
            audio_data = audio_data[None, :, :]
        elif audio_data.ndim != 3:
            raise ValueError(f"audio_data must be 1/2/3-D, got {audio_data.ndim}")
        self.audio_data = audio_data
        self.sample_rate = int(sample_rate)

    @property
    def signal_length(self) -> int:
        return self.audio_data.shape[-1]

    @property
    def signal_duration(self) -> float:
        return self.signal_length / self.sample_rate

    def clone(self) -> "Signal":
        return Signal(np.array(self.audio_data), self.sample_rate)

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
    def load(cls, path) -> "Signal":
        """Read a wav file (PCM 8/16/32-bit or float) as float32 in [-1, 1]."""
        from scipy.io import wavfile

        sr, data = wavfile.read(path)
        if data.dtype == np.int16:
            data = data.astype(np.float32) / 32768.0
        elif data.dtype == np.int32:
            data = data.astype(np.float32) / 2147483648.0
        elif data.dtype == np.uint8:
            data = (data.astype(np.float32) - 128.0) / 128.0
        else:
            data = data.astype(np.float32)
        data = data[:, None] if data.ndim == 1 else data  # (T, C)
        return cls(data.T[None], sr)

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
