"""Signal: the audio container of the serving path and the data loader.

Counterpart of the part of ``vrvq_tpu/audio.py`` that ``compress``,
``decompress`` and the training loader touch: ``audio_data`` is a numpy
``(B, C, T)`` array, loudness is the BS.1770 meter of the native library
(``native/io.py``; the numpy meter of ``ops/loudness.py`` where it is not
built),
and the gain and excerpt arithmetic is the JAX package's line for line, so
both packages hand the codec the same samples. Files of every format of
``data/audio_io.AUDIO_EXTENSIONS`` (wav, flac, mp3, mp4, m4a) load through
``read_audio`` and ``audio_info``; ``write`` writes 16-bit PCM wav through
``write_wav``; ``resample`` goes through scipy's polyphase filter
(``ops/resample.py``). The spectral views (``stft``, ``magnitude``,
``log_magnitude``, ``mel_spectrogram``) go through ``ops/stft.py`` with the
signal's ``STFTParams`` (audiotools' defaults) and return torch tensors on
the CPU, where the samples are.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from .data.audio_io import audio_info, read_audio, write_wav
from .native import io as native_io
from .ops.loudness import integrated_loudness
from .ops import stft as stft_ops
from .ops.resample import resample_poly_np

GAIN_FACTOR = np.log(10) / 20
"""Multiply gain in dB by this to get the natural-log gain factor."""


@dataclasses.dataclass
class STFTParams:
    """The STFT's settings (audiotools' ``STFTParams`` defaults)."""

    window_length: int = 2048
    hop_length: int = 512
    window_type: Optional[str] = None
    match_stride: bool = False
    padding_type: str = "reflect"


def random_state(state) -> np.random.RandomState:
    """``state`` itself if it is a RandomState, else one seeded with it."""
    if isinstance(state, np.random.RandomState):
        return state
    return np.random.RandomState(state)


class Signal:
    """Batched audio: ``audio_data`` (B, C, T), ``sample_rate`` in Hz, the
    ``stft_params`` of its spectral views (by default a window of 32 ms
    rounded up to a power of two, hop a quarter of it: 2048 / 512 at
    44.1 kHz, as audiotools), and a ``metadata`` dict (the excerpt's path,
    offset and duration)."""

    def __init__(self, audio_data, sample_rate: int,
                 stft_params: Optional[STFTParams] = None,
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
        if stft_params is None:
            window = 2 ** int(math.ceil(math.log2(0.032 * self.sample_rate)))
            stft_params = STFTParams(window_length=window, hop_length=window // 4)
        self.stft_params = stft_params
        self.metadata = dict(metadata or {})
        self.stft_data = None

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
                      self.stft_params, dict(self.metadata))

    def numpy(self) -> np.ndarray:
        return np.asarray(self.audio_data)

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
        total = audio_info(path).duration
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
        """BS.1770 integrated loudness per batch item (LUFS), floored at -70:
        the native meter's where the library is built, as the JAX package
        measures, else the numpy meter's."""
        data = np.asarray(self.audio_data, dtype=np.float32)
        if native_io.library() is not None:
            out = np.asarray([native_io.loudness(item, self.sample_rate, block_size)
                              for item in data], np.float64)
        else:
            out = integrated_loudness(data.astype(np.float64), self.sample_rate,
                                      block_size=block_size)
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
        """An audio file of any supported format (or ``duration`` seconds of
        it from ``offset``) as float32 in [-1, 1]."""
        data, sr = read_audio(path, offset=offset, duration=duration)
        return cls(data[None], sr, metadata={"path": str(path), "offset": offset,
                                             "duration": duration})

    # ------------------------------------------------------------- spectral
    def _samples(self) -> torch.Tensor:
        return torch.as_tensor(np.asarray(self.audio_data))

    def stft(self, window_length: Optional[int] = None,
             hop_length: Optional[int] = None,
             window_type: Optional[str] = None,
             match_stride: Optional[bool] = None) -> torch.Tensor:
        """The complex STFT (B, C, n_fft / 2 + 1, frames), each setting the
        signal's ``stft_params`` unless given; kept as ``stft_data``."""
        p = self.stft_params
        self.stft_data = stft_ops.stft(
            self._samples(), window_length or p.window_length,
            hop_length or p.hop_length,
            window_type if window_type is not None else p.window_type,
            match_stride if match_stride is not None else p.match_stride)
        return self.stft_data

    @property
    def magnitude(self) -> torch.Tensor:
        """``|stft_data|``, the STFT taken first if there is none."""
        if self.stft_data is None:
            self.stft()
        return torch.abs(self.stft_data)

    def log_magnitude(self, ref_value: float = 1.0,
                      amin: float = 1e-5) -> torch.Tensor:
        """``20 log10(max(|STFT|, amin) / ref_value)``."""
        return 20.0 * torch.log10(torch.clamp(self.magnitude, min=amin) / ref_value)

    def mel_spectrogram(self, n_mels: int = 80, mel_fmin: float = 0.0,
                        mel_fmax: Optional[float] = None,
                        **kwargs) -> torch.Tensor:
        """The slaney mel spectrogram (B, C, n_mels, frames); ``kwargs``
        override ``stft_params``' window_length, hop_length, window_type and
        match_stride."""
        p = self.stft_params
        return stft_ops.mel_spectrogram(
            self._samples(), self.sample_rate, n_mels,
            kwargs.get("window_length", p.window_length),
            kwargs.get("hop_length", p.hop_length),
            kwargs.get("window_type", p.window_type),
            kwargs.get("match_stride", p.match_stride), mel_fmin, mel_fmax)

    def write(self, path) -> "Signal":
        """Write the first batch item as a 16-bit PCM wav."""
        write_wav(path, np.asarray(self.audio_data[0]), self.sample_rate)
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
