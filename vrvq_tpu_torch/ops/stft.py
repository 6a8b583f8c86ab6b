"""STFT and mel spectrogram in the audiotools conventions.

Counterpart of ``vrvq_tpu/ops/stft.py``, on torch tensors ``(..., T)``:

  * the signal is reflect-padded by ``n_fft // 2`` on both sides (torch.stft
    ``center=True``) and framed with a periodic window;
  * ``match_stride=True`` first right-pads the signal to a hop multiple and
    reflect-pads ``(win - hop) // 2`` on both sides, then drops the two edge
    frames on each side, so the frame count is ``ceil(T / hop)``;
  * mel filterbanks are librosa's (slaney scale, slaney norm), built in numpy.

Frames are a strided view (``unfold``) through ``torch.fft.rfft``, the JAX
package's gather through ``jnp.fft.rfft``: both differentiate.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=64)
def get_window(window_type: Optional[str], window_length: int) -> np.ndarray:
    """Periodic windows (``scipy.signal.get_window(..., fftbins=True)``),
    float32."""
    n = np.arange(window_length)
    if window_type in (None, "hann"):
        w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / window_length)
    elif window_type == "sqrt_hann":
        w = np.sqrt(0.5 - 0.5 * np.cos(2.0 * np.pi * n / window_length))
    elif window_type in ("ones", "rectangular"):
        w = np.ones(window_length)
    else:
        raise ValueError(f"Unsupported window type: {window_type}")
    return w.astype(np.float32)


def compute_stft_padding(length: int, window_length: int, hop_length: int,
                         match_stride: bool) -> Tuple[int, int]:
    """``(right_pad, pad)`` of audiotools' ``compute_stft_padding``."""
    if not match_stride:
        return 0, 0
    if hop_length != window_length // 4:
        raise ValueError("match_stride requires hop == window_length // 4")
    right_pad = -(-length // hop_length) * hop_length - length
    return right_pad, (window_length - hop_length) // 2


def _window(window_type, window_length, like: torch.Tensor) -> torch.Tensor:
    return on_device(get_window, (window_type, window_length), like.device, like.dtype)


@functools.lru_cache(maxsize=64)
def on_device(build, args: tuple, device: torch.device,
              dtype: torch.dtype) -> torch.Tensor:
    """``build(*args)`` (a numpy array) as a tensor on ``device``, copied
    there once: a copy from the host at every call would make the host wait
    for the stream. Made outside inference mode, so that a graph that is
    differentiated may use it whatever mode first asked for it."""
    with torch.inference_mode(False):
        return torch.from_numpy(build(*args)).to(device=device, dtype=dtype)


def stft(x: torch.Tensor, window_length: int, hop_length: int,
         window_type: Optional[str] = None, match_stride: bool = False,
         padding_type: str = "reflect") -> torch.Tensor:
    """Complex STFT of ``(..., T)`` -> ``(..., n_fft // 2 + 1, frames)``."""
    lead, length = x.shape[:-1], x.shape[-1]
    right_pad, pad = compute_stft_padding(length, window_length, hop_length,
                                          match_stride)
    y = x.reshape(-1, 1, length)  # F.pad's reflect mode wants (N, C, T)
    if pad or right_pad:
        y = F.pad(y, (pad, pad + right_pad), mode=padding_type)
    half = window_length // 2
    y = F.pad(y, (half, half), mode="reflect")[:, 0]
    frames = y.unfold(-1, window_length, hop_length)  # (N, frames, win)
    spec = torch.fft.rfft(frames * _window(window_type, window_length, y), dim=-1)
    spec = spec.transpose(-1, -2)
    spec = spec.reshape(*lead, *spec.shape[-2:])
    if match_stride:
        spec = spec[..., 2:-2]
    return spec


def istft(spec: torch.Tensor, window_length: int, hop_length: int,
          length: int, window_type: Optional[str] = None) -> torch.Tensor:
    """Inverse of ``stft`` (``center=True``, no ``match_stride``): windowed
    overlap-add normalized by the summed squared window.
    ``(..., n_freq, frames)`` -> ``(..., length)``."""
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=window_length, dim=-1)
    window = _window(window_type, window_length, frames)
    frames = frames * window
    n_frames = frames.shape[-2]
    total = window_length + hop_length * (n_frames - 1)
    lead = frames.shape[:-2]
    idx = (torch.arange(n_frames, device=frames.device)[:, None] * hop_length
           + torch.arange(window_length, device=frames.device)[None, :]).reshape(-1)
    flat = frames.reshape(-1, n_frames * window_length)
    sig = flat.new_zeros(flat.shape[0], total).index_add_(1, idx, flat)
    wsum = flat.new_zeros(total).index_add_(0, idx, (window * window).repeat(n_frames))
    sig = sig / torch.clamp(wsum, min=1e-11)
    half = window_length // 2
    return sig[:, half:half + length].reshape(*lead, -1)


def _hz_to_mel_slaney(f) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    mels)


def _mel_to_hz_slaney(mels) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mels >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)


@functools.lru_cache(maxsize=64)
def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int,
                   fmin: float = 0.0, fmax: Optional[float] = None) -> np.ndarray:
    """``librosa.filters.mel(htk=False, norm='slaney')``:
    ``(n_mels, n_fft // 2 + 1)`` float32."""
    if fmax is None:
        fmax = sample_rate / 2.0
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    mel_min = _hz_to_mel_slaney(np.array([fmin]))[0]
    mel_max = _hz_to_mel_slaney(np.array([fmax]))[0]
    hz_pts = _mel_to_hz_slaney(np.linspace(mel_min, mel_max, n_mels + 2))
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


def mel_spectrogram(x: torch.Tensor, sample_rate: int, n_mels: int,
                    window_length: int, hop_length: int,
                    window_type: Optional[str] = None,
                    match_stride: bool = False, mel_fmin: float = 0.0,
                    mel_fmax: Optional[float] = None) -> torch.Tensor:
    """``(..., T)`` -> ``(..., n_mels, frames)``: ``|STFT|`` through the
    slaney mel filterbank."""
    mag = torch.abs(stft(x, window_length, hop_length, window_type,
                         match_stride))
    basis = on_device(mel_filterbank, (sample_rate, window_length, n_mels, mel_fmin,
                                       mel_fmax), mag.device, torch.float32)
    return torch.einsum("...ft,mf->...mt", mag, basis)
