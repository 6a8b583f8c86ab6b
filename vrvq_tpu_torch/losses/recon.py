"""Reconstruction losses: L1, L2, SI-SDR, multi-scale STFT and mel.

Counterpart of ``vrvq_tpu/losses/recon.py`` on torch tensors ``(B, C, T)``.
The clamps are ``torch.maximum`` against a constant, as ``jnp.maximum`` is:
both split the gradient at a tie. ``|X|`` of a zero bin differentiates to 0
in both packages (torch's ``sgn(0) = 0``, JAX's zero replacement).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..ops import stft as stft_ops


def _clamped_log10_pow(x: torch.Tensor, eps: float, power: float) -> torch.Tensor:
    return torch.log10(torch.maximum(x, x.new_tensor(eps)) ** power)


@dataclasses.dataclass
class L1Loss:
    """Mean absolute difference."""

    weight: float = 1.0

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return torch.mean(torch.abs(x - y))


@dataclasses.dataclass
class L2Loss:
    """Mean squared difference."""

    weight: float = 1.0

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return torch.mean(torch.square(x - y))


@dataclasses.dataclass
class SISDRLoss:
    """Negative scale-invariant SDR. As in audiotools, the FIRST argument is
    the reference and the second the estimate."""

    scaling: bool = True
    reduction: str = "mean"
    zero_mean: bool = True
    clip_min: Optional[float] = None
    weight: float = 1.0

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        eps = 1e-8
        nb = x.shape[0]
        references = x.reshape(nb, 1, -1).transpose(1, 2)
        estimates = y.reshape(nb, 1, -1).transpose(1, 2)
        if self.zero_mean:
            references = references - references.mean(dim=1, keepdim=True)
            estimates = estimates - estimates.mean(dim=1, keepdim=True)
        ref_proj = torch.sum(references ** 2, dim=-2) + eps
        ref_on_est = torch.sum(estimates * references, dim=-2) + eps
        scale = (ref_on_est / ref_proj)[:, None, :] if self.scaling else 1.0
        e_true = scale * references
        e_res = estimates - e_true
        signal = torch.sum(e_true ** 2, dim=1)
        noise = torch.sum(e_res ** 2, dim=1)
        sdr = -10.0 * torch.log10(signal / noise + eps)
        if self.clip_min is not None:
            sdr = torch.maximum(sdr, sdr.new_tensor(self.clip_min))
        if self.reduction == "mean":
            return torch.mean(sdr)
        if self.reduction == "sum":
            return torch.sum(sdr)
        return sdr


@dataclasses.dataclass
class MultiScaleSTFTLoss:
    """L1 of log and linear STFT magnitudes, summed over window lengths
    (hop = window / 4)."""

    window_lengths: Sequence[int] = (2048, 512)
    clamp_eps: float = 1e-5
    mag_weight: float = 1.0
    log_weight: float = 1.0
    pow: float = 2.0
    weight: float = 1.0
    match_stride: bool = False
    window_type: Optional[str] = None

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        loss = 0.0
        for w in self.window_lengths:
            xs = torch.abs(stft_ops.stft(x, w, w // 4, self.window_type,
                                         self.match_stride))
            ys = torch.abs(stft_ops.stft(y, w, w // 4, self.window_type,
                                         self.match_stride))
            loss = loss + self.log_weight * torch.mean(torch.abs(
                _clamped_log10_pow(xs, self.clamp_eps, self.pow)
                - _clamped_log10_pow(ys, self.clamp_eps, self.pow)))
            loss = loss + self.mag_weight * torch.mean(torch.abs(xs - ys))
        return loss


@dataclasses.dataclass
class MelSpectrogramLoss:
    """L1 of log and linear mel spectrograms over several scales; with
    ``levels (B,)`` each clip's term is divided by its level (the JAX
    module applies ``log_weight`` in both branches)."""

    n_mels: Sequence[int] = (150, 80)
    window_lengths: Sequence[int] = (2048, 512)
    clamp_eps: float = 1e-5
    mag_weight: float = 1.0
    log_weight: float = 1.0
    pow: float = 2.0
    weight: float = 1.0
    match_stride: bool = False
    mel_fmin: Sequence[float] = (0.0, 0.0)
    mel_fmax: Sequence[Optional[float]] = (None, None)
    window_type: Optional[str] = None
    sample_rate: int = 44100

    def __call__(self, x: torch.Tensor, y: torch.Tensor,
                 levels: Optional[torch.Tensor] = None) -> torch.Tensor:
        loss = 0.0
        if levels is not None:
            levels = levels.reshape(-1)
        for n_mels, fmin, fmax, w in zip(self.n_mels, self.mel_fmin,
                                         self.mel_fmax, self.window_lengths):
            x_mels, y_mels = (
                stft_ops.mel_spectrogram(s, self.sample_rate, n_mels, w,
                                         w // 4, self.window_type,
                                         self.match_stride, fmin, fmax)
                for s in (x, y))
            log_diff = torch.abs(
                _clamped_log10_pow(x_mels, self.clamp_eps, self.pow)
                - _clamped_log10_pow(y_mels, self.clamp_eps, self.pow))
            mag_diff = torch.abs(x_mels - y_mels)
            if levels is None:
                loss = loss + self.log_weight * torch.mean(log_diff)
                loss = loss + self.mag_weight * torch.mean(mag_diff)
            else:
                per = (self.log_weight * torch.mean(log_diff, dim=(1, 2, 3))
                       + self.mag_weight * torch.mean(mag_diff, dim=(1, 2, 3)))
                loss = loss + torch.mean(per / levels)
        return loss
