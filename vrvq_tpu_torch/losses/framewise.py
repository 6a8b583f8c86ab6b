"""Framewise losses: per-window loss maps ``(B, n_frames)`` for
rate-distortion analysis (not used by the training loop).

Counterpart of ``vrvq_tpu/losses/framewise.py`` on torch tensors
``(B, C, T)``: SI-SDR and L1 over non-overlapping windows of
``window_size`` samples (T a multiple of it), and the mel loss of
non-overlapping frames (hop = window, no centre padding) on
``ops/stft.py``'s Hann window and slaney mel basis.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..ops import stft as stft_ops
from .recon import SISDRLoss


def _windows(x: torch.Tensor, window_size: int) -> torch.Tensor:
    """(B, C, T) -> (B * n_frames, C, window_size), frame-major per item."""
    nb, nc, nt = x.shape
    assert nt % window_size == 0, f"nt: {nt}, window_size: {window_size}"
    n_frames = nt // window_size
    x = x.reshape(nb, nc, n_frames, window_size).transpose(1, 2)
    return x.reshape(nb * n_frames, nc, window_size)


@dataclasses.dataclass
class SISDRLossFramewise:
    """Negative SI-SDR of each window (the reference first, as in
    ``SISDRLoss``)."""

    scaling: bool = True
    zero_mean: bool = True
    clip_min: Optional[float] = None
    weight: float = 1.0

    def __call__(self, x: torch.Tensor, y: torch.Tensor,
                 window_size: int = 512) -> torch.Tensor:
        nb, n_frames = x.shape[0], x.shape[-1] // window_size
        loss = SISDRLoss(scaling=self.scaling, reduction="none",
                         zero_mean=self.zero_mean, clip_min=self.clip_min)(
            _windows(x, window_size), _windows(y, window_size))
        return loss.reshape(nb, n_frames)


@dataclasses.dataclass
class L1LossFramewise:
    """Mean absolute difference of each window, over channels and samples."""

    def __call__(self, x: torch.Tensor, y: torch.Tensor,
                 window_size: int = 512) -> torch.Tensor:
        nb, nc, nt = x.shape
        assert nt % window_size == 0
        diff = torch.abs(x - y).reshape(nb, nc, nt // window_size, window_size)
        return torch.mean(diff, dim=(1, 3))


@dataclasses.dataclass
class MelSpectrogramLossFramewise:
    """Per-frame mel loss with hop = window (no centre padding), summed over
    the scales; the first channel's map."""

    n_mels: Sequence[int] = (160, 80, 40, 20)
    window_lengths: Sequence[int] = (512, 512, 512, 512)
    clamp_eps: float = 1e-5
    mag_weight: float = 0.0
    log_weight: float = 1.0
    pow: float = 1.0
    weight: float = 1.0
    mel_fmin: Sequence[float] = (0.0, 0.0, 0.0, 0.0)
    mel_fmax: Sequence[Optional[float]] = (None, None, None, None)
    sr: int = 44100

    def _mel(self, x: torch.Tensor, n_mels: int, w: int, fmin, fmax) -> torch.Tensor:
        """(B, C, T) -> (B, C, n_mels, frames): power spectra of whole
        windows through the mel basis."""
        nb, nc, nt = x.shape
        n_frames = nt // w
        frames = x[..., : n_frames * w].reshape(nb, nc, n_frames, w)
        window = torch.from_numpy(stft_ops.get_window("hann", w)).to(x)
        spec = torch.abs(torch.fft.rfft(frames * window, dim=-1)) ** 2
        basis = torch.from_numpy(stft_ops.mel_filterbank(
            self.sr, w, n_mels, fmin, fmax or self.sr / 2)).to(x)
        return torch.einsum("bctf,mf->bcmt", spec, basis)

    def __call__(self, x: torch.Tensor, y: torch.Tensor,
                 window_size=None) -> torch.Tensor:
        loss = 0.0
        eps = x.new_tensor(self.clamp_eps)
        for n_mels, w, fmin, fmax in zip(self.n_mels, self.window_lengths,
                                         self.mel_fmin, self.mel_fmax):
            xm = self._mel(x, n_mels, w, fmin, fmax)
            ym = self._mel(y, n_mels, w, fmin, fmax)
            il = self.log_weight * torch.abs(
                torch.log10(torch.maximum(xm, eps) ** self.pow)
                - torch.log10(torch.maximum(ym, eps) ** self.pow))
            if self.mag_weight > 0:
                il = il + self.mag_weight * torch.abs(xm - ym)
            loss = loss + torch.mean(il, dim=2)  # (B, C, frames)
        return loss[:, 0, :]
