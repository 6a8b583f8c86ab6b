"""The GAN discriminator: multi-period (MPD), multi-scale waveform (MSD) and
multi-band complex-STFT (MRD) sub-discriminators.

Counterpart of ``vrvq_tpu/models/discriminator.py``, in PyTorch's layout:
2-D feature maps are ``(B, C, H, W)`` where the JAX package keeps
``(B, H, W, C)``, MSD's 1-D maps ``(B, C, T)`` where it keeps ``(B, T, C)``.
H is time in both (MPD: frames of ``period`` samples; MRD: STFT frames) and
W the period or the frequency bins. Each sub-discriminator returns its
feature maps, the logit map last. The flagship runs no MSD
(``Discriminator.rates: []``); a rate other than 1 resamples in the graph
(``ops/resample.resample``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import WNConv1d, weight_norm
from ..ops.resample import resample
from ..ops.stft import reflect_pad, stft

BANDS = ((0.0, 0.1), (0.1, 0.25), (0.25, 0.5), (0.5, 0.75), (0.75, 1.0))


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


class WNConv2d(nn.Module):
    """Weight-normed 2-D conv: ``v (out, in, kh, kw)``, ``g (out,)``, the norm
    per out-channel over (in, kh, kw); the bias added after the conv."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int], stride=(1, 1), padding=(0, 0)):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.stride = tuple(stride)
        self.padding = tuple(padding)
        self.v = nn.Parameter(torch.empty(out_channels, in_channels,
                                          *self.kernel_size))
        self.g = nn.Parameter(torch.empty(out_channels))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def weight(self) -> torch.Tensor:
        return weight_norm(self.v, self.g.reshape(-1, 1, 1, 1), (1, 2, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, self.weight(), None, self.stride, self.padding)
        return y + self.bias.reshape(1, -1, 1, 1)


class MPD(nn.Module):
    """Folds the waveform into ``(T / period, period)`` (reflect-padded up by
    ``period - T % period``, always at least one sample) and runs (5, 1)
    convs striding over time."""

    CHANNELS = ((1, 32), (32, 128), (128, 512), (512, 1024))

    def __init__(self, period: int):
        super().__init__()
        self.period = period
        for i, (cin, cout) in enumerate(self.CHANNELS):
            self.add_module(f"conv_{i}", WNConv2d(cin, cout, (5, 1), (3, 1), (2, 0)))
        self.conv_4 = WNConv2d(1024, 1024, (5, 1), (1, 1), (2, 0))
        self.conv_post = WNConv2d(1024, 1, (3, 1), (1, 1), (1, 0))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (B, 1, T) -> feature maps (B, C, T', period)."""
        pad = self.period - x.shape[-1] % self.period
        x = reflect_pad(x, 0, pad)
        x = x.reshape(x.shape[0], 1, -1, self.period)
        fmap = []
        for i in range(5):
            x = _leaky(getattr(self, f"conv_{i}")(x))
            fmap.append(x)
        fmap.append(self.conv_post(x))
        return fmap


class MSD(nn.Module):
    """The waveform at ``sample_rate // rate`` (resampled in the graph where
    ``rate`` is not 1) through six weight-normed 1-D convs, four of them
    grouped and strided, then one conv to logits."""

    # (in, out, kernel, stride, groups, padding)
    SPECS = (
        (1, 16, 15, 1, 1, 7),
        (16, 64, 41, 4, 4, 20),
        (64, 256, 41, 4, 16, 20),
        (256, 1024, 41, 4, 64, 20),
        (1024, 1024, 41, 4, 256, 20),
        (1024, 1024, 5, 1, 1, 2),
    )

    def __init__(self, rate: int = 1, sample_rate: int = 44100):
        super().__init__()
        self.rate = rate
        self.sample_rate = sample_rate
        for i, (cin, cout, k, s, g, p) in enumerate(self.SPECS):
            self.add_module(f"conv_{i}", WNConv1d(cin, cout, k, stride=s,
                                                  padding=p, groups=g))
        self.conv_post = WNConv1d(1024, 1, 3, padding=1)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (B, 1, T) -> feature maps (B, C, T')."""
        if self.rate != 1:
            x = resample(x, self.sample_rate, self.sample_rate // self.rate)
        fmap = []
        for i in range(len(self.SPECS)):
            x = _leaky(getattr(self, f"conv_{i}")(x))
            fmap.append(x)
        fmap.append(self.conv_post(x))
        return fmap


class MRD(nn.Module):
    """Complex STFT (``match_stride``, hop = window / 4) as two channels (real,
    imaginary) ``(B, 2, frames, bins)``, cut into frequency bands at
    ``int(lo * n_bins)``; a conv stack per band, the bands joined along
    frequency, one conv to logits."""

    SPECS = (
        (2, 32, (3, 9), (1, 1), (1, 4)),
        (32, 32, (3, 9), (1, 2), (1, 4)),
        (32, 32, (3, 9), (1, 2), (1, 4)),
        (32, 32, (3, 9), (1, 2), (1, 4)),
        (32, 32, (3, 3), (1, 1), (1, 1)),
    )

    def __init__(self, window_length: int, hop_factor: float = 0.25,
                 bands: Sequence[Tuple[float, float]] = BANDS):
        super().__init__()
        self.window_length = window_length
        self.hop_factor = hop_factor
        self.bands = tuple(tuple(b) for b in bands)
        for bi in range(len(self.bands)):
            for li, (cin, cout, k, s, p) in enumerate(self.SPECS):
                self.add_module(f"band_{bi}_conv_{li}", WNConv2d(cin, cout, k, s, p))
        self.conv_post = WNConv2d(32, 1, (3, 3), (1, 1), (1, 1))

    def spectrogram(self, x: torch.Tensor) -> List[torch.Tensor]:
        hop = int(self.window_length * self.hop_factor)
        spec = stft(x[:, 0], self.window_length, hop, None, match_stride=True)
        z = torch.stack([spec.real, spec.imag], dim=1).transpose(2, 3)
        n_bins = self.window_length // 2 + 1
        return [z[..., int(lo * n_bins):int(hi * n_bins)] for lo, hi in self.bands]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (B, 1, T) -> feature maps (B, C, frames, bins)."""
        fmap, outs = [], []
        for bi, z in enumerate(self.spectrogram(x)):
            for li in range(len(self.SPECS)):
                z = _leaky(getattr(self, f"band_{bi}_conv_{li}")(z))
                fmap.append(z)
            outs.append(z)
        fmap.append(self.conv_post(torch.cat(outs, dim=3)))
        return fmap


class Discriminator(nn.Module):
    """MPD at each period, MSD at each rate, then MRD at each FFT size, on the
    audio with its DC removed and its peak normalized to 0.8. Submodules are
    named and ordered as the JAX package's (``mpd_{period}``, ``msd_{rate}``,
    ``mrd_{n_fft}``)."""

    def __init__(self, rates: Sequence[int] = (),
                 periods: Sequence[int] = (2, 3, 5, 7, 11),
                 fft_sizes: Sequence[int] = (2048, 1024, 512),
                 sample_rate: int = 44100,
                 bands: Sequence[Tuple[float, float]] = BANDS):
        super().__init__()
        self.sample_rate = sample_rate
        self.names = ([f"mpd_{p}" for p in periods] + [f"msd_{r}" for r in rates]
                      + [f"mrd_{f}" for f in fft_sizes])
        for p in periods:
            self.add_module(f"mpd_{p}", MPD(p))
        for r in rates:
            self.add_module(f"msd_{r}", MSD(r, sample_rate))
        for f in fft_sizes:
            self.add_module(f"mrd_{f}", MRD(f, bands=bands))

    @staticmethod
    def preprocess(y: torch.Tensor) -> torch.Tensor:
        y = y - torch.mean(y, dim=-1, keepdim=True)
        peak = torch.amax(torch.abs(y), dim=-1, keepdim=True)
        return 0.8 * y / (peak + 1e-9)

    def forward(self, x: torch.Tensor) -> List[List[torch.Tensor]]:
        """x (B, 1, T) -> one feature-map list per sub-discriminator."""
        y = self.preprocess(x)
        return [getattr(self, name)(y) for name in self.names]
