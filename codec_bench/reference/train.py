"""The plain reference of one GAN train step: the MPD + MRD discriminator,
the multi-scale mel, LSGAN and feature-matching losses, the quantizer's
losses and rate, and global-norm clipping with AdamW.

Written from the published description (DAC's ``train.py`` and
discriminator, audiotools' losses, the VRVQ paper's rate loss) with the
upstream parameter names (``discriminators.{i}.convs.{j}.0.weight_v``,
``discriminators.{i}.band_convs.{b}.{j}.0.weight_v``, ``conv_post``; the
periods first, then the FFT sizes). Plain PyTorch, float32; imports nothing
of the program.

A step, in DAC's order: one generator forward; the discriminator's LSGAN
loss on the detached reconstruction, its gradient clipped to a global norm
of 10 and an AdamW update; the generator's losses against the updated
discriminator, weighted by ``lambdas``; its gradient clipped to 1e3 and an
AdamW update. AdamW: decoupled weight decay 1e-2, eps 1e-8, the learning
rate ``lr * gamma ** step`` of the update count before the update.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .codec import Codec


class WNConv2d(nn.Module):
    def __init__(self, cin, cout, k, stride=(1, 1), pad=(0, 0)):
        super().__init__()
        self.weight_v = nn.Parameter(torch.empty(cout, cin, *k))
        self.weight_g = nn.Parameter(torch.empty(cout, 1, 1, 1))
        self.bias = nn.Parameter(torch.empty(cout))
        self.stride, self.pad = stride, pad

    def forward(self, x):
        v = self.weight_v
        w = v * (self.weight_g / torch.sqrt(torch.sum(v * v, dim=(1, 2, 3), keepdim=True)))
        return F.conv2d(x, w, self.bias, self.stride, self.pad)


def _conv(cin, cout, k, stride, pad):
    return nn.Sequential(WNConv2d(cin, cout, k, stride, pad), nn.LeakyReLU(0.1))


class MPD(nn.Module):
    def __init__(self, period: int):
        super().__init__()
        self.period = period
        chans = [(1, 32), (32, 128), (128, 512), (512, 1024), (1024, 1024)]
        self.convs = nn.ModuleList(
            _conv(a, b, (5, 1), (3, 1) if j < 4 else (1, 1), (2, 0))
            for j, (a, b) in enumerate(chans))
        self.conv_post = WNConv2d(1024, 1, (3, 1), (1, 1), (1, 0))

    def forward(self, x):
        x = F.pad(x, (0, self.period - x.shape[-1] % self.period), mode="reflect")
        x = x.reshape(x.shape[0], 1, -1, self.period)
        fmap = []
        for conv in self.convs:
            x = conv(x)
            fmap.append(x)
        fmap.append(self.conv_post(x))
        return fmap


class MRD(nn.Module):
    def __init__(self, window: int, bands: Sequence[Sequence[float]]):
        super().__init__()
        self.window, self.hop = window, window // 4
        self.bands = [tuple(b) for b in bands]
        specs = [(2, (3, 9), (1, 1), (1, 4))] + [(32, (3, 9), (1, 2), (1, 4))] * 3 \
            + [(32, (3, 3), (1, 1), (1, 1))]
        self.band_convs = nn.ModuleList(
            nn.ModuleList(_conv(cin, 32, k, s, p) for cin, k, s, p in specs)
            for _ in self.bands)
        self.conv_post = WNConv2d(32, 1, (3, 3), (1, 1), (1, 1))

    def forward(self, x):
        x = x[:, 0]
        length = x.shape[-1]
        right = -(-length // self.hop) * self.hop - length
        pad = (self.window - self.hop) // 2
        x = F.pad(x[:, None], (pad, pad + right), mode="reflect")[:, 0]
        spec = torch.stft(x, self.window, self.hop, window=torch.hann_window(
            self.window, device=x.device), center=True, pad_mode="reflect",
            return_complex=True)[..., 2:-2]
        z = torch.stack([spec.real, spec.imag], 1).transpose(2, 3)
        n = self.window // 2 + 1
        fmap, outs = [], []
        for (lo, hi), convs in zip(self.bands, self.band_convs):
            b = z[..., int(lo * n):int(hi * n)]
            for conv in convs:
                b = conv(b)
                fmap.append(b)
            outs.append(b)
        fmap.append(self.conv_post(torch.cat(outs, dim=3)))
        return fmap


class Discriminator(nn.Module):
    def __init__(self, keys: dict):
        super().__init__()
        periods = keys["Discriminator.periods"]
        if keys.get("Discriminator.rates"):
            raise NotImplementedError("the reference has no multi-scale (MSD) part")
        self.discriminators = nn.ModuleList(
            [MPD(p) for p in periods]
            + [MRD(f, keys["Discriminator.bands"]) for f in keys["Discriminator.fft_sizes"]])

    def forward(self, x) -> List[List[torch.Tensor]]:
        x = x - x.mean(dim=-1, keepdim=True)
        x = 0.8 * x / (x.abs().amax(dim=-1, keepdim=True) + 1e-9)
        return [d(x) for d in self.discriminators]


def mel_basis(sr: int, n_fft: int, n_mels: int, fmin: float, fmax) -> np.ndarray:
    """The Slaney-scale, Slaney-normalised triangular filterbank of
    librosa's ``filters.mel``, (n_mels, n_fft // 2 + 1)."""
    fmax = sr / 2 if fmax is None else fmax

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        lin = f / (200.0 / 3)
        log = 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0)
        return np.where(f >= 1000.0, log, lin)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m >= 15.0, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)),
                        m * (200.0 / 3))

    freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    lower = (freqs[None, :] - pts[:-2, None]) / np.diff(pts)[:-1, None]
    upper = (pts[2:, None] - freqs[None, :]) / np.diff(pts)[1:, None]
    w = np.maximum(0, np.minimum(lower, upper)) * (2.0 / (pts[2:] - pts[:-2]))[:, None]
    return w.astype(np.float32)


class MelLoss:
    def __init__(self, keys: dict, sample_rate: int):
        g = lambda k, d=None: keys.get(f"MelSpectrogramLoss.{k}", d)  # noqa: E731
        self.scales = list(zip(g("n_mels"), g("window_lengths"), g("mel_fmin"), g("mel_fmax")))
        self.eps, self.pow = g("clamp_eps", 1e-5), g("pow", 2.0)
        self.mag_w, self.log_w = g("mag_weight", 1.0), g("log_weight", 1.0)
        self.sr = sample_rate
        self.bases: Dict[tuple, torch.Tensor] = {}

    def mel(self, x, n_mels, win, fmin, fmax):
        key = (n_mels, win, fmin, fmax, x.device)
        if key not in self.bases:
            self.bases[key] = torch.from_numpy(
                mel_basis(self.sr, win, n_mels, fmin, fmax)).to(x.device)
        spec = torch.stft(x.reshape(-1, x.shape[-1]), win, win // 4,
                          window=torch.hann_window(win, device=x.device),
                          center=True, pad_mode="reflect", return_complex=True).abs()
        return self.bases[key] @ spec

    def __call__(self, x, y):
        loss = 0.0
        for n_mels, win, fmin, fmax in self.scales:
            xm, ym = self.mel(x, n_mels, win, fmin, fmax), self.mel(y, n_mels, win, fmin, fmax)
            lx = torch.log10(torch.clamp(xm, min=self.eps) ** self.pow)
            ly = torch.log10(torch.clamp(ym, min=self.eps) ** self.pow)
            loss = loss + self.log_w * (lx - ly).abs().mean() + self.mag_w * (xm - ym).abs().mean()
        return loss


class AdamW:
    """Global-norm clip, then AdamW, on a list of parameters."""

    def __init__(self, params: List[torch.Tensor], keys: dict, max_norm: float):
        self.params = params
        self.lr = keys.get("AdamW.lr", 1e-4)
        self.b1, self.b2 = keys.get("AdamW.betas", (0.9, 0.999))
        self.gamma = keys.get("ExponentialLR.gamma", 1.0)
        self.max_norm, self.count = max_norm, 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.first_grad = None

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        if float(norm) >= self.max_norm:
            grads = [g / norm * self.max_norm for g in grads]
        if self.first_grad is None:
            self.first_grad = [g.clone() for g in grads]
        lr = float(np.float32(self.lr) * np.power(np.float32(self.gamma), np.float32(self.count)))
        self.count += 1
        bc1, bc2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            p.mul_(1 - lr * 1e-2)
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.addcdiv_(m, v.sqrt() / math.sqrt(bc2) + 1e-8, value=-lr / bc1)


class TrainStep:
    """Generator, discriminator, their optimizers and the losses of one
    configuration; ``step(audio, levels)`` returns the step's losses."""

    def __init__(self, gen: Codec, disc: Discriminator, keys: dict):
        self.gen, self.disc = gen, disc
        self.lambdas = keys["lambdas"]
        self.mel = MelLoss(keys, gen.sample_rate)
        self.opt_g = AdamW(list(gen.parameters()), keys, 1e3)
        self.opt_d = AdamW(list(disc.parameters()), keys, 10.0)

    def step(self, audio: torch.Tensor, levels: torch.Tensor) -> Dict[str, float]:
        out = self.gen.train_forward(audio, levels)
        recons = out["audio"]
        d_loss = sum(torch.mean(f[-1] ** 2) + torch.mean((1 - r[-1]) ** 2)
                     for f, r in zip(self.disc(recons.detach()), self.disc(audio)))
        self.opt_d.step(list(torch.autograd.grad(d_loss, self.opt_d.params)))

        fake, real = self.disc(recons), self.disc(audio)
        losses = {
            "mel/loss": self.mel(recons, audio),
            "adv/gen_loss": sum(torch.mean((1 - f[-1]) ** 2) for f in fake),
            "adv/feat_loss": sum(torch.mean((f[j] - r[j].detach()).abs())
                                 for f, r in zip(fake, real) for j in range(len(f) - 1)),
            "vq/commitment_loss": out["commitment"],
            "vq/codebook_loss": out["codebook"],
            "vq/rate_loss": torch.mean(out["imp_map"]),
        }
        loss = sum(w * losses[k] for k, w in self.lambdas.items() if k in losses)
        self.opt_g.step(list(torch.autograd.grad(loss, self.opt_g.params)))
        return {"loss": float(loss.detach()), "adv/disc_loss": float(d_loss.detach())}
