"""The plain reference codec: DAC's encoder and decoder with VRVQ's
importance-gated residual VQ, in plain PyTorch and float32.

Written from the published description (Descript's DAC, the VRVQ paper and
its ``conf/`` files), with the upstream PyTorch module tree, so that its
``state_dict`` has the upstream names and shapes (``encoder.block.0.
weight_v``, ``quantizer.quantizers.3.codebook.weight``, ...). It uses no
kernel, cache or batching of the program and imports nothing of it.

* Weight norm: ``w = g * v / ||v||``, the norm per output channel over the
  rest of ``v`` (per input channel of a transposed conv, whose ``v`` is
  ``(in, out, k)``).
* Snake: ``x + sin(alpha x)^2 / (alpha + 1e-9)``.
* ``padding=False`` is the padding-free codec of the windowed and streaming
  paths: no conv pads, a residual unit crops its skip path to the centre of
  its output. The importance subnet stays padded and its map is cropped to
  the latent frames.
* VBR: stage ``i`` of a frame is kept iff ``imp * level * Nq - i >= 0``.
* Nearest code: the largest cosine between the in-projection and the
  codebook rows (both l2-normalised), the first of equal ones.
* Train mode: a level per row (pinned by the caller), the first
  ``B - int(B * full_codebook_rate)`` rows masked by importance (a
  straight-through logcosh mask), the rest keep every stage; straight-
  through codes; per-stage commitment and codebook losses under the mask.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def wn(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    dims = tuple(range(1, v.ndim))
    return v * (g / torch.sqrt(torch.sum(v * v, dim=dims, keepdim=True)))


class WNConv(nn.Module):
    """A weight-normed 1-D conv (or transposed conv) with the upstream
    parameter names. ``pad`` is applied only where the model pads."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 pad: int = 0, dilation: int = 1, transposed: bool = False):
        super().__init__()
        shape = (cin, cout, k) if transposed else (cout, cin, k)
        self.weight_v = nn.Parameter(torch.empty(shape))
        self.weight_g = nn.Parameter(torch.empty(shape[0], 1, 1))
        self.bias = nn.Parameter(torch.empty(cout))
        self.k, self.stride, self.pad, self.dilation = k, stride, pad, dilation
        self.transposed = transposed
        self.padded = True
        self.round = None  # a rounding of input, weight and output (a lower precision)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = wn(self.weight_v, self.weight_g).to(x.dtype)
        if self.round is not None:
            x, w = self.round(x), self.round(w)
        pad = self.pad if self.padded else 0
        if self.transposed:
            y = F.conv_transpose1d(x, w, self.bias.to(x.dtype), self.stride, pad)
        else:
            y = F.conv1d(x, w, self.bias.to(x.dtype), self.stride, pad, self.dilation)
        return y if self.round is None else self.round(y)


class Snake(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(1, channels, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.alpha.to(x.dtype)
        return x + (a + 1e-9).reciprocal() * torch.sin(a * x).pow(2)


class ResidualUnit(nn.Module):
    def __init__(self, dim: int, dilation: int):
        super().__init__()
        self.block = nn.Sequential(
            Snake(dim), WNConv(dim, dim, 7, pad=3 * dilation, dilation=dilation),
            Snake(dim), WNConv(dim, dim, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.block(x)
        crop = (x.shape[-1] - y.shape[-1]) // 2
        if crop > 0:
            x = x[..., crop:-crop]
        return x + y


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, stride: int):
        super().__init__()
        half = dim // 2
        self.block = nn.Sequential(
            ResidualUnit(half, 1), ResidualUnit(half, 3), ResidualUnit(half, 9),
            Snake(half),
            WNConv(half, dim, 2 * stride, stride=stride, pad=math.ceil(stride / 2)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class Encoder(nn.Module):
    def __init__(self, d_model: int, strides: Sequence[int], latent: int):
        super().__init__()
        layers = [WNConv(1, d_model, 7, pad=3)]
        d = d_model
        for s in strides:
            d *= 2
            layers.append(EncoderBlock(d, s))
        layers += [Snake(d), WNConv(d, latent, 3, pad=1)]
        self.block = nn.Sequential(*layers)
        self.n_blocks = len(strides)

    def forward(self, x: torch.Tensor):
        """(latents, the feature after the last block)."""
        for layer in self.block[:self.n_blocks + 1]:
            x = layer(x)
        feat = x
        return self.block[self.n_blocks + 2](self.block[self.n_blocks + 1](x)), feat


class DecoderBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.block = nn.Sequential(
            Snake(cin),
            WNConv(cin, cout, 2 * stride, stride=stride,
                   pad=math.ceil(stride / 2), transposed=True),
            ResidualUnit(cout, 1), ResidualUnit(cout, 3), ResidualUnit(cout, 9))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class Decoder(nn.Module):
    def __init__(self, latent: int, channels: int, rates: Sequence[int]):
        super().__init__()
        layers = [WNConv(latent, channels, 7, pad=3)]
        out = channels
        for i, s in enumerate(rates):
            cin, out = channels // 2 ** i, channels // 2 ** (i + 1)
            layers.append(DecoderBlock(cin, out, s))
        layers += [Snake(out), WNConv(out, 1, 7, pad=3), nn.Tanh()]
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class VectorQuantize(nn.Module):
    def __init__(self, dim: int, size: int, code_dim: int):
        super().__init__()
        self.in_proj = WNConv(dim, code_dim, 1)
        self.out_proj = WNConv(code_dim, dim, 1)
        self.codebook = nn.Embedding(size, code_dim)

    def nearest(self, z_e: torch.Tensor) -> torch.Tensor:
        """(B, d, T) -> codes (B, T)."""
        e = F.normalize(z_e.transpose(1, 2).float(), dim=-1)
        c = F.normalize(self.codebook.weight.float(), dim=-1)
        return torch.argmax(e @ c.T, dim=-1)

    def lookup(self, codes: torch.Tensor) -> torch.Tensor:
        return self.codebook.weight[codes].transpose(1, 2)


class ImportanceSubnet(nn.Module):
    def __init__(self, dim: int, widths=(512, 128, 32, 8, 1)):
        super().__init__()
        self.in_block = nn.Sequential(Snake(dim), WNConv(dim, dim, 3, pad=1))
        ins = [dim] + list(widths[:-1])
        self.blocks = nn.ModuleList(
            nn.Sequential(Snake(a), WNConv(a, b, 3, pad=1))
            for a, b in zip(ins, widths))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.in_block(x)
        for block in self.blocks:
            x = block(x)
        return torch.sigmoid(x)


class Quantizer(nn.Module):
    def __init__(self, dim: int, n_codebooks: int, size: int, code_dim: int):
        super().__init__()
        self.quantizers = nn.ModuleList(
            VectorQuantize(dim, size, code_dim) for _ in range(n_codebooks))
        self.imp_subnet = ImportanceSubnet(dim)


def logcosh_mask(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """The smooth step of the straight-through mask at ``x = imp * level *
    Nq - i``: 0.5 + (log cosh(alpha (x + 1/2)) - log cosh(alpha (x - 1/2)))
    / (2 alpha), written as the two overflow-free branches of the paper's
    code."""
    pos = (x >= 0).to(x.dtype)
    xp, xn = x * pos, x * (1 - pos)
    m1 = (torch.log(math.exp(alpha) + torch.exp(-2 * xp * alpha) + 1e-10)
          - torch.log(torch.exp(alpha * (1 - 2 * xp)) + 1 + 1e-10)) / (2 * alpha) + 0.5
    m2 = (torch.log(torch.exp(alpha * (2 * xn + 1)) + 1 + 1e-10)
          - torch.log(math.exp(alpha) + torch.exp(2 * alpha * xn) + 1e-10)) / (2 * alpha) + 0.5
    return m1 * pos + m2 * (1 - pos)


class Codec(nn.Module):
    """The VBR codec of a configuration file's ``DAC_VRVQ.*`` keys."""

    def __init__(self, keys: dict, padding: bool = True):
        super().__init__()
        k = {n.split(".", 1)[1]: v for n, v in keys.items() if n.startswith("DAC_VRVQ.")}
        self.sample_rate = k["sample_rate"]
        self.n_q = k["n_codebooks"]
        self.hop = math.prod(k["encoder_rates"])
        self.alpha = k.get("imp2mask_alpha", 1.0)
        self.full_rate = k.get("full_codebook_rate", 0.0)
        latent = k["encoder_dim"] * 2 ** len(k["encoder_rates"])
        self.encoder = Encoder(k["encoder_dim"], k["encoder_rates"], latent)
        self.quantizer = Quantizer(latent, self.n_q, k["codebook_size"], k["codebook_dim"])
        self.decoder = Decoder(latent, k["decoder_dim"], k["decoder_rates"])
        for name, m in self.named_modules():
            if isinstance(m, WNConv) and not name.startswith("quantizer.imp_subnet"):
                m.padded = padding

    # ------------------------------------------------------------ serving
    def importance(self, feat: torch.Tensor, frames: int) -> torch.Tensor:
        imp = self.quantizer.imp_subnet(feat)
        extra = imp.shape[-1] - frames
        if extra > 0:
            imp = imp[..., extra // 2: extra // 2 + frames]
        return imp

    def thresholds(self, x: torch.Tensor) -> torch.Tensor:
        return torch.arange(self.n_q, device=x.device, dtype=x.dtype).reshape(1, -1, 1)

    @torch.no_grad()
    def encode(self, audio: torch.Tensor, level: float):
        """audio (B, 1, T), a hop multiple -> (codes (B, Nq, F) int64, counts
        (B, F) int64): every stage's code, and the stages each frame keeps."""
        z, feat = self.encoder(audio)
        residual, codes = z, []
        for q in self.quantizer.quantizers:
            c = q.nearest(q.in_proj(residual))
            residual = residual - q.out_proj(q.lookup(c).to(residual.dtype))
            codes.append(c)
        imp = self.importance(feat, z.shape[-1])
        mask = (imp * level * self.n_q - self.thresholds(imp)) >= 0
        return torch.stack(codes, 1), mask.sum(1)

    @torch.no_grad()
    def decode(self, codes: torch.Tensor, counts: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """codes (B, Nq, F), counts (B, F) -> audio (B, 1, T) float32; the
        decoder's convs in ``dtype``."""
        mask = (self.thresholds(counts.float()) < counts[:, None, :]).float()
        z = 0.0
        for i, q in enumerate(self.quantizer.quantizers):
            z = z + q.out_proj(q.lookup(codes[:, i])) * mask[:, i:i + 1]
        return self.decoder(z.to(dtype)).float()

    # ----------------------------------------------------------- training
    def train_forward(self, audio: torch.Tensor, levels: torch.Tensor) -> dict:
        """The train-mode forward at pinned ``levels (B,)``: audio (trimmed to
        the input), the masked commitment and codebook losses and the
        importance rows' map."""
        length = audio.shape[-1]
        audio = F.pad(audio, (0, -(-length // self.hop) * self.hop - length))
        z, feat = self.encoder(audio)
        residual, z_q_is, commits, cbs = z, [], [], []
        for q in self.quantizer.quantizers:
            z_e = q.in_proj(residual)
            z_c = q.lookup(q.nearest(z_e))
            commits.append(torch.mean((z_e - z_c.detach()) ** 2, dim=1))
            cbs.append(torch.mean((z_c - z_e.detach()) ** 2, dim=1))
            z_q_i = q.out_proj(z_e + (z_c - z_e).detach())
            z_q_is.append(z_q_i)
            residual = residual - z_q_i
        bs, frames = z.shape[0], z.shape[-1]
        imp = self.importance(feat, frames)
        x = imp * levels.reshape(-1, 1, 1) * self.n_q - self.thresholds(imp)
        smooth = logcosh_mask(x, self.alpha)
        mask = smooth + ((x >= 0).to(x.dtype) - smooth).detach()
        n_imps = bs - int(bs * self.full_rate)
        mask = torch.cat([mask[:n_imps], torch.ones_like(mask[n_imps:])])
        z_q = sum(z_q_is[i] * mask[:, i:i + 1] for i in range(self.n_q))
        sg = mask.detach()
        return {
            "audio": self.decoder(z_q)[..., :length],
            "commitment": torch.mean(torch.sum(torch.stack(commits, 1) * sg, 1)),
            "codebook": torch.mean(torch.sum(torch.stack(cbs, 1) * sg, 1)),
            "imp_map": imp[:n_imps],
        }
