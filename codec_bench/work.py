"""The work a cell asks of the card, counted from the architecture and the
input sizes alone, whatever implements it: the operations of every conv,
projection and codebook search (2 a multiply-add), and the bytes of every
Snake. ``codec_bench/tests/test_work.py`` holds these counts equal to a count taken by
hooks on the plain reference's layers.

A conv of ``cin -> cout`` channels, ``k`` taps and ``t_out`` output frames
costs ``t_out * cout * cin * k`` multiply-adds a row; a transposed conv
``t_in * cin * cout * k``. Snake reads and writes each element once and
reads its channel's alpha (``roofline.snake_bound``'s bytes)."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple


def _conv_out(t: int, k: int, stride: int, pad: int, dil: int = 1) -> int:
    return (t + 2 * pad - dil * (k - 1) - 1) // stride + 1


def _model(keys: dict) -> dict:
    k = {n.split(".", 1)[1]: v for n, v in keys.items() if n.startswith("DAC_VRVQ.")}
    k["latent"] = k["encoder_dim"] * 2 ** len(k["encoder_rates"])
    return k


class Census:
    """Multiply-adds and Snake calls of one stack, walked in order."""

    def __init__(self, padding: bool = True):
        self.padding = padding
        self.macs = 0
        self.snakes: List[Tuple[int, int]] = []  # (channels, frames) a row

    def conv(self, t, cin, cout, k, stride=1, pad=0, dil=1):
        pad = pad if self.padding else 0
        out = _conv_out(t, k, stride, pad, dil)
        self.macs += out * cout * cin * k
        return out

    def conv_t(self, t, cin, cout, k, stride, pad):
        pad = pad if self.padding else 0
        self.macs += t * cin * cout * k
        return (t - 1) * stride - 2 * pad + k

    def snake(self, c, t):
        self.snakes.append((c, t))

    def unit(self, t, dim, dil):
        self.snake(dim, t)
        t2 = self.conv(t, dim, dim, 7, pad=3 * dil, dil=dil)
        self.snake(dim, t2)
        return self.conv(t2, dim, dim, 1)

    def snake_bytes(self, rows: int, itemsize: int) -> float:
        return sum(itemsize * 2.0 * rows * c * t + 4.0 * c for c, t in self.snakes)


def encoder(keys: dict, t: int, padding: bool = True):
    """(census, latent frames, feature frames) of the encoder on ``t``
    samples."""
    m, c = _model(keys), Census(padding)
    d = m["encoder_dim"]
    t = c.conv(t, 1, d, 7, pad=3)
    for s in m["encoder_rates"]:
        for dil in (1, 3, 9):
            t = c.unit(t, d, dil)
        c.snake(d, t)
        t = c.conv(t, d, 2 * d, 2 * s, stride=s, pad=math.ceil(s / 2))
        d *= 2
    feat = t
    c.snake(d, t)
    t = c.conv(t, d, m["latent"], 3, pad=1)
    return c, t, feat


def importance(keys: dict, feat: int) -> Census:
    """The importance subnet on ``feat`` frames (always padded)."""
    m, c = _model(keys), Census(True)
    d = m["latent"]
    c.snake(d, feat)
    c.conv(feat, d, d, 3, pad=1)
    for a, b in zip([d, 512, 128, 32, 8], [512, 128, 32, 8, 1]):
        c.snake(a, feat)
        c.conv(feat, a, b, 3, pad=1)
    return c


def decoder(keys: dict, frames: int, padding: bool = True):
    """(census, samples) of the decoder on ``frames`` latent frames."""
    m, c = _model(keys), Census(padding)
    ch = m["decoder_dim"]
    t = c.conv(frames, m["latent"], ch, 7, pad=3)
    for i, s in enumerate(m["decoder_rates"]):
        cin, cout = ch // 2 ** i, ch // 2 ** (i + 1)
        c.snake(cin, t)
        t = c.conv_t(t, cin, cout, 2 * s, s, math.ceil(s / 2))
        for dil in (1, 3, 9):
            t = c.unit(t, cout, dil)
        cout_last = cout
    c.snake(cout_last, t)
    t = c.conv(t, cout_last, 1, 7, pad=3)
    return c, t


def rvq_macs(keys: dict, frames: int, search: bool = True) -> int:
    """Multiply-adds a row of every stage on ``frames`` frames: the in- and
    out-projections and the codebook search (``search=False``: the
    out-projections of a decode from codes)."""
    m = _model(keys)
    d, code, size = m["latent"], m["codebook_dim"], m["codebook_size"]
    per = code * d + (d * code + size * code if search else 0)
    return m["n_codebooks"] * frames * per


def oneshot(keys: dict, rows: int, samples: int) -> Dict[str, float]:
    """One pass of the one-shot transcoder on ``rows`` clips of ``samples``
    (a hop multiple): float32 operations (encoder, importance subnet, the
    codebook search and the decode's projections), bfloat16 operations (the
    decoder's convs), and the Snake bytes (float32 in the encoder and the
    subnet, bfloat16 in the decoder)."""
    enc, frames, feat = encoder(keys, samples)
    imp = importance(keys, feat)
    dec, _ = decoder(keys, frames)
    f32 = 2 * rows * (enc.macs + imp.macs + rvq_macs(keys, frames)
                      + rvq_macs(keys, frames, search=False))
    return {"flops_f32": float(f32), "flops_bf16": float(2 * rows * dec.macs),
            "snake_bytes": enc.snake_bytes(rows, 4) + imp.snake_bytes(rows, 4)
            + dec.snake_bytes(rows, 2)}


def generator_forward(keys: dict, rows: int, samples: int) -> float:
    """Operations of the generator's train forward on ``rows`` excerpts of
    ``samples`` (padded up to a hop multiple)."""
    hop = math.prod(_model(keys)["encoder_rates"])
    samples = -(-samples // hop) * hop
    enc, frames, feat = encoder(keys, samples)
    dec, _ = decoder(keys, frames)
    macs = enc.macs + importance(keys, feat).macs + rvq_macs(keys, frames) + dec.macs
    return 2.0 * rows * macs


def discriminator_forward(keys: dict, rows: int, samples: int) -> float:
    """Operations of the MPD + MRD forward on ``rows`` waveforms of
    ``samples`` (the convs; the STFTs are left out)."""
    macs = 0
    for p in keys["Discriminator.periods"]:
        h = (samples + p - samples % p) // p
        for j, (a, b) in enumerate([(1, 32), (32, 128), (128, 512), (512, 1024),
                                    (1024, 1024)]):
            h = _conv_out(h, 5, 3 if j < 4 else 1, 2)
            macs += h * p * b * a * 5
        macs += _conv_out(h, 3, 1, 1) * p * 1024 * 3
    for n_fft in keys["Discriminator.fft_sizes"]:
        frames = -(-samples // (n_fft // 4))
        bins = n_fft // 2 + 1
        total_w = 0  # the bands' widths after their convs, joined for conv_post
        for lo, hi in keys["Discriminator.bands"]:
            w = int(hi * bins) - int(lo * bins)
            h = frames
            for cin, (kh, kw), (sh, sw), (ph, pw) in (
                    [(2, (3, 9), (1, 1), (1, 4))] + [(32, (3, 9), (1, 2), (1, 4))] * 3
                    + [(32, (3, 3), (1, 1), (1, 1))]):
                h, w = _conv_out(h, kh, sh, ph), _conv_out(w, kw, sw, pw)
                macs += h * w * 32 * cin * kh * kw
            total_w += w
        macs += frames * total_w * 32 * 9
    return 2.0 * rows * macs


def train_step(keys: dict, rows: int, samples: int) -> float:
    """Operations of one GAN step, the backward at twice its forward: the
    generator's forward and backward (3 forwards); the discriminator's two
    forwards and their full backward in its own phase (6), then two forwards
    and the input gradient of the fake one in the generator's phase (3)."""
    return (3.0 * generator_forward(keys, rows, samples)
            + 9.0 * discriminator_forward(keys, rows, samples))
