"""Memory-bounded chunked encode and decode of the padded codec.

Counterpart of ``vrvq_tpu/infer/chunked.py``. The one-shot codec holds every
activation of the clip at once; these run the same padded encoder or decoder
over fixed windows of latent frames, so peak memory follows the window, not
the clip. Each window carries a halo of the stack's receptive radius
(``models/codec.py``: ``encoder_halo_frames``, ``decoder_halo_frames``) on
both sides, and the edge windows are shifted flush to the clip instead of
zero-padded, so the conv padding inside a window coincides with the one-shot
codec's own edge padding: every kept sample sees the one-shot input.

PyTorch runs eagerly, so the JAX version's ``fori_loop`` is a Python loop
here; every window is queued on the device before anything is fetched.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models import codec


def _auto_chunk_frames(t: int, cap: int = 512) -> int:
    """An even split of ``t`` frames into the fewest chunks of at most
    ``cap``: each window pays its halos and the last one its slack."""
    n = -(-t // cap)
    return -(-t // n)


def _padded(model):
    return model if model.padding else model.clone(padding=True)


def _windows(t: int, chunk: int, halo: int):
    """(keep, start) of each window: the frames [keep, keep + chunk) it
    contributes, read from the window [start, start + chunk + 2 halo)
    flush inside [0, t)."""
    win = chunk + 2 * halo
    for i in range(-(-t // chunk)):
        keep = min(i * chunk, t - chunk)
        yield keep, min(max(keep - halo, 0), t - win)


def decode_chunked(model, z_q: torch.Tensor,
                   chunk_frames: Optional[int] = None,
                   halo_frames: Optional[int] = None) -> torch.Tensor:
    """Decode ``z_q (B, D, T')`` -> audio ``(B, 1, T' * hop)`` in windows;
    one window when the clip is no longer than ``chunk_frames + 2 halo``.
    ``chunk_frames=None`` splits evenly with windows of at most 512 frames."""
    hop = model.hop_length
    decoder = _padded(model).decoder
    b, _, t = z_q.shape
    chunk = _auto_chunk_frames(t) if chunk_frames is None else chunk_frames
    halo = (codec.decoder_halo_frames(model.config.decoder_rates)
            if halo_frames is None else halo_frames)
    win = chunk + 2 * halo
    if t <= win:
        return decoder(z_q)
    out = z_q.new_zeros((b, 1, t * hop), dtype=torch.float32)
    for keep, s in _windows(t, chunk, halo):
        y = decoder(z_q[..., s: s + win])
        k = (keep - s) * hop
        out[..., keep * hop: (keep + chunk) * hop] = y[..., k: k + chunk * hop]
    return out


def encode_chunked(model, audio_data: torch.Tensor,
                   n_quantizers: Optional[int] = None,
                   level: Optional[float] = 1.0,
                   chunk_frames: Optional[int] = None,
                   halo_frames: Optional[int] = None) -> dict:
    """Run the encoder over latent-aligned windows of ``audio_data (B, 1,
    T)`` (T a multiple of the hop), then the quantizer and importance subnet
    on the assembled latents (latent-rate tensors only). Returns the dict of
    ``model.encode``."""
    hop = model.hop_length
    encoder = _padded(model).encoder
    b, _, t_samples = audio_data.shape
    if t_samples % hop:
        raise ValueError(f"audio length {t_samples} is not a multiple of the "
                         f"hop {hop}: preprocess() it first")
    t = t_samples // hop
    chunk = _auto_chunk_frames(t) if chunk_frames is None else chunk_frames
    halo = (codec.encoder_halo_frames(model.config.encoder_rates)
            if halo_frames is None else halo_frames)
    win = chunk + 2 * halo
    if t <= win:
        z, feat = encoder(audio_data, return_feat=True)
    else:
        d = model.config.resolved_latent_dim
        z = audio_data.new_zeros((b, d, t))
        feat = audio_data.new_zeros((b, d, t))
        for keep, s in _windows(t, chunk, halo):
            zw, fw = encoder(audio_data[..., s * hop: (s + win) * hop],
                             return_feat=True)
            k = keep - s
            z[..., keep: keep + chunk] = zw[..., k: k + chunk]
            feat[..., keep: keep + chunk] = fw[..., k: k + chunk]
    return model.quantize(z, feat, n_quantizers, level)


def forward_chunked(model, audio_data: torch.Tensor,
                    n_quantizers: Optional[int] = None,
                    level: Optional[float] = 1.0,
                    chunk_frames: Optional[int] = None):
    """Chunked encode and decode: (audio (B, 1, T), codes (B, Nq, T'))."""
    length = audio_data.shape[-1]
    audio_data = model.preprocess(audio_data)
    enc = encode_chunked(model, audio_data, n_quantizers, level, chunk_frames)
    audio = decode_chunked(model, enc["z_q"], chunk_frames)
    return audio[..., :length], enc["codes"]
