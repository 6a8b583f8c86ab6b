"""VBR level sweep: encode once, then re-mask and decode at each level.

Counterpart of ``vrvq_tpu/infer/sweep.py``. One encode gives every stage's
``z_q_is`` and the importance map; each level scales the map, hard-masks
the stages, sums and decodes, and reports bits per frame and kbps.
``batched=True`` folds the levels into the batch axis: one decoder pass for
the whole sweep (windowed by ``decode_chunked`` past ``ONE_SHOT_FRAME_BATCH``
frames, the JAX package's one-shot limit).

A level's mask here is the prefix mask of ``DAC_VRVQ``'s importance map; a
``DAC_MOE``'s mask is not one, so the sweep raises for it, as compress does
(``infer/codec_api.py``).

``save_results`` writes each level's reconstruction, the input, a
``metadata.json`` of SI-SDR and kbps per level and, with ``png``, each
level's mask as an image. The image is written by the port itself (numpy and
zlib; the card's machine has no matplotlib): the mask's stages as rows, the
first at the bottom, kept codes in viridis' yellow on its purple, where the
JAX package draws the same mask with matplotlib and axis labels.
"""

from __future__ import annotations

import json
import math
import os
import struct
import zlib
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..audio import Signal
from ..metrics import cal_bpf_from_mask, si_sdr
from ..ops.masks import generate_mask_hard
from .chunked import decode_chunked
from .codec_api import check_counts_hold_mask

DEFAULT_LEVELS = [0.2, 0.3, 0.4, 0.5, 0.6, 0.8, 1, 1.2, 1.5, 2, 2.5, 3]
ONE_SHOT_FRAME_BATCH = 24 * 862


class LevelSweep:
    """Encode-once / decode-per-level runner over a padded ``DAC_VRVQ``."""

    def __init__(self, model):
        check_counts_hold_mask(model, vbr=True)
        self.model = model

    def encode(self, audio: torch.Tensor) -> Dict:
        """audio (B, 1, T), already a multiple of the hop."""
        with torch.inference_mode():
            return self.model.encode(audio, level=1.0)

    def decode_at_level(self, enc: Dict, level: float):
        """(reconstruction (B, 1, T), mask (B, Nq, T'))."""
        n_q = self.model.n_codebooks
        with torch.inference_mode():
            mask = generate_mask_hard(enc["imp_map"] * (level * n_q), n_q)
            z_q = torch.sum(enc["z_q_is"] * mask[:, :, None, :], dim=1)
            return self.model.decode(z_q), mask

    def _kbps(self, bpf: float) -> float:
        m = self.model
        return bpf * math.floor(m.sample_rate / m.hop_length) / 1000

    def sweep(self, audio: torch.Tensor,
              levels: Sequence[float] = tuple(DEFAULT_LEVELS),
              batched: bool = False,
              enc: Optional[Dict] = None) -> Dict[float, Dict]:
        """``{level: {audio, mask, bpf, kbps}}``. Pass ``enc`` (an earlier
        ``encode``) to reuse the encoder's work."""
        n_q = self.model.n_codebooks
        bits = [int(math.log2(self.model.config.codebook_size))] * n_q
        if enc is None:
            enc = self.encode(audio)
        out = {}
        if batched:
            recons, masks, bpfs = self._decode_levels_batched(
                enc["z_q_is"], enc["imp_map"], [float(lv) for lv in levels])
            bpfs = bpfs.cpu().numpy()  # one fetch for every level
            for i, level in enumerate(levels):
                out[level] = {"audio": recons[i], "mask": masks[i],
                              "bpf": float(bpfs[i]),
                              "kbps": self._kbps(float(bpfs[i]))}
            return out
        for level in levels:
            recon, mask = self.decode_at_level(enc, level)
            bpf = cal_bpf_from_mask(mask, bits)
            out[level] = {"audio": recon, "mask": mask, "bpf": bpf,
                          "kbps": self._kbps(bpf)}
        return out

    def _decode_levels_batched(self, z_q_is, imp_map, levels):
        """Every level in one decoder pass: (audio (L, B, 1, T), masks (L, B,
        Nq, T'), bits per frame (L,))."""
        model = self.model
        n_q = model.n_codebooks
        with torch.inference_mode():
            lv = torch.tensor(levels, dtype=torch.float32, device=imp_map.device)
            n_lv = lv.shape[0]
            b, _, d, t = z_q_is.shape
            scaled = imp_map[None] * (lv[:, None, None, None] * n_q)
            mask_l = generate_mask_hard(scaled.reshape(n_lv * b, 1, t),
                                        n_q).reshape(n_lv, b, n_q, t)
            z_q = torch.einsum("bndt,lbnt->lbdt", z_q_is,
                               mask_l.to(z_q_is.dtype)).reshape(n_lv * b, d, t)
            if n_lv * b * t <= ONE_SHOT_FRAME_BATCH:
                audio = model.decode(z_q)
            else:
                audio = decode_chunked(model, z_q)
            bits = torch.full((1, n_q, 1), math.log2(model.config.codebook_size),
                              dtype=torch.float32, device=mask_l.device)
            bpf = torch.sum(mask_l * bits, dim=(1, 2, 3)) / (b * t)
            return audio.reshape(n_lv, b, 1, -1), mask_l, bpf


def save_results(model, input_tensor: torch.Tensor,
                 level_list: Sequence[float], save_result_dir: str,
                 png: bool = True) -> Dict:
    """One example's artifacts in a new numbered folder of
    ``save_result_dir``: ``recon_<level x Nq>.wav`` per level, ``input.wav``,
    ``metadata.json`` (SI-SDR and kbps per level) and, with ``png``, the
    mask of each level as ``imp_map_<level x Nq>.png``."""
    os.makedirs(save_result_dir, exist_ok=True)
    save_idx = 0
    while os.path.exists(os.path.join(save_result_dir, f"{save_idx}")):
        save_idx += 1
    save_dir = os.path.join(save_result_dir, f"{save_idx}")
    os.makedirs(save_dir)

    sr = model.sample_rate
    n_q = model.n_codebooks
    input_tensor = model.preprocess(torch.as_tensor(input_tensor), sr)
    results = LevelSweep(model).sweep(input_tensor, level_list, batched=True)
    reference = input_tensor.cpu().numpy()
    metadata = {}
    for level, r in results.items():
        level_scaled = level * n_q
        recon = r["audio"].cpu().numpy()
        Signal(recon, sr).write(os.path.join(save_dir, f"recon_{level_scaled:.2f}.wav"))
        if png:
            _save_mask_png(r["mask"].cpu().numpy(), level_scaled, save_dir)
        metadata[f"level_{level_scaled:.2f}"] = {
            "sisdr": si_sdr(recon, reference), "kbps": r["kbps"]}
    with open(os.path.join(save_dir, "metadata.json"), "w") as f:
        json.dump(metadata, f, indent=4)
    Signal(reference, sr).write(os.path.join(save_dir, "input.wav"))
    return metadata


# viridis at 0 and 1: a dropped code, a kept one
_MASK_RGB = np.array([[68, 1, 84], [253, 231, 37]], np.uint8)


def _save_mask_png(mask: np.ndarray, level: float, save_dir: str) -> None:
    """The first example's mask (Nq, T') as an 8-bit RGB PNG, each stage a
    band of 24 pixels (stage 1 at the bottom), each frame 2 pixels wide."""
    rgb = _MASK_RGB[(np.asarray(mask[0]) > 0.5).astype(np.intp)[::-1]]
    rgb = np.repeat(np.repeat(rgb, 24, axis=0), 2, axis=1)
    height, width = rgb.shape[:2]
    rows = np.concatenate([np.zeros((height, 1), np.uint8),  # filter: none
                           rgb.reshape(height, width * 3)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
           + chunk(b"IEND", b""))
    with open(os.path.join(save_dir, f"imp_map_{level:.2f}.png"), "wb") as f:
        f.write(png)
