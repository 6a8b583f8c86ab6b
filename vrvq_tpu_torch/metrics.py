"""Evaluation metrics that serving needs: bits per frame, codebook usage and
entropy, and the SNR family.

Counterpart of the part of ``vrvq_tpu/metrics.py`` that the gate, the level
sweep and the card smoke use. The mel and STFT losses, ViSQOL and the
filtered ``sdr`` come with the training slice.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch


def cal_bpf_from_mask(mask, bits_per_codebook: Sequence[int]) -> float:
    """mask (B, Nq, T) -> mean bits per frame, in float32 as the JAX
    function sums them (a sum of whole bits, exact in float32)."""
    mask = torch.as_tensor(mask).float()
    bits = torch.tensor(list(bits_per_codebook), dtype=torch.float32,
                        device=mask.device).reshape(1, -1, 1)
    return float(torch.sum(mask * bits) / (mask.shape[0] * mask.shape[2]))


def cal_entropy(bincount_list: List[np.ndarray]):
    """Per-codebook usage entropy (bits) and its share of the capacity."""
    entropy_list, pct_list = [], []
    for counts in bincount_list:
        counts = np.asarray(counts, dtype=np.float64)
        bit = math.ceil(math.log2(counts.shape[0]))
        p = np.clip(counts / counts.sum(), 1e-10, None)
        entropy = float(-(p * np.log(p)).sum() * np.log2(np.e))
        entropy_list.append(entropy)
        pct_list.append(entropy / bit)
    return entropy_list, pct_list


def codebook_usage(codes, codebook_size: int) -> List[np.ndarray]:
    """codes (B, Nq, T) -> list of per-stage bincounts."""
    codes = np.asarray(codes)
    return [
        np.bincount(codes[:, i].reshape(-1), minlength=codebook_size)
        for i in range(codes.shape[1])
    ]


def _pair(recons, signal):
    def arr(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return np.asarray(getattr(x, "audio_data", x))
    return arr(recons).astype(np.float64), arr(signal).astype(np.float64)


def si_sdr(recons, signal, zero_mean: bool = True) -> float:
    """Scale-invariant SDR (dB), estimate first, mean over the batch."""
    est, ref = _pair(recons, signal)
    est = est.reshape(est.shape[0], -1)
    ref = ref.reshape(ref.shape[0], -1)
    if zero_mean:
        est = est - est.mean(-1, keepdims=True)
        ref = ref - ref.mean(-1, keepdims=True)
    eps = np.finfo(np.float64).eps
    alpha = (np.sum(est * ref, -1, keepdims=True) + eps) / (
        np.sum(ref ** 2, -1, keepdims=True) + eps
    )
    target = alpha * ref
    noise = est - target
    val = (np.sum(target ** 2, -1) + eps) / (np.sum(noise ** 2, -1) + eps)
    return float(np.mean(10.0 * np.log10(val)))


def si_snr(recons, signal) -> float:
    return si_sdr(recons, signal, zero_mean=True)


def snr(recons, signal, zero_mean: bool = False) -> float:
    est, ref = _pair(recons, signal)
    est = est.reshape(est.shape[0], -1)
    ref = ref.reshape(ref.shape[0], -1)
    if zero_mean:
        est = est - est.mean(-1, keepdims=True)
        ref = ref - ref.mean(-1, keepdims=True)
    eps = np.finfo(np.float64).eps
    val = (np.sum(ref ** 2, -1) + eps) / (np.sum((ref - est) ** 2, -1) + eps)
    return float(np.mean(10.0 * np.log10(val)))
