"""Evaluation metrics: bits per frame, codebook usage and entropy, the SDR
family, L1, ViSQOL and the metric dispatch ``cal_metrics``.

Counterpart of ``vrvq_tpu/metrics.py``. Every function takes torch tensors
(on any device) or numpy arrays; the SDR family, L1 and ViSQOL compute on the
host in float64, as the JAX package's do, and the loss-based metrics (mel,
stft, waveform) call the port's losses on the tensors' device.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

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


def sdr(recons, signal, filter_length: int = 512,
        zero_mean: bool = False, load_diag: Optional[float] = None) -> float:
    """BSS-eval-style signal-to-distortion ratio (dB) with a
    ``filter_length``-tap FIR distortion filter: the best filter h of the
    reference (Toeplitz normal equations) is forgiven, so a delayed or
    equalized but otherwise perfect estimate scores high here and low in
    ``si_sdr``."""
    from scipy.linalg import solve_toeplitz

    est, ref = _pair(recons, signal)
    est = est.reshape(-1, est.shape[-1])
    ref = ref.reshape(-1, ref.shape[-1])
    if np.abs(est).max() == 0 or np.abs(ref).max() == 0:
        return float("nan")
    if zero_mean:
        est = est - est.mean(-1, keepdims=True)
        ref = ref - ref.mean(-1, keepdims=True)

    n = est.shape[-1]
    n_fft = 1 << int(math.ceil(math.log2(2 * n - 1)))
    eps = np.finfo(np.float64).eps
    vals = []
    for e, s in zip(est, ref):
        s_f = np.fft.rfft(s, n_fft)
        e_f = np.fft.rfft(e, n_fft)
        # the reference's autocorrelation and its cross-correlation with the
        # estimate, first filter_length lags (linear: zero-padded FFTs)
        acf = np.fft.irfft(np.abs(s_f) ** 2, n_fft)[:filter_length]
        xcorr = np.fft.irfft(np.conj(s_f) * e_f, n_fft)[:filter_length]
        if load_diag is not None:
            acf = acf.copy()
            acf[0] += load_diag
        h = solve_toeplitz(acf, xcorr)
        # ||ref * h||^2 = xcorr . h (an orthogonal projection)
        proj = float(np.dot(xcorr, h))
        energy = float(np.dot(e, e))
        ratio = proj / max(energy - proj, eps)
        vals.append(10.0 * np.log10(max(ratio, eps)))
    return float(np.mean(vals))


def l1(recons, signal) -> float:
    est, ref = _pair(recons, signal)
    return float(np.mean(np.abs(est - ref)))


def nsim(recons, signal, sample_rate: int = 44100, speech: bool = False) -> float:
    """ViSQOL's neurogram similarity (vnsim) in [0, 1], the mean over the
    batch (``visqol.py``)."""
    return _visqol_batch(recons, signal, sample_rate, speech)[0]


def _visqol_batch(recons, signal, sample_rate: int = 44100,
                  speech: bool = False) -> tuple:
    """(mean vnsim, mean per-item MOS) over the batch: MOS is mapped per item
    and then averaged, as listening tests average."""
    from .visqol import visqol

    est, ref = _pair(recons, signal)
    vs, moss = [], []
    for e, r in zip(est.reshape(-1, est.shape[-1]),
                    ref.reshape(-1, ref.shape[-1])):
        v, m = visqol(e, r, sample_rate, speech=speech)
        vs.append(v)
        moss.append(m)
    return float(np.mean(vs)), float(np.mean(moss))


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(getattr(x, "audio_data", x), np.float32))


def cal_metrics(recons, signal, state=None, loss_fn: str = "mel") -> float:
    """One metric by name. ``state`` (any object with ``mel_loss``,
    ``stft_loss`` and ``waveform_loss``) is needed for the loss-based ones,
    which run on ``recons``' device."""
    losses = {"mel": "mel_loss", "stft": "stft_loss", "waveform": "waveform_loss"}
    if loss_fn in losses:
        recons, signal = _tensor(recons), _tensor(signal)
        return float(getattr(state, losses[loss_fn])(
            recons, signal.to(recons.device)))
    dispatch = {
        "SDR": sdr, "SI-SDR": si_sdr, "SI-SNR": si_snr, "SNR": snr, "L1": l1,
        "ViSQOL": lambda r, s: nsim(r, s, speech=False),
        "ViSQOL-speech": lambda r, s: nsim(r, s, speech=True),
        "ViSQOL-MOS": lambda r, s: _visqol_batch(r, s, speech=False)[1],
    }
    if loss_fn not in dispatch:
        raise ValueError(f"Unknown loss function: {loss_fn}")
    return dispatch[loss_fn](recons, signal)


def mean_std(data):
    """NaN-safe (mean, std)."""
    data = np.asarray(data, dtype=np.float64)
    data = data[~np.isnan(data)]
    return float(np.mean(data)), float(np.std(data))
