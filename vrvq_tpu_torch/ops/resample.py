"""Sample-rate conversion (counterpart of ``vrvq_tpu/ops/resample.py``).

On the host, ``resample_poly_np``: polyphase resampling by scipy's
``resample_poly`` (a Kaiser-windowed sinc), the same call as the JAX
package's, so both hand the codec the same samples. In the graph,
``resample``: the JAX package's ``resample_jax`` (the MSD discriminator's
resample), the same Kaiser-windowed sinc taps built in numpy from the same
constants, applied as a zero-stuffed, strided ``conv1d`` (a plain
convolution, as XLA computes it there), with the same length contract,
``ceil(T * up / down)`` samples.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import torch
import torch.nn.functional as F

from .stft import on_device

KAISER_BETA = 14.769656459379492


def resample_poly_np(x: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Polyphase resample along the last axis, in ``x``'s dtype."""
    from scipy.signal import resample_poly

    if orig_sr == new_sr:
        return x
    frac = Fraction(new_sr, orig_sr)
    return resample_poly(x, frac.numerator, frac.denominator,
                         axis=-1).astype(x.dtype, copy=False)


def sinc_taps(up: int, down: int, zeros: int = 24) -> np.ndarray:
    """The low-pass at the zero-stuffed rate ``sr * up``: cutoff
    ``min(1/up, 1/down)``, ``zeros`` zero crossings a side, Kaiser window,
    passband gain ``up`` (undoing the zero-stuffing), float32."""
    c = min(1.0 / up, 1.0 / down)
    halfwidth = int(np.ceil(zeros / c))
    n = np.arange(-halfwidth, halfwidth + 1)
    window = np.kaiser(len(n), KAISER_BETA)
    return (up * c * np.sinc(c * n) * window).astype(np.float32)


def resample(x: torch.Tensor, orig_sr: int, new_sr: int,
             zeros: int = 24) -> torch.Tensor:
    """Windowed-sinc resample of ``x`` (..., T) along its last axis, in the
    graph (differentiable): ``ceil(T * up / down)`` samples out."""
    if orig_sr == new_sr:
        return x
    frac = Fraction(new_sr, orig_sr)
    up, down = frac.numerator, frac.denominator
    # built on the card once (ops/stft.on_device), as JAX bakes the taps in
    taps = on_device(sinc_taps, (up, down, zeros), x.device, x.dtype)
    k = taps.numel()
    pad = k // 2
    lead, t = x.shape[:-1], x.shape[-1]
    sig = x.reshape(-1, 1, t)
    if up > 1:  # zero-stuff: up - 1 zeros between samples
        stuffed = sig.new_zeros(sig.shape[0], 1, (t - 1) * up + 1)
        stuffed[..., ::up] = sig
        sig = stuffed
    # one extra `down` on the right so the strided conv always reaches
    # ceil(T * up / down) samples, as resample_jax pads
    y = F.conv1d(F.pad(sig, (pad, pad + down)), taps.reshape(1, 1, k), stride=down)
    new_len = int(math.ceil(t * up / down))
    return y[:, 0, :new_len].reshape(*lead, -1)
