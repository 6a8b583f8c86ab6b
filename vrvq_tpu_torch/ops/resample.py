"""Sample-rate conversion on the host (counterpart of
``vrvq_tpu/ops/resample.py``'s ``resample_poly_np``): polyphase resampling
by scipy's ``resample_poly`` (a Kaiser-windowed sinc), the same call as the
JAX package's, so both hand the codec the same samples. The in-graph
``resample_jax`` serves the discriminators and comes with training."""

from __future__ import annotations

from fractions import Fraction

import numpy as np


def resample_poly_np(x: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Polyphase resample along the last axis, in ``x``'s dtype."""
    from scipy.signal import resample_poly

    if orig_sr == new_sr:
        return x
    frac = Fraction(new_sr, orig_sr)
    return resample_poly(x, frac.numerator, frac.denominator,
                         axis=-1).astype(x.dtype, copy=False)
