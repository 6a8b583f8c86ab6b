"""Importance map -> codebook mask (counterpart of ``vrvq_tpu/ops/masks.py``).

The scaled importance map ``x (B, 1, T)`` is compared with the stage
thresholds 0..Nq-1: stage i is kept for a frame iff ``x - i >= 0``. Masks are
``(B, Nq, T)``. The straight-through mask has the hard mask's value and the
smooth mask's gradient, as in the JAX code. ``DAC_MOE``'s router gives one
score per stage instead, ``x (B, Nq, T)``: ``generate_mask_ste_moe``
thresholds each at 0.5, with the first stages forced on.
"""

from __future__ import annotations

import math

import torch

EPS = 1e-10


def logcosh(alpha: float, pmk: torch.Tensor) -> torch.Tensor:
    """Smooth step in [0, 1] centred at 0, in the pmk >= 0 / pmk < 0 branches
    of the JAX code."""
    mask1 = (pmk >= 0).to(pmk.dtype)
    pmk1 = pmk * mask1
    numer1 = math.exp(alpha) + torch.exp(-2.0 * pmk1 * alpha)
    denom1 = torch.exp(alpha * (-2.0 * pmk1 + 1.0)) + 1.0
    m1 = (torch.log(numer1 + EPS) - torch.log(denom1 + EPS)) / (2.0 * alpha) + 0.5

    mask2 = (pmk < 0).to(pmk.dtype)
    pmk2 = pmk * mask2
    numer2 = torch.exp(alpha * (2.0 * pmk2 + 1.0)) + 1.0
    denom2 = math.exp(alpha) + torch.exp(alpha * 2.0 * pmk2)
    m2 = (torch.log(numer2 + EPS) - torch.log(denom2 + EPS)) / (2.0 * alpha) + 0.5

    return m1 * mask1 + m2 * mask2


def _stage_thresholds(nq: int, x: torch.Tensor) -> torch.Tensor:
    return torch.arange(nq, dtype=x.dtype, device=x.device).reshape(1, nq, 1)


def generate_mask_ste(x: torch.Tensor, nq: int, alpha: float = 1.0) -> torch.Tensor:
    """Straight-through mask ``smooth + stop_grad(hard - smooth)``: the hard
    mask's value, the logcosh smooth mask's gradient."""
    xmnq = x - _stage_thresholds(nq, x)
    mask_smooth = logcosh(alpha, xmnq)
    mask_quant = (xmnq >= 0).to(x.dtype)
    return mask_smooth + (mask_quant - mask_smooth).detach()


def generate_mask_hard(x: torch.Tensor, nq: int) -> torch.Tensor:
    """Hard mask: stage i on iff ``x - i >= 0``."""
    xmnq = x - _stage_thresholds(nq, x)
    return (xmnq >= 0).to(x.dtype)


def generate_mask_ste_moe(x: torch.Tensor, nq: int, alpha: float = 1.0,
                          ns: int = 2) -> torch.Tensor:
    """The router's mask: per-stage scores ``x (B, Nq, T)``, the first ``ns``
    stages forced to 1, then kept where ``>= 0.5``. Straight-through: the
    hard mask's value, the (forced) scores' gradient. ``alpha`` is accepted
    and unused, as in the JAX code."""
    del alpha
    forced = torch.arange(nq, device=x.device).reshape(1, nq, 1) < ns
    xm = torch.where(forced, torch.ones_like(x), x)
    mask_quant = (xm >= 0.5).to(x.dtype)
    return xm + (mask_quant - xm).detach()
