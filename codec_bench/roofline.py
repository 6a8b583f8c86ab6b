"""Peaks and bounds: a frozen copy of ``vrvq_tpu_torch/kernel_times.py``'s
``bound``, ``snake_bound`` and ``rvq_bound``, with NVIDIA's data-sheet
peaks of one H100 SXM (dense, at its 700 W limit)."""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12  # device memory
F32_FLOP_PER_S = 67e12  # float32 outside the tensor cores
BF16_FLOP_PER_S = 989e12  # bfloat16 on the tensor cores


def bound(n_bytes: float, n_flops: float) -> dict:
    """Least time on an H100 SXM at its data-sheet rates: the larger of the
    bytes over the memory rate and the f32 operations over the f32 rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "flops_ms": t_ops}


def snake_bound(shape, itemsize: int = 4) -> dict:
    """x read, alpha (float32) read, y written, ``itemsize`` bytes an
    element; ~5 operations and a sin (or its polynomial) per element."""
    n = math.prod(shape)
    return bound(itemsize * 2.0 * n + 4.0 * shape[1], 5.0 * n)


def rvq_bound(frames: int, n_q: int, d_model: int, d_code: int, k: int) -> dict:
    """The weights (wi, bi, wo, bo, codebook), z and the mask read once, z_q
    and the codes written once; the three products of every stage."""
    w_bytes = 4 * n_q * (2 * d_model * d_code + d_code + d_model + k * d_code)
    io_bytes = 4 * frames * (2 * d_model + 2 * n_q)
    flops = frames * n_q * (2 * d_model * d_code + 2 * k * d_code
                            + 2 * d_code * d_model)
    return bound(w_bytes + io_bytes, flops)
