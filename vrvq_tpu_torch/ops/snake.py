"""Snake activation ``x + sin^2(alpha * x) / (alpha + 1e-9)``.

Counterpart of ``vrvq_tpu/ops/snake.py``. ``snake`` launches the CUDA kernel
(``kernels/csrc/snake.cu``, the port of ``snake_pallas``) for a tensor on the
card and runs ``snake_reference`` for a tensor on the CPU. Layout is the
port's ``(B, C, T)`` with a per-channel ``alpha (C,)``.
"""

from __future__ import annotations

import torch

from ..kernels import LAUNCHES, check, library


def snake_reference(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Plain version. Mirrors the JAX ``snake_reference`` term for term:
    the reciprocal first, then the product with ``s * s``."""
    a = alpha.reshape(1, -1, 1)
    s = torch.sin(a * x)
    return x + (1.0 / (a + 1e-9)) * (s * s)


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake through the kernel for a CUDA tensor, the plain version for a
    CPU tensor. Takes float32 ``x (B, C, T)`` contiguous and ``alpha (C,)``."""
    if x.device.type == "cpu":
        return snake_reference(x, alpha)
    if x.device.type != "cuda":
        raise ValueError(f"snake: unsupported device {x.device}")
    if x.dtype != torch.float32 or alpha.dtype != torch.float32:
        raise TypeError(f"snake: float32 only, got {x.dtype} / {alpha.dtype}")
    if x.ndim != 3 or alpha.shape != (x.shape[1],):
        raise ValueError(
            f"snake: x must be (B, C, T) and alpha (C,), got "
            f"{tuple(x.shape)} and {tuple(alpha.shape)}"
        )
    if not (x.is_contiguous() and alpha.is_contiguous()):
        raise ValueError("snake: x and alpha must be contiguous")
    if alpha.device != x.device:
        raise ValueError("snake: x and alpha must be on the same device")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    err = library().vrvq_snake_forward(
        x.data_ptr(), alpha.data_ptr(), y.data_ptr(), x.shape[0] * x.shape[1],
        x.shape[1], x.shape[2], torch.cuda.current_stream(x.device).cuda_stream,
    )
    LAUNCHES["snake"] += 1
    check(err, "snake")
    return y
