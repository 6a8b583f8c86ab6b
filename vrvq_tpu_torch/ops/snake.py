"""Snake activation ``x + sin^2(alpha * x) / (alpha + 1e-9)``.

Counterpart of ``vrvq_tpu/ops/snake.py``. ``snake`` launches the CUDA kernel
(``kernels/csrc/snake.cu``, the port of ``snake_pallas``) for a tensor on the
card and runs a plain version for a tensor on the CPU. Layout is the port's
``(B, C, T)`` with a per-channel float32 ``alpha (C,)``.

Four modes, chosen at the call: the exact ``sin^2`` or the polynomial one of
the JAX ``snake_approx`` (``approx=True``), each on float32 or bfloat16 ``x``.
Arithmetic is float32 in every mode, and a bfloat16 result is rounded once,
as the JAX layer computes ``snake_approx`` in float32 and casts back.
"""

from __future__ import annotations

import torch

from ..kernels import LAUNCHES, check, library

# float32 values of the JAX package's constants (vrvq_tpu/ops/snake.py):
# 1/pi, the Cody-Waite split of pi, and sin^2(r) ~= s P(s), s = r^2, P of
# degree 6 in ascending order
INV_PI = 1.0 / 3.14159265358979323846
PI_HI = 3.140625
PI_LO = 9.67653589793e-04
SIN2_C = (
    1.000000000e+00, -3.333333305e-01, 4.444442364e-02, -3.174549052e-03,
    1.410278879e-04, -4.235064360e-06, 8.151456250e-08,
)

DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the kernel's dtype codes


def mode_name(dtype: torch.dtype, approx: bool) -> str:
    """The launch counter of a mode: ``snake``, ``snake_approx``,
    ``snake_bf16`` or ``snake_approx_bf16``."""
    return ("snake" + ("_approx" if approx else "")
            + ("_bf16" if dtype == torch.bfloat16 else ""))


def snake_reference(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Plain version of the exact mode. Mirrors the JAX ``snake_reference``
    term for term in float32: the reciprocal first, then the product with
    ``s * s``; the result in ``x``'s dtype."""
    xf = x.float()
    a = alpha.float().reshape(1, -1, 1)
    s = torch.sin(a * xf)
    return (xf + (1.0 / (a + 1e-9)) * (s * s)).to(x.dtype)


def snake_approx_reference(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Plain version of the polynomial mode. Mirrors the JAX ``snake_approx``
    term for term in float32 (``sin2_approx``); the result in ``x``'s
    dtype."""
    xf = x.float()
    a = alpha.float().reshape(1, -1, 1)
    return (xf + sin2_approx(a * xf) * (1.0 / (a + 1e-9))).to(x.dtype)


def sin2_approx(u: torch.Tensor) -> torch.Tensor:
    """``sin(u)^2`` in float32 by the JAX ``snake_approx``'s polynomial: the
    period-pi Cody-Waite reduction with rounding to nearest even, then the
    degree-6 Horner of ``SIN2_C`` in ``s = r^2``."""
    k = torch.round(u * INV_PI)
    r = (u - k * PI_HI) - k * PI_LO
    s = r * r
    acc = s * SIN2_C[-1] + SIN2_C[-2]
    for c in SIN2_C[-3::-1]:
        acc = acc * s + c
    return s * acc


def snake_plain(x: torch.Tensor, alpha: torch.Tensor,
                approx: bool = False) -> torch.Tensor:
    """The plain version of the mode ``approx`` selects."""
    if approx:
        return snake_approx_reference(x, alpha)
    return snake_reference(x, alpha)


def snake(x: torch.Tensor, alpha: torch.Tensor,
          approx: bool = False) -> torch.Tensor:
    """Snake through the kernel for a CUDA tensor, the plain version for a
    CPU tensor. Takes float32 or bfloat16 ``x (B, C, T)`` contiguous and
    float32 ``alpha (C,)``; ``approx`` picks the polynomial ``sin^2``."""
    if x.device.type == "cpu":
        return snake_plain(x, alpha, approx)
    if x.device.type != "cuda":
        raise ValueError(f"snake: unsupported device {x.device}")
    if x.dtype not in DTYPES or alpha.dtype != torch.float32:
        raise TypeError(
            f"snake: x must be float32 or bfloat16 and alpha float32, got "
            f"{x.dtype} / {alpha.dtype}")
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
        x.shape[1], x.shape[2], DTYPES[x.dtype], int(approx),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    LAUNCHES[mode_name(x.dtype, approx)] += 1
    check(err, "snake")
    return y
