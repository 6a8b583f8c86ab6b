"""Snake activation ``x + sin^2(alpha * x) / (alpha + 1e-9)``.

Counterpart of ``vrvq_tpu/ops/snake.py``. ``snake`` launches the CUDA kernel
(``kernels/csrc/snake.cu``, the port of ``snake_pallas``) for a tensor on the
card and runs a plain version for a tensor on the CPU. Layout is the port's
``(B, C, T)`` with a per-channel float32 ``alpha (C,)``.

Four modes, chosen at the call: the exact ``sin^2`` or the polynomial one of
the JAX ``snake_approx`` (``approx=True``), each on float32 or bfloat16 ``x``.
Arithmetic is float32 in every mode, and a bfloat16 result is rounded once,
as the JAX layer computes ``snake_approx`` in float32 and casts back.

Two layouts, read from ``x``'s strides: ``(B, C, T)`` contiguous, or the
same shape over channels-last memory (``(B, T, C)`` contiguous, transposed),
which the bfloat16 decoder keeps for its NHWC convs. Each has a kernel of
its own; any other layout raises. The plain versions take either.

Training differentiates the two float32 modes: ``SnakeFunction`` runs the
forward kernel and, in backward, the port's own backward kernel (the JAX
package gets these gradients from XLA's autodiff of ``snake_reference`` and
``snake_approx``), saving only ``x``. ``snake`` routes a call that needs a
gradient there; the bfloat16 modes have no backward and raise under grad,
on either device, rather than return a result that drops its gradient.
"""

from __future__ import annotations

import torch

from ..kernels import check, library
from ..utils import count

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


def _f32(v: float) -> float:
    return torch.tensor(v, dtype=torch.float32).item()


# P'(s) in ascending order: i * C_i for i = 1..6, each the float32 rounding
# of i times the float32 C_i (the backward kernel's constants)
SIN2_DC = tuple(_f32(i * _f32(c)) for i, c in enumerate(SIN2_C) if i)

DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the kernel's dtype codes


def mode_name(dtype: torch.dtype, approx: bool,
              channels_last: bool = False) -> str:
    """The launch counter of a mode: ``snake``, ``snake_approx``,
    ``snake_bf16`` or ``snake_approx_bf16``, with ``_cl`` on the end in the
    channels-last layout."""
    return ("snake" + ("_approx" if approx else "")
            + ("_bf16" if dtype == torch.bfloat16 else "")
            + ("_cl" if channels_last else ""))


def is_channels_last(x: torch.Tensor) -> bool:
    """Whether ``x (B, C, T)`` lies in channels-last memory (``False`` when
    it is contiguous, as a tensor of one channel or one frame is both);
    raises ``ValueError`` on any other layout."""
    if x.is_contiguous():
        return False
    if x.ndim == 3 and x.transpose(1, 2).is_contiguous():
        return True
    raise ValueError(
        f"snake: x must be (B, C, T) contiguous or channels-last, got shape "
        f"{tuple(x.shape)} with strides {x.stride()}")


def _wide(x: torch.Tensor) -> torch.dtype:
    """The plain versions' arithmetic type: float32, or float64 for float64
    input (for ``gradcheck``)."""
    return torch.promote_types(x.dtype, torch.float32)


def snake_reference(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Plain version of the exact mode. Mirrors the JAX ``snake_reference``
    term for term in float32: the reciprocal first, then the product with
    ``s * s``; the result in ``x``'s dtype."""
    xf = x.to(_wide(x))
    a = alpha.to(xf.dtype).reshape(1, -1, 1)
    s = torch.sin(a * xf)
    return (xf + (1.0 / (a + 1e-9)) * (s * s)).to(x.dtype)


def snake_approx_reference(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Plain version of the polynomial mode. Mirrors the JAX ``snake_approx``
    term for term in float32 (``sin2_approx``); the result in ``x``'s
    dtype."""
    xf = x.float()
    a = alpha.float().reshape(1, -1, 1)
    return (xf + sin2_approx(a * xf) * (1.0 / (a + 1e-9))).to(x.dtype)


def _reduce(u: torch.Tensor):
    """The period-pi Cody-Waite reduction of the JAX ``snake_approx``, with
    rounding to nearest even: ``(r, s = r^2)``, r in [-pi/2, pi/2]."""
    k = torch.round(u * INV_PI)
    r = (u - k * PI_HI) - k * PI_LO
    return r, r * r


def _horner(s: torch.Tensor, coeffs) -> torch.Tensor:
    """The polynomial of ascending ``coeffs`` at ``s``, by Horner."""
    acc = s * coeffs[-1] + coeffs[-2]
    for c in coeffs[-3::-1]:
        acc = acc * s + c
    return acc


def sin2_approx(u: torch.Tensor) -> torch.Tensor:
    """``sin(u)^2`` in float32 by the JAX ``snake_approx``'s polynomial:
    ``s P(s)`` with ``s = r^2`` after the reduction, P the degree-6 Horner
    of ``SIN2_C``."""
    _, s = _reduce(u)
    return s * _horner(s, SIN2_C)


def snake_plain(x: torch.Tensor, alpha: torch.Tensor,
                approx: bool = False) -> torch.Tensor:
    """The plain version of the mode ``approx`` selects."""
    if approx:
        return snake_approx_reference(x, alpha)
    return snake_reference(x, alpha)


def snake_backward_reference(x: torch.Tensor, alpha: torch.Tensor,
                             grad: torch.Tensor):
    """Plain version of the backward kernel: ``(dx (B, C, T), dalpha (C,))``
    of the exact mode for the output gradient ``grad``, with u = alpha x,
    inv = 1 / (alpha + 1e-9) and sin(2u) = 2 sin(u) cos(u):

        dx     = g (1 + sin(2u) (alpha inv))
        dalpha = sum over B, T of g (x sin(2u) inv - sin(u)^2 (inv inv))

    in this order of operations, each rounded on its own (the kernel's)."""
    xf = x.to(_wide(x))
    g = grad.to(xf.dtype)
    a = alpha.to(xf.dtype).reshape(1, -1, 1)
    inv = 1.0 / (a + 1e-9)
    u = a * xf
    s = torch.sin(u)
    s2u = (2.0 * s) * torch.cos(u)
    dx = g * (1.0 + s2u * (a * inv))
    terms = g * ((xf * s2u) * inv - (s * s) * (inv * inv))
    return dx.to(x.dtype), torch.sum(terms, dim=(0, 2)).to(alpha.dtype)


def snake_approx_backward_reference(x: torch.Tensor, alpha: torch.Tensor,
                                    grad: torch.Tensor):
    """Plain version of the polynomial mode's backward kernel: ``(dx, dalpha)``
    with the exact mode's expressions (``snake_backward_reference``) and the
    polynomial's value and slope in place of sin(u)^2 and sin(2u):

        sin2  = s P(s)
        slope = d sin2 / du = (2 r) (P(s) + s P'(s))

    where the rounding of k carries no gradient (as JAX's autodiff of
    ``snake_approx`` gives) and P' is the Horner of ``SIN2_DC``; each
    operation rounded on its own (the kernel's)."""
    xf = x.to(_wide(x))
    g = grad.to(xf.dtype)
    a = alpha.to(xf.dtype).reshape(1, -1, 1)
    inv = 1.0 / (a + 1e-9)
    r, s = _reduce(a * xf)
    p = _horner(s, SIN2_C)
    slope = (2.0 * r) * (p + s * _horner(s, SIN2_DC))
    dx = g * (1.0 + slope * (a * inv))
    terms = g * ((xf * slope) * inv - (s * p) * (inv * inv))
    return dx.to(x.dtype), torch.sum(terms, dim=(0, 2)).to(alpha.dtype)


def _check_operands(x: torch.Tensor, alpha: torch.Tensor) -> bool:
    """Raises on what no kernel takes; returns ``is_channels_last(x)``."""
    if x.dtype not in DTYPES or alpha.dtype != torch.float32:
        raise TypeError(
            f"snake: x must be float32 or bfloat16 and alpha float32, got "
            f"{x.dtype} / {alpha.dtype}")
    if x.ndim != 3 or alpha.shape != (x.shape[1],):
        raise ValueError(
            f"snake: x must be (B, C, T) and alpha (C,), got "
            f"{tuple(x.shape)} and {tuple(alpha.shape)}"
        )
    if not alpha.is_contiguous():
        raise ValueError("snake: alpha must be contiguous")
    if alpha.device != x.device:
        raise ValueError("snake: x and alpha must be on the same device")
    return is_channels_last(x)


def snake_backward(x: torch.Tensor, alpha: torch.Tensor, grad: torch.Tensor,
                   approx: bool = False):
    """``(dx, dalpha)`` of the float32 mode ``approx`` selects: the backward
    kernel for CUDA tensors, its plain version (``snake_backward_reference``
    or ``snake_approx_backward_reference``) for CPU tensors. One pass
    writes dx and per-block partial sums of dalpha into a ``(C, B * tiles)``
    buffer, a second launch sums each channel's row in a fixed order: no
    atomics, so two launches on the same inputs give the same bits."""
    if x.device.type == "cpu":
        if approx:
            return snake_approx_backward_reference(x, alpha, grad)
        return snake_backward_reference(x, alpha, grad)
    if x.device.type != "cuda":
        raise ValueError(f"snake_backward: unsupported device {x.device}")
    if _check_operands(x, alpha):
        raise ValueError("snake_backward: x must be (B, C, T) contiguous")
    if x.dtype != torch.float32:
        raise TypeError("snake_backward: only the float32 mode has a backward")
    grad = grad.contiguous()
    if grad.shape != x.shape or grad.dtype != x.dtype or grad.device != x.device:
        raise ValueError(
            f"snake_backward: grad {tuple(grad.shape)} {grad.dtype} does not "
            f"match x {tuple(x.shape)} {x.dtype}")
    b, c, t = x.shape
    dx = torch.empty_like(x)
    dalpha = torch.empty_like(alpha)
    if x.numel() == 0:
        return dx, dalpha.zero_()
    lib = library()
    partials = torch.empty((c, b * lib.vrvq_snake_backward_tiles(t)),
                           dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):  # the runtime launches on x's card
        err = lib.vrvq_snake_backward(
            x.data_ptr(), alpha.data_ptr(), grad.data_ptr(), dx.data_ptr(),
            partials.data_ptr(), dalpha.data_ptr(), b, c, t, int(approx),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    name = "snake_approx_backward" if approx else "snake_backward"
    count("launches." + name)
    check(err, name)
    return dx, dalpha


def _forward(x: torch.Tensor, alpha: torch.Tensor, approx: bool) -> torch.Tensor:
    """The forward kernel (CUDA) or the plain version (CPU)."""
    if x.device.type == "cpu":
        return snake_plain(x, alpha, approx)
    if x.device.type != "cuda":
        raise ValueError(f"snake: unsupported device {x.device}")
    last = _check_operands(x, alpha)
    y = torch.empty_like(x)  # x's strides: the same layout
    if x.numel() == 0:
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):  # the runtime launches on x's card
        if last:
            err = library().vrvq_snake_forward_cl(
                x.data_ptr(), alpha.data_ptr(), y.data_ptr(), x.numel(),
                x.shape[1], DTYPES[x.dtype], int(approx), stream)
        else:
            err = library().vrvq_snake_forward(
                x.data_ptr(), alpha.data_ptr(), y.data_ptr(),
                x.shape[0] * x.shape[1], x.shape[1], x.shape[2],
                DTYPES[x.dtype], int(approx), stream)
    count("launches." + mode_name(x.dtype, approx, last))
    check(err, "snake")
    return y


class SnakeFunction(torch.autograd.Function):
    """A float32 mode (exact, or the polynomial with ``approx``) with its
    gradient: forward through ``_forward``, backward through
    ``snake_backward``; saves ``x`` and ``alpha``."""

    @staticmethod
    def forward(ctx, x, alpha, approx=False):
        ctx.save_for_backward(x, alpha)
        ctx.approx = approx
        return _forward(x, alpha, approx)

    @staticmethod
    def backward(ctx, grad):
        x, alpha = ctx.saved_tensors
        dx, dalpha = snake_backward(x, alpha, grad, ctx.approx)
        return (dx if ctx.needs_input_grad[0] else None,
                dalpha if ctx.needs_input_grad[1] else None, None)


def snake(x: torch.Tensor, alpha: torch.Tensor,
          approx: bool = False) -> torch.Tensor:
    """Snake through the kernel for a CUDA tensor, the plain version for a
    CPU tensor. Takes float32 or bfloat16 ``x (B, C, T)``, contiguous or
    channels-last (the kernel of that layout), and float32 ``alpha (C,)``;
    ``approx`` picks the polynomial ``sin^2``.

    Where a gradient is wanted (grad mode on and ``x`` or ``alpha``
    requiring grad), the float32 modes go through ``SnakeFunction`` and the
    bfloat16 modes raise: they have no backward."""
    if torch.is_grad_enabled() and (x.requires_grad or alpha.requires_grad):
        if x.dtype != torch.float32:
            raise RuntimeError(
                f"snake: the {mode_name(x.dtype, approx)} mode has no "
                "backward; run it under torch.no_grad() or "
                "torch.inference_mode(), or train in float32")
        return SnakeFunction.apply(x, alpha, approx)
    return _forward(x, alpha, approx)
