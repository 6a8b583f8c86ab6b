"""Weight-normed convs, Snake and the codec's residual blocks, in (B, C, T).

Counterpart of ``vrvq_tpu/nn/layers.py``, which works channels-last; here the
layout is PyTorch's. Weight norm is computed in ``forward`` as
``w = v * (g / max(||v||, 1e-32))``, the JAX layer's expression: a conv's norm
is taken per out-channel over (in, k), a transposed conv's per IN-channel over
(out, k). Biases are added after the convolution, as the JAX layers do.

``pad_mode='none'`` builds the padding-free variant that chunked compression
runs; a ResidualUnit then center-crops its skip path to the shorter output.

Inference (``infer/fast.py``): ``folded=True`` convs hold the effective
kernel ``w`` (``nn/fold.py``) and skip the norm, in the ``dtype`` the stack
computes in (float32 or bfloat16); ``Snake1d(approx=True)`` takes the
polynomial ``sin^2``. The time-packed layouts of the JAX module are not
ported. ``DenoisingBlock`` is, though no model of either package uses it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.snake import snake, snake_plain


def weight_norm(v: torch.Tensor, g: torch.Tensor, dims) -> torch.Tensor:
    """``v * (g / max(||v||, 1e-32))``, the norm taken over ``dims`` and ``g``
    shaped to broadcast against it."""
    norm = torch.sqrt(torch.sum(v * v, dim=dims, keepdim=True))
    return v * (g / torch.clamp(norm, min=1e-32))


def _conv_params(module: nn.Module, v_shape, bias_channels: int,
                 folded: bool, dtype: torch.dtype) -> None:
    """Live: ``v`` and ``g`` (float32, ``g`` along ``v``'s first axis).
    Folded: ``w`` of ``v``'s shape in ``dtype``. Then ``bias`` in ``dtype``."""
    module.folded = folded
    if folded:
        module.w = nn.Parameter(torch.empty(v_shape, dtype=dtype))
    else:
        if dtype != torch.float32:
            raise ValueError("a live weight-normed conv computes in float32; "
                             "fold it (nn/fold.py) for another dtype")
        module.v = nn.Parameter(torch.empty(v_shape))
        module.g = nn.Parameter(torch.empty(v_shape[0]))
    module.bias = nn.Parameter(torch.empty(bias_channels, dtype=dtype))


class WNConv1d(nn.Module):
    """Weight-normed 1-D conv. ``v (out, in / groups, k)``, ``g (out,)``;
    folded, ``w (out, in / groups, k)``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 pad_mode: str = "zeros", folded: bool = False,
                 dtype: torch.dtype = torch.float32, groups: int = 1):
        super().__init__()
        if pad_mode not in ("zeros", "none"):
            raise ValueError(f"pad_mode must be 'zeros' or 'none', got {pad_mode}")
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding if pad_mode == "zeros" else 0
        self.dilation = dilation
        self.groups = groups
        _conv_params(self, (out_channels, in_channels // groups, kernel_size),
                     out_channels, folded, dtype)

    def weight(self) -> torch.Tensor:
        if self.folded:
            return self.w
        return weight_norm(self.v, self.g.reshape(-1, 1, 1), (1, 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv1d(x, self.weight(), None, self.stride, self.padding,
                     self.dilation, self.groups)
        return y + self.bias.reshape(1, -1, 1)


class WNConvTranspose1d(nn.Module):
    """Weight-normed transposed 1-D conv. ``v (in, out, k)``, ``g (in,)``;
    folded, ``w (in, out, k)``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, pad_mode: str = "zeros",
                 folded: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        if pad_mode not in ("zeros", "none"):
            raise ValueError(f"pad_mode must be 'zeros' or 'none', got {pad_mode}")
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding if pad_mode == "zeros" else 0
        _conv_params(self, (in_channels, out_channels, kernel_size),
                     out_channels, folded, dtype)

    def weight(self) -> torch.Tensor:
        if self.folded:
            return self.w
        return weight_norm(self.v, self.g.reshape(-1, 1, 1), (1, 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose1d(x, self.weight(), None, self.stride,
                               self.padding)
        return y + self.bias.reshape(1, -1, 1)


class Snake1d(nn.Module):
    """Snake with a per-channel float32 ``alpha (C,)``, the polynomial
    ``sin^2`` with ``approx``. On the card it launches the Snake kernel
    unless ``use_kernel`` is off (the plain version then runs there, for
    comparisons)."""

    def __init__(self, channels: int, approx: bool = False):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(channels))
        self.approx = approx
        self.use_kernel = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_kernel:
            return snake(x, self.alpha, self.approx)
        return snake_plain(x, self.alpha, self.approx)


class ResidualUnit(nn.Module):
    """Snake -> dilated k=7 conv -> Snake -> k=1 conv, plus the skip path,
    center-cropped to the output when padding is off. ``folded``, ``approx``
    and ``dtype`` go to every conv and Snake of the unit (as in the blocks
    below)."""

    def __init__(self, dim: int, dilation: int = 1, padding: bool = True,
                 folded: bool = False, approx: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        pad_mode = "zeros" if padding else "none"
        self.snake1 = Snake1d(dim, approx)
        self.conv1 = WNConv1d(dim, dim, 7, dilation=dilation,
                              padding=3 * dilation, pad_mode=pad_mode,
                              folded=folded, dtype=dtype)
        self.snake2 = Snake1d(dim, approx)
        self.conv2 = WNConv1d(dim, dim, 1, folded=folded, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.snake2(self.conv1(self.snake1(x))))
        crop = (x.shape[-1] - y.shape[-1]) // 2
        if crop > 0:
            x = x[..., crop:-crop]
        return x + y


class EncoderBlock(nn.Module):
    """3 ResidualUnits (dilations 1/3/9 at dim/2) + Snake + strided conv."""

    def __init__(self, dim: int, stride: int = 1, padding: bool = True,
                 folded: bool = False, approx: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        half = dim // 2
        self.res0 = ResidualUnit(half, 1, padding, folded, approx, dtype)
        self.res1 = ResidualUnit(half, 3, padding, folded, approx, dtype)
        self.res2 = ResidualUnit(half, 9, padding, folded, approx, dtype)
        self.snake = Snake1d(half, approx)
        self.down = WNConv1d(half, dim, 2 * stride, stride=stride,
                             padding=math.ceil(stride / 2),
                             pad_mode="zeros" if padding else "none",
                             folded=folded, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.res2(self.res1(self.res0(x)))
        return self.down(self.snake(x))


class DecoderBlock(nn.Module):
    """Snake + transposed conv (kernel 2 * stride) + 3 ResidualUnits."""

    def __init__(self, input_dim: int, output_dim: int, stride: int = 1,
                 padding: bool = True, folded: bool = False,
                 approx: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.snake = Snake1d(input_dim, approx)
        self.up = WNConvTranspose1d(input_dim, output_dim, 2 * stride,
                                    stride=stride,
                                    padding=math.ceil(stride / 2),
                                    pad_mode="zeros" if padding else "none",
                                    folded=folded, dtype=dtype)
        self.res0 = ResidualUnit(output_dim, 1, padding, folded, approx, dtype)
        self.res1 = ResidualUnit(output_dim, 3, padding, folded, approx, dtype)
        self.res2 = ResidualUnit(output_dim, 9, padding, folded, approx, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.up(self.snake(x))
        return self.res2(self.res1(self.res0(x)))


class DenoisingBlock(nn.Module):
    """3 ResidualUnits (dilations 1/3/9) + Snake + k=3 conv, at ``dim``
    channels throughout. The JAX package keeps it for inventory parity with
    the reference; no model uses it. Its keys: ``res{0,1,2}.*``, ``snake``,
    ``conv``."""

    def __init__(self, dim: int = 16, padding: bool = True):
        super().__init__()
        self.res0 = ResidualUnit(dim, 1, padding)
        self.res1 = ResidualUnit(dim, 3, padding)
        self.res2 = ResidualUnit(dim, 9, padding)
        self.snake = Snake1d(dim)
        self.conv = WNConv1d(dim, dim, 3, padding=1,
                             pad_mode="zeros" if padding else "none")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(self.snake(self.res2(self.res1(self.res0(x)))))
