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
polynomial ``sin^2``. ``DenoisingBlock`` is ported, though no model of either
package uses it.

Time-packed layouts (space to depth, the JAX module's ``time_pack*``
fields): ``pack_time(x, P)`` maps ``x (B, C, T)`` to ``(B, P * C, T / P)``,
packed channel ``phi * C + i`` carrying channel ``i`` at time
``P * u + phi`` (the JAX phase order). A packed conv computes the same sums
as the plain one with a dense kernel over that layout
(``pack_conv_kernel``, ``pack_convtranspose_kernel``), built from the same
parameters by one gather through a small index map (the weight's tap for
each output phase, input phase and tap) computed once per geometry and one
copy into the packed order; its bias
and a packed Snake's alpha are tiled ``P`` times. The parameters and
state-dict keys stay those of the unpacked module: every module, live or
folded, derives its packed tensors at each call (a live one's then carry
the gradient), so they cannot go stale.

Channels-last (``channels_last=True``, folded unpacked convs; the bfloat16
decoder, ``models/dac_vrvq.py``): activations keep the shape ``(B, C, T)``
over ``(B, T, C)`` memory (``to_channels_last``), and each conv runs as a
2-D conv over the ``(B, C, 1, T)`` view, PyTorch's ``channels_last``
format, so cuDNN takes NHWC tensor-core kernels with no transpose. The
folded kernel ``w`` keeps its shape, dtype and key, stored with the strides
of that format from the time the module is built or loaded, so no call
converts it. Snakes, bias adds, residual adds and crops work on the views as
they are, in either layout. cuDNN serves two kinds of NHWC conv without
tensor cores, a conv dilated past 3 and a conv to fewer than 16 channels;
``conv_last`` hands it those in a form it serves with them (``conv_form``):
the dilated conv undilated over its frames' interleaved phases, the narrow
one with its kernel widened by zero rows.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.snake import snake, snake_plain


def weight_norm(v: torch.Tensor, g: torch.Tensor, dims) -> torch.Tensor:
    """``v * (g / max(||v||, 1e-32))``, the norm taken over ``dims`` and ``g``
    shaped to broadcast against it."""
    norm = torch.sqrt(torch.sum(v * v, dim=dims, keepdim=True))
    return v * (g / torch.clamp(norm, min=1e-32))


# ------------------------------------------------------------ time packing


def pack_time(x: torch.Tensor, pack: int) -> torch.Tensor:
    """``(B, C, T) -> (B, pack * C, T / pack)``: packed channel
    ``phi * C + i`` at column ``u`` holds ``x[:, i, pack * u + phi]``."""
    b, c, t = x.shape
    return x.reshape(b, c, t // pack, pack).permute(0, 3, 1, 2).reshape(
        b, pack * c, t // pack)


def unpack_time(x: torch.Tensor, pack: int) -> torch.Tensor:
    """The inverse of ``pack_time``: ``(B, pack * C, U) -> (B, C, U * pack)``."""
    b, pc, u = x.shape
    return x.reshape(b, pack, pc // pack, u).permute(0, 2, 3, 1).reshape(
        b, pc // pack, u * pack)


@functools.lru_cache(maxsize=None)
def _pack_map(transposed: bool, k: int, dilation: int, stride: int,
              padding: int, pack_in: int, pack_out: int):
    """``(taps, lo, hi0)`` of a packed kernel: ``taps (Q, P, n_taps)``, the
    tap of the weight that entry (output phase, input phase, tap) of the
    packed kernel takes for every channel pair, ``k`` (a zero tap appended
    to the weight) where it takes none, and the paddings of its stride-1
    conv: ``lo`` on the left, ``hi0 + U' - U`` on the right for ``U`` input
    and ``U'`` output columns (JAX's transforms: ``hi0`` is a conv's
    ``tau_max``, a transposed conv's ``-tau_min``). Taps of one output phase
    land on distinct (tap, input phase) slots, so no slot is written twice.
    The map does not depend on the channels: one small entry per conv
    geometry of the model."""
    P, Q = pack_in, pack_out
    if transposed:
        if Q != P * stride:
            raise ValueError(f"pack_out ({Q}) must equal pack_in*stride "
                             f"({P}*{stride})")
        # tap (pi, j) of input phase pi lands at offset m // Q, phase m % Q
        ms = {(pi, j): pi * stride + j - padding for pi in range(P) for j in range(k)}
        taus = [m // Q for m in ms.values()]
    else:
        if P != Q * stride:
            raise ValueError(f"pack_in ({P}) must equal pack_out*stride "
                             f"({Q}*{stride})")
        ms = {(psi, j): psi * stride + j * dilation - padding
              for psi in range(Q) for j in range(k)}
        taus = [m // P for m in ms.values()]
    tau_min, tau_max = min(taus), max(taus)
    taps = np.full((Q, P, tau_max - tau_min + 1), k, np.int64)
    for (phase, j), m in ms.items():
        if transposed:  # phase is the input's pi
            taps[m % Q, phase, tau_max - m // Q] = j
        else:  # phase is the output's psi
            taps[phase, m % P, m // P - tau_min] = j
    if transposed:
        return taps, tau_max, -tau_min
    return taps, -tau_min, tau_max


@functools.lru_cache(maxsize=64)
def _taps_on(geometry: tuple, device: torch.device) -> torch.Tensor:
    """``_pack_map``'s taps of ``geometry``, flat, on ``device``."""
    with torch.inference_mode(False):
        return torch.from_numpy(_pack_map(*geometry)[0].reshape(-1)).to(device)


def _pack_kernel(w: torch.Tensor, geometry: tuple) -> torch.Tensor:
    """The packed kernel ``(Q * cout, P * cin, n_taps)`` of ``w`` (``(cout,
    cin, k)``, or ``(cin, cout, k)`` for a transposed conv, ``geometry[0]``):
    one gather of ``w``'s taps (and a zero tap) for every (output phase,
    input phase, tap), then one copy into the packed order."""
    a, b, _ = w.shape
    q, p, n = _pack_map(*geometry)[0].shape
    g = F.pad(w, (0, 1))[..., _taps_on(geometry, w.device)].reshape(a, b, q, p, n)
    if geometry[0]:  # (cin, cout, Q, P, n) -> (Q, cout, P, cin, n)
        return g.permute(2, 1, 3, 0, 4).reshape(q * b, p * a, n)
    return g.permute(2, 0, 3, 1, 4).reshape(q * a, p * b, n)


def pack_conv_kernel(w: torch.Tensor, *, dilation: int, stride: int,
                     padding: int, pack_in: int, pack_out: int):
    """A conv's kernel ``w (cout, cin, k)`` over the time-packed layouts:
    ``(Kp (Q * cout, P * cin, n_taps), lo, tau_max)``, such that
    ``conv1d(X, Kp)`` over ``X = pack_time(x, P)`` padded by ``(lo, tau_max +
    U' - U)`` (``U``, ``U'``: input and output columns) gives the conv's output
    packed by ``Q``. Needs ``pack_in == pack_out * stride``. ``Kp`` is JAX's
    ``pack_conv_kernel`` of the WIO kernel, transposed to this layout."""
    geometry = (False, w.shape[2], dilation, stride, padding, pack_in, pack_out)
    _, lo, tau_max = _pack_map(*geometry)
    return _pack_kernel(w, geometry), lo, tau_max


def pack_convtranspose_kernel(w: torch.Tensor, *, stride: int, padding: int,
                              pack_in: int, pack_out: int):
    """A transposed conv's kernel ``w (cin, cout, k)`` as a conv over the
    time-packed layouts: ``(Kp (Q * cout, P * cin, n_taps), lo, tau_min)``,
    such that ``conv1d(X, Kp)`` padded by ``(lo, U' - U - tau_min)`` gives
    the transposed conv's output packed by ``Q``. Needs ``pack_out ==
    pack_in * stride`` (upsampling grows the packing). ``Kp`` is JAX's
    ``pack_convtranspose_kernel``, transposed to this layout."""
    geometry = (True, w.shape[2], 1, stride, padding, pack_in, pack_out)
    _, lo, hi0 = _pack_map(*geometry)
    return _pack_kernel(w, geometry), lo, -hi0


def _conv_padded(x: torch.Tensor, kernel: torch.Tensor, lo: int, hi: int):
    """A stride-1 ``conv1d`` of ``x`` padded by ``(lo, hi)``: conv1d's own
    padding where the two sides are equal (every packed conv of the
    codec's flagship), else ``F.pad`` first."""
    if lo == hi:
        return F.conv1d(x, kernel, None, 1, lo)
    return F.conv1d(F.pad(x, (lo, hi)), kernel)


def to_channels_last(x: torch.Tensor,
                     dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x (B, C, T)`` in channels-last memory (``(B, T, C)`` contiguous,
    transposed), cast to ``dtype``: one copy, or none where ``x`` already
    lies so in ``dtype``."""
    dtype = x.dtype if dtype is None else dtype
    if x.dtype == dtype and x.transpose(1, 2).is_contiguous():
        return x
    b, c, t = x.shape
    return x.new_empty((b, t, c), dtype=dtype).transpose(1, 2).copy_(x)


# cuDNN's NHWC tensor-core kernels take dilations up to this, and convs to at
# least this many channels; a narrower conv is widened to WIDE_OUT_CHANNELS,
# where cuDNN picks a faster kernel than at 16 (the decoder's conv census,
# PERF.md §5)
CUDNN_MAX_DILATION = 3
CUDNN_MIN_OUT_CHANNELS = 16
WIDE_OUT_CHANNELS = 32


def conv_form(out_channels: int, stride: int = 1, padding: int = 0,
              dilation: int = 1, groups: int = 1) -> str:
    """How ``conv_last`` hands a (not transposed) conv to cuDNN: ``"wide"``,
    its kernel widened to ``WIDE_OUT_CHANNELS`` by zero rows (fewer than
    ``CUDNN_MIN_OUT_CHANNELS`` outputs, no groups); ``"phases"``, undilated
    over the frames' phases (dilated past ``CUDNN_MAX_DILATION``, stride 1,
    no groups, the padding a multiple of the dilation); else ``"nhwc"``, as
    it is."""
    if out_channels < CUDNN_MIN_OUT_CHANNELS and groups == 1:
        return "wide"
    if (dilation > CUDNN_MAX_DILATION and stride == 1 and groups == 1
            and padding % dilation == 0):
        return "phases"
    return "nhwc"


def conv_last(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
              padding: int = 0, dilation: int = 1, groups: int = 1,
              transposed: bool = False) -> torch.Tensor:
    """The conv, without bias, of ``x (B, C_in, T)`` in channels-last memory
    with a kernel ``w`` stored channels-last (``(C_out, C_in / groups, K)``,
    or ``(C_in, C_out, K)`` ``transposed``), as 2-D convs over NHWC views,
    in the form ``conv_form`` names; ``y (B, C_out, T_out)`` channels-last
    (a view where the form crops it)."""
    if transposed:
        return F.conv_transpose2d(x.unsqueeze(2), w.unsqueeze(2), None,
                                  (1, stride), (0, padding)).squeeze(2)
    form = conv_form(w.shape[0], stride, padding, dilation, groups)
    if form == "wide":
        cout, cin, k = w.shape
        wide = w.new_zeros((WIDE_OUT_CHANNELS, k, cin))
        wide[:cout] = w.transpose(1, 2)
        return conv_last(x, wide.transpose(1, 2), stride, padding,
                         dilation)[:, :cout]
    if form == "phases":
        return _conv_phases(x, w, padding, dilation)
    return F.conv2d(x.unsqueeze(2), w.unsqueeze(2), None, (1, stride),
                    (0, padding), (1, dilation), groups).squeeze(2)


def _conv_phases(x: torch.Tensor, w: torch.Tensor, padding: int,
                 d: int) -> torch.Tensor:
    """A stride-1 conv dilated by ``d`` as an undilated one. Output frame
    ``d s + r`` sums the taps at frames ``d (s + j - padding / d) + r``, so
    each phase ``r`` is an undilated conv along ``s`` padded by ``padding /
    d``. Over (B, T, C) memory the phases are the last axis of the NHWC
    view (B, C, S, d), ``S = ceil(T / d)``: no copy where ``d`` divides T,
    else one, with the zero frames that fill T to ``S d``."""
    b, c, t = x.shape
    s = -(-t // d)
    rows = x.transpose(1, 2)
    if s * d != t:
        rows = torch.cat([rows, rows.new_zeros((b, s * d - t, c))], 1)
    # the kernel as (C_out, C_in, K, 1) with channels-last strides
    kernel = w.transpose(1, 2).unsqueeze(2).permute(0, 3, 1, 2)
    y = F.conv2d(rows.reshape(b, s, d, c).permute(0, 3, 1, 2), kernel, None, 1,
                 (padding // d, 0))
    t_out = t + 2 * padding - d * (w.shape[2] - 1)
    return y.permute(0, 2, 3, 1).reshape(b, -1, w.shape[0])[:, :t_out].transpose(1, 2)


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


class _PackedConv(nn.Module):
    """What the two weight-normed convs share: the effective kernel, and with
    ``time_pack_in`` / ``time_pack_out`` other than 1 the packed kernel and
    bias (derived at every call from the parameters, at
    ``_pack_geometry``) applied as a stride-1 conv."""

    def _init_pack(self, time_pack_in: int, time_pack_out: int,
                   channels_last: bool) -> None:
        self.time_pack_in, self.time_pack_out = time_pack_in, time_pack_out
        self.packed = (time_pack_in, time_pack_out) != (1, 1)
        if self.packed:
            _pack_map(*self._pack_geometry())  # raises on a packing JAX refuses
        if channels_last and (self.packed or not self.folded):
            raise ValueError("a channels-last conv is folded and unpacked")
        self.channels_last = channels_last
        if channels_last:
            self.w = nn.Parameter(to_channels_last(self.w.data))

    def _load_from_state_dict(self, *args, **kwargs):
        # a state loaded by assignment brings its own tensor: store it in the
        # channels-last format once, here (one already so is kept, shared)
        super()._load_from_state_dict(*args, **kwargs)
        if self.channels_last and not self.w.transpose(1, 2).is_contiguous():
            self.w = nn.Parameter(to_channels_last(self.w.detach()),
                                  requires_grad=self.w.requires_grad)

    def _forward_last(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        """``conv_last`` of ``x`` with ``w``, plus the bias; the output keeps
        the layout."""
        y = conv_last(to_channels_last(x), self.w, self.stride, self.padding,
                      **kwargs)
        return y + self.bias.reshape(1, -1, 1)

    def weight(self) -> torch.Tensor:
        if self.folded:
            return self.w
        return weight_norm(self.v, self.g.reshape(-1, 1, 1), (1, 2))

    def packed_kernel_shape(self) -> tuple:
        """``(Q * cout, P * cin, n_taps)`` of the packed kernel."""
        geometry = self._pack_geometry()
        q, p, n = _pack_map(*geometry)[0].shape
        a, b = (self.w if self.folded else self.v).shape[:2]
        cin, cout = (a, b) if geometry[0] else (b, a)
        return q * cout, p * cin, n

    def _packed_forward(self, x: torch.Tensor, t_out: int) -> torch.Tensor:
        """``x`` packed by ``time_pack_in`` through the packed kernel, to the
        ``t_out`` samples of output packed by ``time_pack_out``."""
        q = self.time_pack_out
        if t_out % q:
            raise ValueError(f"packed output length {t_out} not a multiple of "
                             f"pack_out {q}")
        geometry = self._pack_geometry()
        _, lo, hi0 = _pack_map(*geometry)
        y = _conv_padded(x, _pack_kernel(self.weight(), geometry), lo,
                         hi0 + t_out // q - x.shape[-1])
        return y + self.bias.repeat(q).reshape(1, -1, 1)


class WNConv1d(_PackedConv):
    """Weight-normed 1-D conv. ``v (out, in / groups, k)``, ``g (out,)``;
    folded, ``w (out, in / groups, k)``. With ``time_pack_in`` P and
    ``time_pack_out`` Q (``P == Q * stride``), input ``(B, P * in, T / P)``
    and output ``(B, Q * out, T_out / Q)``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 pad_mode: str = "zeros", folded: bool = False,
                 dtype: torch.dtype = torch.float32, groups: int = 1,
                 time_pack_in: int = 1, time_pack_out: int = 1,
                 channels_last: bool = False):
        super().__init__()
        if pad_mode not in ("zeros", "none"):
            raise ValueError(f"pad_mode must be 'zeros' or 'none', got {pad_mode}")
        if (time_pack_in, time_pack_out) != (1, 1) and (
                pad_mode != "zeros" or groups != 1):
            raise ValueError("time-packed conv requires zero padding "
                             "and groups == 1")
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding if pad_mode == "zeros" else 0
        self.dilation = dilation
        self.groups = groups
        _conv_params(self, (out_channels, in_channels // groups, kernel_size),
                     out_channels, folded, dtype)
        self._init_pack(time_pack_in, time_pack_out, channels_last)

    def _pack_geometry(self) -> tuple:
        return (False, self.kernel_size, self.dilation, self.stride,
                self.padding, self.time_pack_in, self.time_pack_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.packed:
            t_out = (x.shape[-1] * self.time_pack_in + 2 * self.padding
                     - (self.kernel_size - 1) * self.dilation - 1) // self.stride + 1
            return self._packed_forward(x, t_out)
        if self.channels_last:
            return self._forward_last(x, dilation=self.dilation,
                                      groups=self.groups)
        y = F.conv1d(x, self.weight(), None, self.stride, self.padding,
                     self.dilation, self.groups)
        return y + self.bias.reshape(1, -1, 1)


class WNConvTranspose1d(_PackedConv):
    """Weight-normed transposed 1-D conv. ``v (in, out, k)``, ``g (in,)``;
    folded, ``w (in, out, k)``. With ``time_pack_in`` P and
    ``time_pack_out`` Q (``Q == P * stride``), input ``(B, P * in, T / P)``
    and output ``(B, Q * out, T_out / Q)``, computed as a stride-1 conv."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, pad_mode: str = "zeros",
                 folded: bool = False, dtype: torch.dtype = torch.float32,
                 time_pack_in: int = 1, time_pack_out: int = 1,
                 channels_last: bool = False):
        super().__init__()
        if pad_mode not in ("zeros", "none"):
            raise ValueError(f"pad_mode must be 'zeros' or 'none', got {pad_mode}")
        if (time_pack_in, time_pack_out) != (1, 1) and pad_mode != "zeros":
            raise ValueError("time-packed transposed conv requires zero padding")
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding if pad_mode == "zeros" else 0
        _conv_params(self, (in_channels, out_channels, kernel_size),
                     out_channels, folded, dtype)
        self._init_pack(time_pack_in, time_pack_out, channels_last)

    def _pack_geometry(self) -> tuple:
        return (True, self.kernel_size, 1, self.stride, self.padding,
                self.time_pack_in, self.time_pack_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.packed:
            t_out = ((x.shape[-1] * self.time_pack_in - 1) * self.stride
                     - 2 * self.padding + self.kernel_size)
            return self._packed_forward(x, t_out)
        if self.channels_last:
            return self._forward_last(x, transposed=True)
        y = F.conv_transpose1d(x, self.weight(), None, self.stride,
                               self.padding)
        return y + self.bias.reshape(1, -1, 1)


class Snake1d(nn.Module):
    """Snake with a per-channel float32 ``alpha (C,)``, the polynomial
    ``sin^2`` with ``approx``. On the card it launches the Snake kernel
    unless ``use_kernel`` is off (the plain version then runs there, for
    comparisons). With ``time_pack`` P it takes ``(B, P * C, T / P)`` and
    alpha tiled P times at every call (packed channel ``phi * C + i`` uses
    ``alpha[i]``)."""

    def __init__(self, channels: int, approx: bool = False, time_pack: int = 1):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(channels))
        self.approx = approx
        self.time_pack = time_pack
        self.use_kernel = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alpha = self.alpha.repeat(self.time_pack) if self.time_pack != 1 else self.alpha
        if self.use_kernel:
            return snake(x, alpha, self.approx)
        return snake_plain(x, alpha, self.approx)


class ResidualUnit(nn.Module):
    """Snake -> dilated k=7 conv -> Snake -> k=1 conv, plus the skip path,
    center-cropped to the output when padding is off. ``folded``, ``approx``,
    ``dtype`` and ``channels_last`` go to every conv and Snake of the unit
    (as in the blocks below); ``time_pack`` runs the unit in that packed
    layout (padding only)."""

    def __init__(self, dim: int, dilation: int = 1, padding: bool = True,
                 folded: bool = False, approx: bool = False,
                 dtype: torch.dtype = torch.float32, time_pack: int = 1,
                 channels_last: bool = False):
        super().__init__()
        if time_pack != 1 and not padding:
            raise ValueError("time-packed ResidualUnit requires padding=True")
        pad_mode = "zeros" if padding else "none"
        tp = time_pack
        self.snake1 = Snake1d(dim, approx, tp)
        self.conv1 = WNConv1d(dim, dim, 7, dilation=dilation,
                              padding=3 * dilation, pad_mode=pad_mode,
                              folded=folded, dtype=dtype, time_pack_in=tp,
                              time_pack_out=tp, channels_last=channels_last)
        self.snake2 = Snake1d(dim, approx, tp)
        self.conv2 = WNConv1d(dim, dim, 1, folded=folded, dtype=dtype,
                              time_pack_in=tp, time_pack_out=tp,
                              channels_last=channels_last)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.snake2(self.conv1(self.snake1(x))))
        crop = (x.shape[-1] - y.shape[-1]) // 2
        if crop > 0:
            x = x[..., crop:-crop]
        return x + y


class EncoderBlock(nn.Module):
    """3 ResidualUnits (dilations 1/3/9 at dim/2) + Snake + strided conv.
    With ``time_pack`` (which must be the stride) the input is packed and
    the strided conv consumes the packing: the output's layout is the plain
    one."""

    def __init__(self, dim: int, stride: int = 1, padding: bool = True,
                 folded: bool = False, approx: bool = False,
                 dtype: torch.dtype = torch.float32, time_pack: int = 1):
        super().__init__()
        if time_pack != 1 and time_pack != stride:
            raise ValueError("time-packed EncoderBlock requires "
                             "time_pack == stride (packed output would "
                             "otherwise leak into the next block)")
        half, tp = dim // 2, time_pack
        self.res0 = ResidualUnit(half, 1, padding, folded, approx, dtype, tp)
        self.res1 = ResidualUnit(half, 3, padding, folded, approx, dtype, tp)
        self.res2 = ResidualUnit(half, 9, padding, folded, approx, dtype, tp)
        self.snake = Snake1d(half, approx, tp)
        self.down = WNConv1d(half, dim, 2 * stride, stride=stride,
                             padding=math.ceil(stride / 2),
                             pad_mode="zeros" if padding else "none",
                             folded=folded, dtype=dtype, time_pack_in=tp)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.res2(self.res1(self.res0(x)))
        return self.down(self.snake(x))


class DecoderBlock(nn.Module):
    """Snake + transposed conv (kernel 2 * stride) + 3 ResidualUnits.

    ``packed``: the input is packed by ``time_pack_in`` (1: the plain
    layout), the transposed conv grows the packing to ``time_pack_in *
    stride`` and the units run packed; the output stays packed.
    ``packed_up_only``: only the transposed conv runs packed, and its output
    is unpacked before the units. ``channels_last``: every conv in that
    layout (unpacked only)."""

    def __init__(self, input_dim: int, output_dim: int, stride: int = 1,
                 padding: bool = True, folded: bool = False,
                 approx: bool = False, dtype: torch.dtype = torch.float32,
                 packed: bool = False, time_pack_in: int = 1,
                 packed_up_only: bool = False, channels_last: bool = False):
        super().__init__()
        tp_in = time_pack_in
        tp_out = tp_in * stride if (packed or packed_up_only) else 1
        if tp_in != 1 and not (packed or packed_up_only):
            raise ValueError("time_pack_in != 1 requires packed=True")
        if packed and packed_up_only:
            raise ValueError("packed and packed_up_only are exclusive")
        if (packed or packed_up_only) and not padding:
            raise ValueError("time-packed DecoderBlock requires padding=True")
        self.unpack_after_up = tp_out if packed_up_only else 1
        tp_units = tp_out if packed else 1
        self.snake = Snake1d(input_dim, approx, tp_in)
        self.up = WNConvTranspose1d(input_dim, output_dim, 2 * stride,
                                    stride=stride,
                                    padding=math.ceil(stride / 2),
                                    pad_mode="zeros" if padding else "none",
                                    folded=folded, dtype=dtype,
                                    time_pack_in=tp_in, time_pack_out=tp_out,
                                    channels_last=channels_last)
        self.res0, self.res1, self.res2 = (
            ResidualUnit(output_dim, d, padding, folded, approx, dtype, tp_units,
                         channels_last) for d in (1, 3, 9))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.up(self.snake(x))
        if self.unpack_after_up != 1:
            x = unpack_time(x, self.unpack_after_up)
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
