"""DAC_VRVQ: the codec, Encoder -> residual VQ -> Decoder, variable-bitrate
(``model_type='VBR'``, the flagship) or constant-bitrate (``'CBR'``).

Counterpart of ``vrvq_tpu/models/dac_vrvq.py``, in (B, C, T):
audio ``(B, 1, T)``, latents ``(B, D, T')``, codes ``(B, Nq, T')``.
``padding=False`` builds the padding-free codec that chunked compression
runs; ``clone(padding=...)`` gives the other variant on the same parameters.
A ``Profile`` sets how the conv stacks run at inference (the JAX model's
inference fields, ``vrvq_tpu/models/dac_vrvq.py``): folded weight norm,
the polynomial Snake, the compute dtype and the time-packed layouts, per
stack; ``infer/fast.py`` builds the fast and turbo profiles. An encoder computing in bfloat16 hands
its latents and feature to the quantizer in float32, as the JAX encoder
does. A stack's Snake is the config's
(``encoder_snake_approx``, ``decoder_snake_approx``, which training runs
too) unless the profile sets it. The quantizer, with the importance subnet,
always runs live in float32 with the exact Snake. The time-packed layouts
(``encoder_packed``, ``decoder_packed``, ``decoder_packed_up``: the config's
unless the profile sets them) compute the same sums over the same
parameters; they need the padded codec, so ``clone(padding=False)`` of a
packed model raises, as the JAX model fails when applied. ``forward(...,
train=True)`` is the training forward: the quantizer's random draws (VBR:
levels and the batch partition; CBR: quantizer dropout) with its losses.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig
from ..nn.layers import (DecoderBlock, EncoderBlock, Snake1d, WNConv1d,
                         pack_time, to_channels_last, unpack_time)
from ..utils import count
from . import codec
from .quantize import ResidualVectorQuantize, VBRResidualVectorQuantize


@dataclass(frozen=True)
class Profile:
    """How each conv stack runs at inference. The defaults are the live
    exact codec. A compute dtype other than float32 needs its stack folded
    (its kernels are stored in that dtype). A Snake or packing field left
    ``None`` takes the config's."""

    encoder_folded: bool = False
    decoder_folded: bool = False
    decoder_compute_dtype: torch.dtype = torch.float32
    encoder_compute_dtype: torch.dtype = torch.float32
    encoder_snake_approx: Optional[bool] = None
    decoder_snake_approx: Optional[bool] = None
    encoder_packed: Optional[bool] = None
    decoder_packed: Optional[int] = None
    decoder_packed_up: Optional[int] = None


class Encoder(nn.Module):
    """k=7 in conv -> EncoderBlocks (width doubles at each stride) -> Snake ->
    k=3 out conv. (B, 1, T) -> (B, latent_dim, T'), float32 whatever
    ``dtype`` the stack computes in. ``packed``: the input is packed by 2,
    the in conv and ``block_0`` run packed and ``block_0``'s strided conv
    consumes the packing (needs padding, a first stride of 2 and an even
    input length)."""

    def __init__(self, d_model: int, strides: Sequence[int], latent_dim: int,
                 padding: bool = True, folded: bool = False,
                 snake_approx: bool = False,
                 dtype: torch.dtype = torch.float32, packed: bool = False):
        super().__init__()
        if packed and (not padding or not strides or strides[0] != 2):
            raise ValueError(
                "packed encoder requires padding=True, strides[0] == 2 and "
                f"an even input length (got strides={tuple(strides)}, "
                f"padding={padding})")
        pad_mode = "zeros" if padding else "none"
        self.dtype = dtype
        self.packed = packed
        self.strides = tuple(strides)
        tp = 2 if packed else 1
        self.in_conv = WNConv1d(1, d_model, 7, padding=3, pad_mode=pad_mode,
                                folded=folded, dtype=dtype, time_pack_in=tp,
                                time_pack_out=tp)
        self.n_blocks = len(strides)
        d = d_model
        for i, stride in enumerate(strides):
            d *= 2
            self.add_module(f"block_{i}", EncoderBlock(
                d, stride, padding, folded, snake_approx, dtype,
                tp if i == 0 else 1))
        self.snake = Snake1d(d, snake_approx)
        self.out_conv = WNConv1d(d, latent_dim, 3, padding=1, pad_mode=pad_mode,
                                 folded=folded, dtype=dtype)

    def forward(self, x: torch.Tensor, return_feat: bool = False):
        """With ``return_feat`` also the activation after the last block,
        which feeds the importance subnet (both float32)."""
        x = x.to(self.dtype)
        if self.packed:
            if x.shape[-1] % 2:
                raise ValueError(
                    "packed encoder requires padding=True, strides[0] == 2 and "
                    f"an even input length (got strides={self.strides}, "
                    f"T={x.shape[-1]})")
            x = pack_time(x, 2)
        x = self.in_conv(x)
        for i in range(self.n_blocks):
            x = getattr(self, f"block_{i}")(x)
        feat = x
        x = self.out_conv(self.snake(x)).float()
        if return_feat:
            return x, feat.float()
        return x


class Decoder(nn.Module):
    """k=7 in conv -> DecoderBlocks (width halves at each rate) -> Snake ->
    k=7 out conv -> tanh. (B, latent, T') -> (B, 1, T), float32 whatever
    ``dtype`` the stack computes in. ``packed_blocks``: the last blocks and
    the tail run packed (the packing grows by each block's stride), and the
    output is unpacked after the out conv; ``packed_up_blocks``: only the
    last blocks' transposed convs run packed, each unpacked at once.

    Unpacked in bfloat16 (the fast profile's decoder) the stack runs
    channels-last (``nn/layers.py``): one copy turns the latents into that
    layout and dtype, every conv is an NHWC conv on the tensor cores, and
    the one-channel output is the same memory in either layout. Float32 and
    packed decoders keep (B, C, T). Each call counts its layout
    (``decoder.channels_last`` or ``decoder.ncl``)."""

    def __init__(self, input_channel: int, channels: int, rates: Sequence[int],
                 d_out: int = 1, padding: bool = True, folded: bool = False,
                 snake_approx: bool = False,
                 dtype: torch.dtype = torch.float32, packed_blocks: int = 0,
                 packed_up_blocks: int = 0):
        super().__init__()
        if packed_blocks and packed_up_blocks:
            raise ValueError("packed_blocks and packed_up_blocks are "
                             "exclusive")
        if (packed_blocks or packed_up_blocks) and not padding:
            raise ValueError("packed decoder requires padding=True")
        pad_mode = "zeros" if padding else "none"
        self.dtype = dtype
        last = self.channels_last = (dtype == torch.bfloat16 and not packed_blocks
                                     and not packed_up_blocks)
        self.in_conv = WNConv1d(input_channel, channels, 7, padding=3,
                                pad_mode=pad_mode, folded=folded, dtype=dtype,
                                channels_last=last)
        self.n_blocks = len(rates)
        output_dim = channels
        pack = 1
        for i, stride in enumerate(rates):
            input_dim = channels // (2 ** i)
            output_dim = channels // (2 ** (i + 1))
            packed = i >= self.n_blocks - packed_blocks
            self.add_module(f"block_{i}", DecoderBlock(
                input_dim, output_dim, stride, padding, folded, snake_approx,
                dtype, packed=packed, time_pack_in=pack,
                packed_up_only=i >= self.n_blocks - packed_up_blocks,
                channels_last=last))
            if packed:
                pack *= stride
        self.pack = pack
        self.snake = Snake1d(output_dim, snake_approx, pack)
        self.out_conv = WNConv1d(output_dim, d_out, 7, padding=3,
                                 pad_mode=pad_mode, folded=folded, dtype=dtype,
                                 time_pack_in=pack, time_pack_out=pack,
                                 channels_last=last)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.channels_last:
            count("decoder.channels_last")
            x = to_channels_last(x, self.dtype)
        else:
            count("decoder.ncl")
            x = x.to(self.dtype)
        x = self.in_conv(x)
        for i in range(self.n_blocks):
            x = getattr(self, f"block_{i}")(x)
        x = self.out_conv(self.snake(x))
        if self.pack != 1:
            x = unpack_time(x, self.pack)
        return torch.tanh(x).float()


def _either(profile_value, config_value):
    return config_value if profile_value is None else profile_value


def gated_kwargs(config: ModelConfig) -> dict:
    """A ``GatedResidualVectorQuantize``'s arguments from ``config``."""
    return dict(imp2mask_alpha=config.imp2mask_alpha,
                quantizer_dropout=config.quantizer_dropout,
                full_codebook_rate=config.full_codebook_rate,
                level_min=config.level_min, level_max=config.level_max,
                level_dist=config.level_dist)


class DAC_VRVQ(nn.Module):
    """The codec. Parameters are left uninitialized: load them
    (``convert.state_dict_from_jax``) or draw them (``convert.init_params``)."""

    # a VBR mask keeps a prefix of the stages, so per-frame counts (the
    # .dac's vbr_counts) hold it
    prefix_mask = True

    def __init__(self, config: ModelConfig, padding: bool = True,
                 profile: Profile = Profile()):
        super().__init__()
        self.config = config
        self.padding = padding
        self.profile = profile
        latent_dim = config.resolved_latent_dim
        self.encoder = Encoder(
            config.encoder_dim, config.encoder_rates, latent_dim, padding,
            profile.encoder_folded,
            _either(profile.encoder_snake_approx, config.encoder_snake_approx),
            dtype=profile.encoder_compute_dtype,
            packed=_either(profile.encoder_packed, config.encoder_packed))
        if config.model_type == "CBR":
            self.quantizer = ResidualVectorQuantize(
                latent_dim, config.n_codebooks, config.codebook_size,
                config.codebook_dim, quantizer_dropout=config.quantizer_dropout)
        else:
            self.quantizer = self.vbr_quantizer(config, latent_dim)
        self.decoder = Decoder(
            latent_dim, config.decoder_dim, config.decoder_rates,
            padding=padding, folded=profile.decoder_folded,
            snake_approx=_either(profile.decoder_snake_approx,
                                 config.decoder_snake_approx),
            dtype=profile.decoder_compute_dtype,
            packed_blocks=_either(profile.decoder_packed, config.decoder_packed),
            packed_up_blocks=_either(profile.decoder_packed_up,
                                     config.decoder_packed_up))

    @staticmethod
    def vbr_quantizer(config: ModelConfig, latent_dim: int) -> nn.Module:
        """The VBR quantizer: the stages gated by the importance subnet,
        whose input width is the latents' and whose input is the encoder's
        feature, so the two must be equal (the JAX model fails otherwise
        too)."""
        if latent_dim != config.feature_dim:
            raise ValueError(
                f"a VBR DAC_VRVQ's importance subnet takes latent_dim "
                f"({latent_dim}) channels but reads the encoder's feature of "
                f"{config.feature_dim}; set latent_dim to it (or None), or use "
                f"model_type CBR or DAC_MOE")
        return VBRResidualVectorQuantize(
            latent_dim, config.n_codebooks, config.codebook_size,
            config.codebook_dim,
            detach_imp_map_input=config.detach_imp_map_input,
            **gated_kwargs(config))

    # ------------------------------------------------------------ geometry
    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    @property
    def n_codebooks(self) -> int:
        return self.config.n_codebooks

    @property
    def vbr(self) -> bool:
        return self.config.model_type == "VBR"

    @property
    def hop_length(self) -> int:
        return int(np.prod(self.config.encoder_rates))

    @property
    def conv_specs(self) -> List[codec.ConvSpec]:
        return codec.model_conv_specs(self.config.encoder_rates,
                                      self.config.decoder_rates,
                                      self.config.n_codebooks, vbr=self.vbr)

    @property
    def delay(self) -> int:
        """Receptive delay of the padding-free codec."""
        return codec.delay(self.conv_specs)

    def get_output_length(self, input_length: int) -> int:
        return codec.output_length(self.conv_specs, input_length)

    # ------------------------------------------------------------ variants
    def clone(self, padding: bool) -> "DAC_VRVQ":
        """The same codec with ``padding`` set, sharing this one's parameter
        tensors (no copy), its profile and its Snake kernel switches. A
        time-packed codec has no padding-free variant: ``padding=False``
        raises ``ValueError``."""
        return self.with_state(self.state_dict(), padding=padding)

    def with_state(self, state_dict, padding: Optional[bool] = None,
                   profile: Optional[Profile] = None) -> "DAC_VRVQ":
        """A codec of this config on ``state_dict``'s tensors themselves (no
        copy), with ``padding`` and ``profile`` (this one's by default) and
        this one's Snake kernel switches and training mode."""
        with torch.device("meta"):
            twin = type(self)(self.config,
                            padding=self.padding if padding is None else padding,
                            profile=self.profile if profile is None else profile)
        twin.load_state_dict(state_dict, assign=True)
        twin.use_kernels(self.uses_kernels())
        return twin.train(self.training)

    def use_kernels(self, enabled: bool) -> "DAC_VRVQ":
        """Route every Snake on the card through its kernel (the default) or
        through the plain version, for comparisons."""
        for m in self.modules():
            if isinstance(m, Snake1d):
                m.use_kernel = enabled
        return self

    def uses_kernels(self) -> bool:
        return all(m.use_kernel for m in self.modules() if isinstance(m, Snake1d))

    # ---------------------------------------------------------- public API
    def preprocess(self, audio_data: torch.Tensor,
                   sample_rate: Optional[int] = None) -> torch.Tensor:
        """Right-pad (B, 1, T) audio to a multiple of the hop."""
        if sample_rate is None:
            sample_rate = self.sample_rate
        if sample_rate != self.sample_rate:
            raise ValueError(
                f"sample_rate {sample_rate} != model rate {self.sample_rate}"
            )
        length = audio_data.shape[-1]
        right_pad = math.ceil(length / self.hop_length) * self.hop_length - length
        if right_pad:
            audio_data = torch.nn.functional.pad(audio_data, (0, right_pad))
        return audio_data

    def quantize(self, z: torch.Tensor, feat: torch.Tensor,
                 n_quantizers: Optional[int] = None,
                 level: Optional[float] = 1.0, **train_kw) -> dict:
        """The quantizer on the encoder's latents ``z`` and feature ``feat``
        (which only VBR's importance subnet reads); ``train_kw`` are the
        quantizer's train arguments."""
        if not self.vbr:
            if train_kw.pop("levels", None) is not None:
                raise ValueError("a CBR model draws no levels")
            return self.quantizer(z, n_quantizers=n_quantizers, **train_kw)
        return self.quantizer(z, n_quantizers=n_quantizers, feat_enc=feat,
                              level=level, **train_kw)

    def draws(self, batch: int, generator: Optional[torch.Generator],
              device) -> dict:
        """A train forward's random numbers for ``batch`` rows (VBR: levels
        and dropout depths; CBR: dropout depths), to pin them with
        ``forward(..., **draws)``."""
        return self.quantizer.draws(batch, generator, device)

    def encode(self, audio_data: torch.Tensor,
               n_quantizers: Optional[int] = None,
               level: Optional[float] = 1.0) -> dict:
        """audio (B, 1, T) -> the quantizer's dict: z_q (B, D, T'), codes
        (B, Nq, T'), latents; VBR also z_q_is, imp_map (B, 1, T';
        ``DAC_MOE``: B, Nq, T'), mask_imp."""
        z, feat = self.encoder(audio_data, return_feat=True)
        return self.quantize(z, feat, n_quantizers, level)

    def decode(self, z_q: torch.Tensor) -> torch.Tensor:
        """z_q (B, D, T') -> audio (B, 1, T)."""
        return self.decoder(z_q)

    def decode_from_codes(self, codes: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """codes (B, Nq, T') [+ VBR mask (B, Nq, T')] -> audio (B, 1, T)."""
        return self.decoder(self.quantizer.from_codes(codes, mask=mask))

    def forward(self, audio_data: torch.Tensor,
                sample_rate: Optional[int] = None,
                n_quantizers: Optional[int] = None,
                level: Optional[float] = 1.0, train: bool = False,
                generator: Optional[torch.Generator] = None,
                levels: Optional[torch.Tensor] = None,
                depths: Optional[Sequence[int]] = None,
                rows: Optional[Tuple[int, int]] = None) -> dict:
        """preprocess -> encode -> decode, trimmed to the input length.

        ``train=True`` is the training forward (the quantizer's random
        draws from ``generator``, or ``levels``/``depths`` pinned) and adds
        ``vq/commitment_loss`` and ``vq/codebook_loss``; ``imp_map`` then
        holds the importance-masked rows only (None in CBR). ``rows =
        (offset, total)``: the audio is those rows of a train batch of
        ``total``, whose draws and partition the quantizer keeps its part of
        (data parallelism)."""
        length = audio_data.shape[-1]
        audio_data = self.preprocess(audio_data, sample_rate)
        z, feat = self.encoder(audio_data, return_feat=True)
        train_kw = {}
        if train:
            train_kw = dict(train=True, generator=generator, levels=levels,
                            depths=depths, rows=rows)
        q = self.quantize(z, feat, n_quantizers, level, **train_kw)
        audio = self.decoder(q["z_q"])[..., :length]
        out = {
            "audio": audio,
            "z": q["z_q"],
            "codes": q["codes"],
            "latents": q["latents"],
            "imp_map": q["imp_map"],
            "mask_imp": q["mask_imp"],
        }
        if train:
            out["vq/commitment_loss"] = q["commitment_loss"]
            out["vq/codebook_loss"] = q["codebook_loss"]
        return out
