"""DAC_VRVQ: the flagship variable-bitrate codec, Encoder -> VBR RVQ -> Decoder.

Counterpart of ``vrvq_tpu/models/dac_vrvq.py`` in eval mode, in (B, C, T):
audio ``(B, 1, T)``, latents ``(B, D, T')``, codes ``(B, Nq, T')``.
``padding=False`` builds the padding-free codec that chunked compression
runs; ``clone(padding=...)`` gives the other variant on the same parameters.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig
from ..nn.layers import DecoderBlock, EncoderBlock, Snake1d, WNConv1d
from . import codec
from .quantize import VBRResidualVectorQuantize


class Encoder(nn.Module):
    """k=7 in conv -> EncoderBlocks (width doubles at each stride) -> Snake ->
    k=3 out conv. (B, 1, T) -> (B, latent_dim, T')."""

    def __init__(self, d_model: int, strides: Sequence[int], latent_dim: int,
                 padding: bool = True):
        super().__init__()
        pad_mode = "zeros" if padding else "none"
        self.in_conv = WNConv1d(1, d_model, 7, padding=3, pad_mode=pad_mode)
        self.n_blocks = len(strides)
        d = d_model
        for i, stride in enumerate(strides):
            d *= 2
            self.add_module(f"block_{i}", EncoderBlock(d, stride, padding))
        self.snake = Snake1d(d)
        self.out_conv = WNConv1d(d, latent_dim, 3, padding=1, pad_mode=pad_mode)

    def forward(self, x: torch.Tensor, return_feat: bool = False):
        """With ``return_feat`` also the activation after the last block,
        which feeds the importance subnet."""
        x = self.in_conv(x)
        for i in range(self.n_blocks):
            x = getattr(self, f"block_{i}")(x)
        feat = x
        x = self.out_conv(self.snake(x))
        if return_feat:
            return x, feat
        return x


class Decoder(nn.Module):
    """k=7 in conv -> DecoderBlocks (width halves at each rate) -> Snake ->
    k=7 out conv -> tanh. (B, latent, T') -> (B, 1, T)."""

    def __init__(self, input_channel: int, channels: int, rates: Sequence[int],
                 d_out: int = 1, padding: bool = True):
        super().__init__()
        pad_mode = "zeros" if padding else "none"
        self.in_conv = WNConv1d(input_channel, channels, 7, padding=3,
                                pad_mode=pad_mode)
        self.n_blocks = len(rates)
        output_dim = channels
        for i, stride in enumerate(rates):
            input_dim = channels // (2 ** i)
            output_dim = channels // (2 ** (i + 1))
            self.add_module(f"block_{i}",
                            DecoderBlock(input_dim, output_dim, stride, padding))
        self.snake = Snake1d(output_dim)
        self.out_conv = WNConv1d(output_dim, d_out, 7, padding=3,
                                 pad_mode=pad_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.in_conv(x)
        for i in range(self.n_blocks):
            x = getattr(self, f"block_{i}")(x)
        return torch.tanh(self.out_conv(self.snake(x)))


class DAC_VRVQ(nn.Module):
    """The VBR codec. Parameters are left uninitialized: load them
    (``convert.state_dict_from_jax``) or draw them (``convert.init_params``)."""

    def __init__(self, config: ModelConfig, padding: bool = True):
        super().__init__()
        if config.model_type != "VBR":
            raise NotImplementedError(
                "only model_type='VBR' is ported; the CBR-only quantizer "
                "(ResidualVectorQuantize) waits for a later slice"
            )
        self.config = config
        self.padding = padding
        latent_dim = config.latent_dim
        self.encoder = Encoder(config.encoder_dim, config.encoder_rates,
                               latent_dim, padding)
        self.quantizer = VBRResidualVectorQuantize(
            latent_dim, config.n_codebooks, config.codebook_size,
            config.codebook_dim, imp2mask_alpha=config.imp2mask_alpha,
        )
        self.decoder = Decoder(latent_dim, config.decoder_dim,
                               config.decoder_rates, padding=padding)

    # ------------------------------------------------------------ geometry
    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    @property
    def n_codebooks(self) -> int:
        return self.config.n_codebooks

    @property
    def hop_length(self) -> int:
        return int(np.prod(self.config.encoder_rates))

    @property
    def conv_specs(self) -> List[codec.ConvSpec]:
        return codec.model_conv_specs(self.config.encoder_rates,
                                      self.config.decoder_rates,
                                      self.config.n_codebooks, vbr=True)

    @property
    def delay(self) -> int:
        """Receptive delay of the padding-free codec."""
        return codec.delay(self.conv_specs)

    def get_output_length(self, input_length: int) -> int:
        return codec.output_length(self.conv_specs, input_length)

    # ------------------------------------------------------------ variants
    def clone(self, padding: bool) -> "DAC_VRVQ":
        """The same codec with ``padding`` set, sharing this one's parameter
        tensors (no copy) and its Snake kernel switches."""
        with torch.device("meta"):
            twin = DAC_VRVQ(self.config, padding=padding)
        twin.load_state_dict(self.state_dict(), assign=True)
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

    def encode(self, audio_data: torch.Tensor,
               n_quantizers: Optional[int] = None,
               level: Optional[float] = 1.0) -> dict:
        """audio (B, 1, T) -> the quantizer's dict: z_q (B, D, T'), z_q_is,
        codes (B, Nq, T'), latents, imp_map (B, 1, T'), mask_imp."""
        z, feat = self.encoder(audio_data, return_feat=True)
        return self.quantizer(z, n_quantizers=n_quantizers, feat_enc=feat,
                              level=level)

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
                level: Optional[float] = 1.0) -> dict:
        """preprocess -> encode -> decode, trimmed to the input length."""
        length = audio_data.shape[-1]
        audio_data = self.preprocess(audio_data, sample_rate)
        q = self.encode(audio_data, n_quantizers, level)
        audio = self.decoder(q["z_q"])[..., :length]
        return {
            "audio": audio,
            "z": q["z_q"],
            "codes": q["codes"],
            "latents": q["latents"],
            "imp_map": q["imp_map"],
            "mask_imp": q["mask_imp"],
        }
