"""DAC_MOE: the codec with a router in place of the importance subnet.

Counterpart of ``vrvq_tpu/models/dac_moe.py``. The skeleton is
``DAC_VRVQ``'s (same encoder, decoder, stages, profiles and public methods;
``clone``, ``with_state``, ``use_kernels``, ``draws`` and the train forward
come from it). In VBR the per-frame scores come from a linear router over
the encoder's feature (whose width is ``feature_dim``, the latents' only by
default), one score per stage, ``imp_map (B, Nq, T)``; scaled
by ``level * Nq`` (train: a drawn level per clip), each stage is kept where
its score reaches 0.5, the first two always (``generate_mask_ste_moe``). The
JAX module's debug ``print`` of the reference is not reproduced. The CBR
variant is ``DAC_VRVQ``'s CBR quantizer.

Such a mask need not keep a prefix of the stages, so per-frame counts (the
``.dac``'s ``vbr_counts``) cannot hold it: a VBR ``compress``, a VBR stream
and a level sweep of a ``DAC_MOE`` raise (``infer/``), and ``encode`` at a
level with ``decode_from_codes(codes, mask)`` is its VBR serving path. The
router is a Linear, not a conv, so the delay walk (``conv_specs``) sees the
codec's convs only, as in the JAX module.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch
from torch import nn

from ..config import ModelConfig
from ..ops.masks import generate_mask_ste_moe
from . import codec
from .dac_vrvq import DAC_VRVQ, gated_kwargs
from .quantize import GatedResidualVectorQuantize


class MOEResidualVectorQuantize(GatedResidualVectorQuantize):
    """The stages gated by a router ``Linear(feature_dim, Nq)`` over the
    encoder's feature (``feature_dim``: ``input_dim`` by default; the JAX
    ``Dense`` takes the feature's width, whatever ``latent_dim`` is).
    ``detach_imp_map_input`` is accepted and unused, as in the JAX module:
    the router's input is never detached."""

    equal_levels_ok = True

    def __init__(self, input_dim: int, n_codebooks: int, codebook_size: int,
                 codebook_dim: Union[int, Sequence[int]],
                 detach_imp_map_input: bool = False,
                 feature_dim: Optional[int] = None, **gated):
        super().__init__(input_dim, n_codebooks, codebook_size, codebook_dim,
                         **gated)
        del detach_imp_map_input
        self.router = nn.Linear(feature_dim or input_dim, n_codebooks)

    def importance(self, feat_enc: torch.Tensor, frames: int) -> torch.Tensor:
        """The router's scores (B, Nq, frames) of ``feat_enc (B, D, T)``."""
        scores = self.router(feat_enc.transpose(1, 2)).transpose(1, 2)
        return self.crop(scores, frames)

    def gate(self, scaled: torch.Tensor) -> torch.Tensor:
        return generate_mask_ste_moe(scaled, self.n_codebooks,
                                     alpha=self.imp2mask_alpha)


class DAC_MOE(DAC_VRVQ):
    """The router-gated codec. Built from a ``ModelConfig`` as ``DAC_VRVQ``
    is; its state dict is ``DAC_VRVQ``'s with ``quantizer.router.{weight,
    bias}`` in place of ``quantizer.imp_subnet.*``."""

    prefix_mask = False

    @staticmethod
    def vbr_quantizer(config: ModelConfig, latent_dim: int) -> nn.Module:
        return MOEResidualVectorQuantize(
            latent_dim, config.n_codebooks, config.codebook_size,
            config.codebook_dim,
            detach_imp_map_input=config.detach_imp_map_input,
            feature_dim=config.feature_dim, **gated_kwargs(config))

    @property
    def conv_specs(self) -> List[codec.ConvSpec]:
        return codec.model_conv_specs(self.config.encoder_rates,
                                      self.config.decoder_rates,
                                      self.config.n_codebooks, vbr=False)
