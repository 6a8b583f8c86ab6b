"""Model configurations, as frozen dataclasses (no YAML).

``FLAGSHIP`` is the repo's flagship ``DAC_VRVQ``: the values of
``conf/base.yml`` (model and quantization) and ``conf/vrvq/vrvq_a2.yml`` (the
VBR keys), 81.56M parameters with 8 codebooks of 1024 x 8.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    sample_rate: int = 44100
    encoder_dim: int = 64
    encoder_rates: Tuple[int, ...] = (2, 4, 8, 8)
    decoder_dim: int = 1536
    decoder_rates: Tuple[int, ...] = (8, 8, 4, 2)
    n_codebooks: int = 8
    codebook_size: int = 1024
    codebook_dim: int = 8
    model_type: str = "VBR"
    level_min: float = 0.125
    level_max: float = 6.0
    imp2mask_alpha: float = 2.0

    @property
    def latent_dim(self) -> int:
        """The encoder's output width: it doubles at every stride."""
        return self.encoder_dim * (2 ** len(self.encoder_rates))


FLAGSHIP = ModelConfig()


def small_config(**overrides) -> ModelConfig:
    """The flagship's topology at test widths (encoder 16, decoder 128,
    4 codebooks of 64 x 4), with any field overridden."""
    base = ModelConfig(encoder_dim=16, decoder_dim=128, n_codebooks=4,
                       codebook_size=64, codebook_dim=4)
    return dataclasses.replace(base, **overrides)
