"""Model configurations, as frozen dataclasses (no YAML).

``FLAGSHIP`` is the repo's flagship ``DAC_VRVQ``: the values of
``conf/base.yml`` (model and quantization) and ``conf/vrvq/vrvq_a2.yml`` (the
VBR keys), 81.56M parameters with 8 codebooks of 1024 x 8. ``FLAGSHIP_TRAIN``
is its training configuration as a plain dict with the merged YAML's keys;
``model_config`` reads a ``ModelConfig`` out of such a dict.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Mapping, Tuple


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
    level_dist: str = "uniform"
    imp2mask_alpha: float = 2.0
    # the train-mode batch partition (vrvq_a2.yml: 0.25 full-codebook rows,
    # no random-depth rows)
    full_codebook_rate: float = 0.25
    quantizer_dropout: float = 0.0

    @property
    def latent_dim(self) -> int:
        """The encoder's output width: it doubles at every stride."""
        return self.encoder_dim * (2 ** len(self.encoder_rates))


FLAGSHIP = ModelConfig()


def model_config(cfg: Mapping) -> ModelConfig:
    """The ``ModelConfig`` of a training dict's ``DAC_VRVQ.*`` keys (a key
    that ``ModelConfig`` lacks raises)."""
    kw = {k[len("DAC_VRVQ."):]: v for k, v in cfg.items()
          if k.startswith("DAC_VRVQ.")}
    for key in ("encoder_rates", "decoder_rates"):
        if key in kw:
            kw[key] = tuple(kw[key])
    return ModelConfig(**kw)


def small_config(**overrides) -> ModelConfig:
    """The flagship's topology at test widths (encoder 16, decoder 128,
    4 codebooks of 64 x 4), with any field overridden."""
    base = ModelConfig(encoder_dim=16, decoder_dim=128, n_codebooks=4,
                       codebook_size=64, codebook_dim=4)
    return dataclasses.replace(base, **overrides)


# The flagship's training configuration as the merged YAML gives it (keys
# unchanged, scopes as ``scope/Key.field``): conf/vrvq/vrvq_a2.yml includes
# conf/base.yml, conf/training.yml and conf/dataset.yml in that order, and
# each later file wins. No YAML is read: the port has no YAML loader yet.
FLAGSHIP_TRAIN = {
    # conf/base.yml:2-12, with conf/vrvq/vrvq_a2.yml:13-18 over it
    "DAC_VRVQ.sample_rate": 44100,
    "DAC_VRVQ.encoder_dim": 64,
    "DAC_VRVQ.encoder_rates": [2, 4, 8, 8],
    "DAC_VRVQ.decoder_dim": 1536,
    "DAC_VRVQ.decoder_rates": [8, 8, 4, 2],
    "DAC_VRVQ.n_codebooks": 8,
    "DAC_VRVQ.codebook_size": 1024,
    "DAC_VRVQ.codebook_dim": 8,
    "DAC_VRVQ.model_type": "VBR",
    "DAC_VRVQ.full_codebook_rate": 0.25,
    "DAC_VRVQ.quantizer_dropout": 0.0,
    "DAC_VRVQ.level_min": 0.125,
    "DAC_VRVQ.level_max": 6.0,
    "DAC_VRVQ.imp2mask_alpha": 2.0,
    # conf/base.yml:15-24
    "Discriminator.sample_rate": 44100,
    "Discriminator.rates": [],
    "Discriminator.periods": [2, 3, 5, 7, 11],
    "Discriminator.fft_sizes": [2048, 1024, 512],
    "Discriminator.bands": [[0.0, 0.1], [0.1, 0.25], [0.25, 0.5],
                            [0.5, 0.75], [0.75, 1.0]],
    # conf/training.yml:11-13 (as conf/base.yml:27-29)
    "AdamW.betas": [0.8, 0.99],
    "AdamW.lr": 0.0001,
    "ExponentialLR.gamma": 0.999996,
    # conf/training.yml:15-21, conf/vrvq/vrvq_a2.yml:11,27-29
    "amp": False,
    "resume": False,
    "batch_size": 64,
    "val_batch_size": 64,
    "num_workers": 8,
    "grad_accum_steps": 1,
    "num_iters": 300000,
    "save_iters": [],
    "valid_freq": 10000,
    "sample_freq": 10000,
    "val_idx": [0, 1, 2, 3, 4, 5, 6, 7],
    "seed": 0,
    # conf/vrvq/vrvq_a2.yml:20-26
    "lambdas": {
        "mel/loss": 15.0,
        "adv/feat_loss": 2.0,
        "adv/gen_loss": 1.0,
        "vq/commitment_loss": 0.25,
        "vq/codebook_loss": 1.0,
        "vq/rate_loss": 2.0,
    },
    # conf/base.yml:48-56
    "build_transform.preprocess": ["Identity"],
    "build_transform.augment_prob": 0.0,
    "build_transform.augment": ["Identity"],
    "build_transform.postprocess": ["RescaleAudio", "ShiftPhase"],
    # conf/base.yml:58-65
    "MultiScaleSTFTLoss.window_lengths": [2048, 512],
    "MelSpectrogramLoss.n_mels": [5, 10, 20, 40, 80, 160, 320],
    "MelSpectrogramLoss.window_lengths": [32, 64, 128, 256, 512, 1024, 2048],
    "MelSpectrogramLoss.mel_fmin": [0, 0, 0, 0, 0, 0, 0],
    "MelSpectrogramLoss.mel_fmax": [None] * 7,
    "MelSpectrogramLoss.pow": 1.0,
    "MelSpectrogramLoss.clamp_eps": 1.0e-5,
    "MelSpectrogramLoss.mag_weight": 0.0,
    # conf/dataset.yml:3-24
    "train/AudioDataset.duration": 0.38,
    "train/AudioDataset.n_examples": 10000000,
    "val/AudioDataset.duration": 5.0,
    "val/build_transform.augment_prob": 1.0,
    "val/AudioDataset.n_examples": 64,
    "test/AudioDataset.duration": 10.0,
    "test/build_transform.augment_prob": 1.0,
    "test/AudioDataset.n_examples": 100,
    "AudioLoader.shuffle": True,
    "AudioDataset.without_replacement": True,
    "train/build_dataset.folders": {"music": ["data/train"]},
    "val/build_dataset.folders": {"music": ["data/val"]},
    "test/build_dataset.folders": {"music": ["data/test"]},
}
