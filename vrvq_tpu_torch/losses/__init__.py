"""Training losses (counterpart of ``vrvq_tpu/losses``)."""

from .gan import GANLoss, discriminator_loss, generator_loss
from .recon import (L1Loss, L2Loss, MelSpectrogramLoss, MultiScaleSTFTLoss,
                    SISDRLoss)

__all__ = [
    "GANLoss", "L1Loss", "L2Loss", "MelSpectrogramLoss", "MultiScaleSTFTLoss",
    "SISDRLoss", "discriminator_loss", "generator_loss",
]
