"""Training losses (counterpart of ``vrvq_tpu/losses``)."""

from .framewise import (L1LossFramewise, MelSpectrogramLossFramewise,
                        SISDRLossFramewise)
from .gan import GANLoss, discriminator_loss, generator_loss
from .recon import (L1Loss, L2Loss, MelSpectrogramLoss, MultiScaleSTFTLoss,
                    SISDRLoss)

__all__ = [
    "GANLoss", "L1Loss", "L1LossFramewise", "L2Loss", "MelSpectrogramLoss",
    "MelSpectrogramLossFramewise", "MultiScaleSTFTLoss", "SISDRLoss",
    "SISDRLossFramewise", "discriminator_loss", "generator_loss",
]
