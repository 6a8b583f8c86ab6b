"""LSGAN adversarial and feature-matching losses.

Counterpart of ``vrvq_tpu/losses/gan.py``. Feature maps are the
discriminator's output: one list per sub-discriminator, its last entry the
logit map.
"""

from __future__ import annotations

from typing import List

import torch

FeatureMaps = List[List[torch.Tensor]]


def discriminator_loss(fmaps_fake: FeatureMaps,
                       fmaps_real: FeatureMaps) -> torch.Tensor:
    """``mean(fake^2) + mean((1 - real)^2)`` over each sub-discriminator's
    logits. The caller detaches the fake audio."""
    loss_d = 0.0
    for f, r in zip(fmaps_fake, fmaps_real):
        loss_d = loss_d + torch.mean(torch.square(f[-1]))
        loss_d = loss_d + torch.mean(torch.square(1.0 - r[-1]))
    return loss_d


def generator_loss(fmaps_fake: FeatureMaps, fmaps_real: FeatureMaps):
    """``(sum mean((1 - fake)^2), sum mean|fake - real|)``: the LSGAN
    generator loss and L1 feature matching over every map but the logits,
    the real maps detached."""
    loss_g = 0.0
    for f in fmaps_fake:
        loss_g = loss_g + torch.mean(torch.square(1.0 - f[-1]))
    loss_feature = 0.0
    for f, r in zip(fmaps_fake, fmaps_real):
        for j in range(len(f) - 1):
            loss_feature = loss_feature + torch.mean(
                torch.abs(f[j] - r[j].detach()))
    return loss_g, loss_feature


class GANLoss:
    """Both losses on audio ``(B, 1, T)`` through a discriminator module."""

    def __init__(self, discriminator: torch.nn.Module):
        self.discriminator = discriminator

    def forward(self, fake: torch.Tensor, real: torch.Tensor):
        return self.discriminator(fake), self.discriminator(real)

    def discriminator_loss(self, fake: torch.Tensor,
                           real: torch.Tensor) -> torch.Tensor:
        return discriminator_loss(self.discriminator(fake.detach()),
                                  self.discriminator(real))

    def generator_loss(self, fake: torch.Tensor, real: torch.Tensor):
        return generator_loss(*self.forward(fake, real))
