"""The GAN train step and the validation step.

Counterpart of ``vrvq_tpu/train/loop.py`` (``make_train_step``,
``make_val_step``), in the JAX order:

  1. one train-mode generator forward (levels and dropout depths from the
     step's ``torch.Generator``, or pinned);
  2. the discriminator update on the detached reconstruction (clip 10);
  3. the generator losses against the UPDATED discriminator: multi-scale
     mel and STFT, waveform L1, LSGAN adversarial and feature matching, the
     quantizer's commitment and codebook losses, rate = mean(imp_map),
     weighted by ``lambdas``;
  4. the generator update (clip 1e3).

The one forward's graph serves both phases: the generator's parameters do
not change between them, so it is the value the JAX package's pair of
(CSE'd) forwards computes. The generator's backward is restricted to its own
parameters, so the discriminator's gradients are those of phase 2. The
split and accumulated steps and rematerialization are not ported.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence

import torch

from ..losses.gan import discriminator_loss, generator_loss
from .state import TrainState


def make_train_step(lambdas: Mapping[str, float], stft_loss, mel_loss,
                    waveform_loss) -> Callable:
    """``train_step(state, audio, generator=None, levels=None, depths=None)
    -> metrics``: one update of both networks from ``audio (B, 1, T)``
    (already transformed). Metrics are detached 0-d tensors, sorted by
    name; ``state.step`` advances by one."""

    def train_step(state: TrainState, audio: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   levels: Optional[torch.Tensor] = None,
                   depths: Optional[Sequence[int]] = None) -> Dict[str, torch.Tensor]:
        gen, disc = state.generator, state.discriminator
        out: Dict[str, torch.Tensor] = {}

        # 1. the generator forward
        g_out = gen(audio, train=True, generator=generator, levels=levels,
                    depths=depths)
        recons = g_out["audio"]

        # 2. the discriminator update
        d_loss = discriminator_loss(disc(recons.detach()), disc(audio))
        state.opt_d.zero_grad()
        d_loss.backward()
        out["other/grad_norm_d"] = state.opt_d.step()
        out["adv/disc_loss"] = d_loss

        # 3. the generator losses against the updated discriminator
        losses = {
            "stft/loss": stft_loss(recons, audio),
            "mel/loss": mel_loss(recons, audio),
            "waveform/loss": waveform_loss(recons, audio),
        }
        adv_g, adv_feat = generator_loss(disc(recons), disc(audio))
        losses["adv/gen_loss"] = adv_g
        losses["adv/feat_loss"] = adv_feat
        losses["vq/commitment_loss"] = g_out["vq/commitment_loss"]
        losses["vq/codebook_loss"] = g_out["vq/codebook_loss"]
        if g_out["imp_map"] is not None:
            losses["vq/rate_loss"] = torch.mean(g_out["imp_map"])
        total = sum(weight * losses[key] for key, weight in lambdas.items()
                    if key in losses)
        losses["loss"] = total

        # 4. the generator update
        state.opt_g.zero_grad()
        total.backward(inputs=state.opt_g.params)
        out["other/grad_norm_g"] = state.opt_g.step()
        out.update(losses)
        state.step += 1
        out["other/batch_size"] = torch.tensor(float(audio.shape[0]))
        return {k: torch.as_tensor(v).detach() for k, v in sorted(out.items())}

    return train_step


def make_val_step(stft_loss, mel_loss, waveform_loss) -> Callable:
    """``val_step(generator, audio) -> metrics``: the eval forward at level
    1.0 and its losses (``loss`` is the mel loss)."""

    @torch.no_grad()
    def val_step(generator: torch.nn.Module, audio: torch.Tensor):
        out = generator(audio, level=1.0)
        recons = out["audio"]
        mel = mel_loss(recons, audio)
        result = {
            "loss": mel,
            "mel/loss": mel,
            "stft/loss": stft_loss(recons, audio),
            "waveform/loss": waveform_loss(recons, audio),
        }
        if out["imp_map"] is not None:
            result["vq/rate_loss"] = torch.mean(out["imp_map"])
        return result

    return val_step
