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
parameters, so the discriminator's gradients are those of phase 2.

With ``accum_steps`` K > 1 (``grad_accum_steps``, ``make_accum_train_step``
in JAX) the batch splits into K micro-batches of consecutive rows, each with
its own draws: one discriminator update from the mean of the K
discriminator gradients, then one generator update from the mean of the K
generator gradients against the updated discriminator; the losses are the
micro-batches' means. Every micro-batch runs the generator's forward in
each phase (detached in the first) and frees its graph before the next, so
peak memory is a micro-batch's, not the batch's.

``split_train_step`` (JAX's ``make_split_train_steps``) runs the same update
as two jitted programs, to halve a compile's peak memory. Eager PyTorch
compiles nothing, so the port has no second path for it: it is this step.
Rematerialization (``remat``) is not ported.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import torch

from ..losses.gan import discriminator_loss, generator_loss
from .state import TrainState


def make_train_step(lambdas: Mapping[str, float], stft_loss, mel_loss,
                    waveform_loss, accum_steps: int = 1) -> Callable:
    """``train_step(state, audio, generator=None, levels=None, depths=None)
    -> metrics``: one update of both networks from ``audio (B, 1, T)``
    (already transformed), over ``accum_steps`` micro-batches. ``levels``
    and ``depths`` pin the quantizer's draws (with micro-batches: a list of
    each micro-batch's). Metrics are detached 0-d tensors, sorted by name;
    ``state.step`` advances by one."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def g_losses(disc, g_out, recons, audio):
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
        losses["loss"] = sum(weight * losses[key] for key, weight in lambdas.items()
                             if key in losses)
        return losses

    def one_batch(state: TrainState, audio, draws) -> Dict[str, torch.Tensor]:
        gen, disc = state.generator, state.discriminator
        out: Dict[str, torch.Tensor] = {}

        # 1. the generator forward
        g_out = gen(audio, train=True, **draws)
        recons = g_out["audio"]

        # 2. the discriminator update
        d_loss = discriminator_loss(disc(recons.detach()), disc(audio))
        state.opt_d.zero_grad()
        d_loss.backward()
        out["other/grad_norm_d"] = state.opt_d.step()
        out["adv/disc_loss"] = d_loss

        # 3. the generator losses against the updated discriminator
        losses = g_losses(disc, g_out, recons, audio)

        # 4. the generator update
        state.opt_g.zero_grad()
        losses["loss"].backward(inputs=state.opt_g.params)
        out["other/grad_norm_g"] = state.opt_g.step()
        out.update(losses)
        return out

    def accumulated(state: TrainState, audio, draws) -> Dict[str, torch.Tensor]:
        gen, disc = state.generator, state.discriminator
        micro = audio.chunk(accum_steps)

        # the discriminator phase: the mean gradient over the micro-batches
        state.opt_d.zero_grad()
        d_losses = []
        for audio_i, draws_i in zip(micro, draws):
            with torch.no_grad():
                recons = gen(audio_i, train=True, **draws_i)["audio"]
            d_loss = discriminator_loss(disc(recons), disc(audio_i))
            d_loss.backward()
            d_losses.append(d_loss.detach())
        _mean_grads(state.opt_d.params, accum_steps)
        out = {"other/grad_norm_d": state.opt_d.step(),
               "adv/disc_loss": torch.stack(d_losses).mean()}

        # the generator phase, against the updated discriminator
        state.opt_g.zero_grad()
        g_sums: Dict[str, torch.Tensor] = {}
        for audio_i, draws_i in zip(micro, draws):
            g_out = gen(audio_i, train=True, **draws_i)
            losses = g_losses(disc, g_out, g_out["audio"], audio_i)
            losses["loss"].backward(inputs=state.opt_g.params)
            for key, value in losses.items():
                g_sums[key] = g_sums.get(key, 0.0) + value.detach()
        _mean_grads(state.opt_g.params, accum_steps)
        out["other/grad_norm_g"] = state.opt_g.step()
        out.update({key: value / accum_steps for key, value in g_sums.items()})
        return out

    def train_step(state: TrainState, audio: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   levels=None, depths=None) -> Dict[str, torch.Tensor]:
        batch = audio.shape[0]
        if accum_steps == 1:
            out = one_batch(state, audio, dict(generator=generator,
                                               levels=levels, depths=depths))
        else:
            if batch % accum_steps:
                raise ValueError(f"batch {batch} is not divisible by "
                                 f"grad_accum_steps={accum_steps}")
            if levels is None and depths is None:
                draws = [state.generator.draws(batch // accum_steps, generator,
                                               audio.device)
                         for _ in range(accum_steps)]
            else:
                draws = [dict(levels=lv, depths=dp) for lv, dp in zip(
                    levels or [None] * accum_steps, depths or [None] * accum_steps)]
            out = accumulated(state, audio, draws)
        state.step += 1
        out["other/batch_size"] = torch.tensor(float(batch))
        return {k: torch.as_tensor(v).detach() for k, v in sorted(out.items())}

    return train_step


def _mean_grads(params, n: int) -> None:
    """The parameters' gradients, summed over ``n`` backward passes, divided
    by ``n`` in place (JAX sums the micro-gradients, then divides)."""
    grads = [p.grad for p in params if p.grad is not None]
    if grads:
        torch._foreach_div_(grads, float(n))


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
