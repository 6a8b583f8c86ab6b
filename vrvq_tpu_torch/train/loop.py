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

``remat`` (``jax.checkpoint`` of the generator's forward in JAX) runs the
generator's train forward under ``torch.utils.checkpoint`` (non-reentrant):
its activations are dropped after the forward and recomputed in the
backward. The step draws the levels and depths first and passes them in
pinned, so the recompute sees the same draws (the checkpoint restores the
global RNG, not a ``torch.Generator``).

Both steps run in ``deterministic_cudnn()`` (cuDNN's deterministic
algorithms, not timed), and every op of the step sums in a fixed order
(``ops/stft.reflect_pad``, ``overlap_add``; CUDA's reflection-pad backward
and ``index_add_`` add with atomics): a step is a function of the state,
the batch and the draws, as the JAX step is, so a step run twice, or a run
resumed, gives the same bits, on the card as on the CPU.

Spans (``utils.annotate``): the step is ``train.step``; one batch's
children are ``train.forward``, ``train.disc`` (the discriminator's
forwards, loss, backward, all-reduce and update), ``train.gen_losses``,
``train.gen_backward`` and ``train.gen_update`` (the all-reduce and the
update); each update's clip waits for the gradients' norm in a
``clip_sync`` span (``train/state.py``). With micro-batches the
discriminator phase's forwards lie in ``train.disc`` and each micro-batch's
generator forward in its ``train.gen_losses``, so the discriminator phase
is ``train.forward`` + ``train.disc`` and the generator phase the other
three either way.

Data parallelism: in a process group (``parallel``) ``audio`` holds this
rank's rows of the global batch (``parallel.local_rows``); the draws are the
global batch's, from the step's generator or pinned, and each rank keeps
its rows (the forward's ``rows``). The rate loss is the global batch's mean
of the importance map written as this rank's share, so that the ranks'
losses average to the global batch's, as every other loss (a mean over
equal rows) does by itself. Each phase's gradients are averaged over the
ranks (``all_reduce_mean_``, once after the K micro-batches) before its
clip and update, and the reported losses are the ranks' means: every rank
takes and reports the single-card step of the global batch.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Mapping, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .. import deterministic_cudnn
from ..losses.gan import discriminator_loss, generator_loss
from ..parallel import dist as pdist
from ..utils import annotate
from .state import TrainState

# metrics that are the same on every rank without an average
GLOBAL_METRICS = ("other/grad_norm_d", "other/grad_norm_g", "other/batch_size")


def make_train_step(lambdas: Mapping[str, float], stft_loss, mel_loss,
                    waveform_loss, accum_steps: int = 1,
                    remat: bool = False) -> Callable:
    """``train_step(state, audio, generator=None, levels=None, depths=None)
    -> metrics``: one update of both networks from ``audio (B, 1, T)``
    (already transformed; in a process group this rank's rows of the global
    batch), over ``accum_steps`` micro-batches. ``levels`` and ``depths``
    pin the quantizer's draws for the global batch (with micro-batches: a
    list of each micro-batch's). ``remat`` recomputes the generator's
    forward in its backward. Metrics are detached 0-d tensors, sorted by
    name; ``state.step`` advances by one."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def forward(gen, audio, draws):
        """The generator's train forward on pinned ``draws``."""
        run = functools.partial(gen, train=True, **draws)
        if remat and torch.is_grad_enabled():
            return checkpoint(run, audio, use_reentrant=False)
        return run(audio)

    def rate_loss(gen, imp_map, total):
        """The global batch's mean importance as this rank's share of it."""
        if pdist.world() == 1:
            return torch.mean(imp_map)
        n_imps = gen.quantizer.partition(total)[0]
        return imp_map.sum() * (pdist.world() / (n_imps * imp_map.shape[1:].numel()))

    def g_losses(gen, disc, g_out, recons, audio, total):
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
            losses["vq/rate_loss"] = rate_loss(gen, g_out["imp_map"], total)
        losses["loss"] = sum(weight * losses[key] for key, weight in lambdas.items()
                             if key in losses)
        return losses

    def one_batch(state: TrainState, audio, draws, total) -> Dict[str, torch.Tensor]:
        gen, disc = state.generator, state.discriminator
        out: Dict[str, torch.Tensor] = {}

        # 1. the generator forward
        with annotate("train.forward"):
            g_out = forward(gen, audio, draws)
            recons = g_out["audio"]

        # 2. the discriminator update
        with annotate("train.disc"):
            d_loss = discriminator_loss(disc(recons.detach()), disc(audio))
            state.opt_d.zero_grad()
            d_loss.backward()
            pdist.all_reduce_mean_(state.opt_d.params)
            out["other/grad_norm_d"] = state.opt_d.step()
            out["adv/disc_loss"] = d_loss

        # 3. the generator losses against the updated discriminator
        with annotate("train.gen_losses"):
            losses = g_losses(gen, disc, g_out, recons, audio, total)

        # 4. the generator update
        with annotate("train.gen_backward"):
            state.opt_g.zero_grad()
            losses["loss"].backward(inputs=state.opt_g.params)
        with annotate("train.gen_update"):
            pdist.all_reduce_mean_(state.opt_g.params)
            out["other/grad_norm_g"] = state.opt_g.step()
        out.update(losses)
        return out

    def accumulated(state: TrainState, audio, draws, total) -> Dict[str, torch.Tensor]:
        gen, disc = state.generator, state.discriminator
        micro = audio.chunk(accum_steps)

        # the discriminator phase: the mean gradient over the micro-batches
        with annotate("train.disc"):
            state.opt_d.zero_grad()
            d_losses = []
            for audio_i, draws_i in zip(micro, draws):
                with torch.no_grad():
                    recons = forward(gen, audio_i, draws_i)["audio"]
                d_loss = discriminator_loss(disc(recons), disc(audio_i))
                d_loss.backward()
                d_losses.append(d_loss.detach())
            _mean_grads(state.opt_d.params, accum_steps)
            pdist.all_reduce_mean_(state.opt_d.params)
            out = {"other/grad_norm_d": state.opt_d.step(),
                   "adv/disc_loss": torch.stack(d_losses).mean()}

        # the generator phase, against the updated discriminator
        state.opt_g.zero_grad()
        g_sums: Dict[str, torch.Tensor] = {}
        for audio_i, draws_i in zip(micro, draws):
            with annotate("train.gen_losses"):
                g_out = forward(gen, audio_i, draws_i)
                losses = g_losses(gen, disc, g_out, g_out["audio"], audio_i, total)
            with annotate("train.gen_backward"):
                losses["loss"].backward(inputs=state.opt_g.params)
            for key, value in losses.items():
                g_sums[key] = g_sums.get(key, 0.0) + value.detach()
        with annotate("train.gen_update"):
            _mean_grads(state.opt_g.params, accum_steps)
            pdist.all_reduce_mean_(state.opt_g.params)
            out["other/grad_norm_g"] = state.opt_g.step()
        out.update({key: value / accum_steps for key, value in g_sums.items()})
        return out

    def draws_of(state, micro_total, generator, device, levels, depths):
        """One micro-batch's draws for all ``micro_total`` rows of it: from
        ``generator`` (levels, then depths, as the forward draws them), with
        any of them pinned."""
        if levels is None or depths is None:
            drawn = state.generator.draws(micro_total, generator, device)
            levels = drawn.get("levels") if levels is None else levels
            depths = drawn["depths"] if depths is None else depths
        return dict(levels=levels, depths=depths)

    @deterministic_cudnn()
    def train_step(state: TrainState, audio: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   levels=None, depths=None) -> Dict[str, torch.Tensor]:
        world, rank = pdist.world(), pdist.rank()
        local = audio.shape[0]
        if local % accum_steps:
            raise ValueError(f"batch {local * world} is not divisible by "
                             f"grad_accum_steps={accum_steps} x {world} ranks")
        with annotate("train.step"):
            total = local * world // accum_steps  # rows of a global micro-batch
            rows = (rank * (local // accum_steps), total)
            if accum_steps == 1:
                draws = draws_of(state, total, generator, audio.device, levels, depths)
                out = one_batch(state, audio, {**draws, "rows": rows}, total)
            else:
                draws = [{**draws_of(state, total, generator, audio.device, lv, dp),
                          "rows": rows} for lv, dp in zip(
                    levels or [None] * accum_steps, depths or [None] * accum_steps)]
                out = accumulated(state, audio, draws, total)
            state.step += 1
            out = {k: torch.as_tensor(v).detach() for k, v in out.items()}
            averaged = sorted(k for k in out if k not in GLOBAL_METRICS)
            if world > 1:
                means = pdist.mean_over_ranks(torch.stack([out[k].float() for k in averaged]))
                out.update(zip(averaged, means))
            out["other/batch_size"] = torch.tensor(float(local * world))
            return dict(sorted(out.items()))

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
    @deterministic_cudnn()
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
