"""Fast-inference profiles: folded weight norm, a bfloat16 decoder, the
polynomial Snake, and the gate that decides whether the turbo profile may
serve.

Counterpart of ``vrvq_tpu/infer/fast.py``, with the same defaults:

  * ``make_inference_model`` (the exact-codes fast profile): weight norm
    folded out of the decoder (``nn/fold.py``), the decoder in bfloat16 and
    its Snake polynomial. The encoder and the quantizer stay live float32,
    so codes equal the live model's. In eager PyTorch the folded float32
    kernel is the tensor the live conv builds on every call, so folding the
    encoder too (``fold_encoder=True``) leaves codes and audio bit-identical
    as well (the JAX fold perturbs TPU codes through XLA's fusion; eager
    PyTorch has none).
  * ``make_serving_model`` (turbo): the fast profile plus the polynomial
    Snake in the encoder, which moves latents by float32 rounding, so near
    ties may flip. Serve it only behind ``turbo_gate`` on your checkpoint
    and audio. With ``encode_packed=True`` (the JAX package's serving
    headline, turbo + packed encoder) the encoder's first stage runs in the
    time-packed layout (``nn/layers.py``): the same sums in another order,
    so latents move by float32 rounding too; gate it with
    ``turbo_gate(model, encode_packed=True)``.
  * ``decode_packed`` / ``decode_packed_up``: the decoder's last blocks and
    tail, or only those blocks' transposed convs, time-packed. Codes are
    untouched; the decode moves by rounding.

  * ``make_inference_model(encode_dtype=torch.bfloat16)``: the encoder
    folded into bfloat16 kernels and computed in bfloat16, its latents and
    feature handed to the quantizer in float32 (JAX's casts). It moves
    latents by bfloat16 rounding, so codes change: the JAX package records
    that this profile failed its 30 dB gate on a trained checkpoint. With
    ``decode_dtype=None`` the decoder computes in that dtype too, as the
    JAX model's ``compute_dtype`` makes it.

``serving_model`` is how the CLIs and ``build_model`` serve a config: the
fast profile (with ``fast``) or the live model, except that a config's
``compute_dtype: bfloat16`` folds both conv stacks into bfloat16 (the Snake
as the config sets it, the quantizer float32), as the JAX model computes
with that field.

They take a live ``DAC_VRVQ`` or ``DAC_MOE`` and return a new one of the
same class on the same device; the quantizer's tensors are shared with the
given model, never copied or folded. As in the JAX package, the packing
arguments set the profile's layouts whatever the config says, and a packed
profile serves the padded codec only: ``CodecProcessor``, streams and
``chunked`` need ``clone(padding=False)``, which raises for it.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from ..models.dac_vrvq import DAC_VRVQ, Profile
from ..nn.fold import fold_weight_norm
from ..ops.masks import generate_mask_ste
from ..ops.rvq_kernel import prepare_rvq, quantize_fused, stack_quantizer_weights

DType = Union[str, torch.dtype, None]


def _dtype(name: DType) -> torch.dtype:
    if name is None:
        return torch.float32
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


def _folded(state: dict, prefix: str, dtype: Optional[torch.dtype]) -> dict:
    """``state`` with the tensors under ``prefix`` folded (``nn/fold.py``)."""
    stack = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
    out = {k: v for k, v in state.items() if not k.startswith(prefix)}
    out.update({prefix + k: v for k, v in fold_weight_norm(stack, dtype).items()})
    return out


def make_inference_model(
    model: DAC_VRVQ,
    decode_dtype: DType = "bfloat16",
    encode_dtype: DType = None,
    snake_approx: bool = True,
    encode_snake_approx: bool = False,
    fold_encoder: bool = False,
    encode_packed: bool = False,
    decode_packed: int = 0,
    decode_packed_up: int = 0,
) -> DAC_VRVQ:
    """The fast profile of ``model`` (a live ``DAC_VRVQ`` or ``DAC_MOE``).

    ``decode_dtype``: the decoder's compute dtype (``None``: the encoder's).
    ``encode_dtype``: the encoder's (``None``: float32); another dtype
    folds the encoder into kernels of that dtype.
    ``snake_approx``: the polynomial Snake in the decoder.
    ``encode_snake_approx``: in the encoder too (the turbo profile).
    ``fold_encoder``: fold the encoder's weight norm.
    ``encode_packed``: the encoder's first stage time-packed.
    ``decode_packed``: the last ``decode_packed`` decoder blocks and the
    tail time-packed; ``decode_packed_up``: only the last blocks'
    transposed convs (the two are exclusive)."""
    if model.profile != Profile():
        raise ValueError("make_inference_model takes the live model")
    fold_encoder = fold_encoder or encode_dtype is not None
    decoder_dtype = decode_dtype if decode_dtype is not None else encode_dtype
    profile = Profile(
        encoder_folded=fold_encoder, decoder_folded=True,
        decoder_compute_dtype=_dtype(decoder_dtype),
        encoder_compute_dtype=_dtype(encode_dtype),
        encoder_snake_approx=encode_snake_approx,
        decoder_snake_approx=snake_approx,
        encoder_packed=encode_packed,
        decoder_packed=decode_packed,
        decoder_packed_up=decode_packed_up,
    )
    state = _folded(model.state_dict(), "decoder.",
                    None if decoder_dtype is None else _dtype(decoder_dtype))
    if fold_encoder:
        state = _folded(state, "encoder.",
                        None if encode_dtype is None else _dtype(encode_dtype))
    return model.with_state(state, profile=profile)


def serving_model(model: DAC_VRVQ, fast: bool) -> DAC_VRVQ:
    """``model`` (live) as its config serves it: with ``fast`` the fast
    profile (its encoder in the config's ``compute_dtype`` where that is
    bfloat16; unpacked, as JAX's ``make_inference_model`` leaves it), else
    the live model, or where ``compute_dtype`` is bfloat16 both conv stacks
    folded into bfloat16 with the config's Snakes and packing."""
    config = model.config
    encode_dtype = None if config.compute_dtype == "float32" else config.compute_dtype
    if fast:
        return make_inference_model(model, encode_dtype=encode_dtype)
    if encode_dtype is None:
        return model
    return make_inference_model(
        model, decode_dtype=None, encode_dtype=encode_dtype,
        snake_approx=config.decoder_snake_approx,
        encode_snake_approx=config.encoder_snake_approx,
        encode_packed=config.encoder_packed, decode_packed=config.decoder_packed,
        decode_packed_up=config.decoder_packed_up)


def make_serving_model(model: DAC_VRVQ, encode_packed: bool = False,
                       decode_packed: int = 0,
                       decode_packed_up: int = 0) -> DAC_VRVQ:
    """The turbo profile: the fast profile plus the polynomial Snake in the
    live float32 encoder, with the packing arguments of
    ``make_inference_model`` (``encode_packed=True``: turbo + packed
    encoder). Gate it with ``turbo_gate`` before serving."""
    return make_inference_model(model, encode_snake_approx=True,
                                encode_packed=encode_packed,
                                decode_packed=decode_packed,
                                decode_packed_up=decode_packed_up)


@dataclasses.dataclass
class GateResult:
    """Outcome of ``turbo_gate``: agreement of the turbo profile with the
    exact-codes fast profile on the probe clips."""

    agreement_db: float        # SNR of the turbo decode against the fast one
    mask_agreement: float      # fraction of VBR mask entries that agree
    code_flip_rate: float      # fraction of kept code indices that changed
    min_agreement_db: float    # the pass threshold (dB)
    min_mask_agreement: float  # the pass threshold (fraction)
    passed: bool
    clip_agreement_db: tuple = ()
    min_clip_agreement_db: float = float("nan")
    probe: str = ""            # which clips the verdict was measured on


def _probe_corpus(model, probe_dir, max_clips: int = 8):
    """Up to ``max_clips`` wavs of ``probe_dir`` (tried as given, then under
    the repo root) as (B, 1, T) float32 trimmed to the shortest, first
    channel; ``None`` when the directory is missing or empty or a rate is
    not the model's."""
    from ..audio import Signal

    cand = Path(probe_dir)
    if not cand.is_dir():
        cand = Path(__file__).resolve().parents[2] / probe_dir
    if not cand.is_dir():
        return None
    paths = sorted(cand.glob("*.wav"))[:max_clips]
    if not paths:
        return None
    rows = []
    for p in paths:
        sig = Signal.load(p)
        if sig.sample_rate != model.sample_rate:
            return None
        rows.append(np.asarray(sig.audio_data[0, 0], np.float32))
    n = min(r.shape[0] for r in rows)
    return np.stack([r[:n] for r in rows])[:, None, :]


def synthetic_probe(sample_rate: int, seed: int) -> np.ndarray:
    """Four 2 s harmonic clips (tonal content exercises the importance map
    and the bitrate better than noise), the JAX gate's fallback."""
    t = np.arange(2 * sample_rate) / sample_rate
    rng = np.random.RandomState(seed)
    rows = []
    for _ in range(4):
        f0 = rng.uniform(80, 500)
        x = sum(rng.uniform(0.05, 0.3) * np.sin(2 * np.pi * f0 * k * t)
                for k in range(1, 6))
        rows.append(x)
    return np.stack(rows).astype(np.float32)[:, None, :]


def encode_codes(model: DAC_VRVQ, audio: torch.Tensor, level: float):
    """The serving encode of a padded codec: encoder and importance map as
    the module path computes them, the codes of all stages from the fused
    RVQ kernel (a ``DAC_MOE``: the module path, which the fused kernel does
    not serve). audio (B, 1, T) -> (codes (B, Nq, T'), mask_imp (B, Nq, T'))."""
    if not model.prefix_mask:
        enc = model.encode(audio, level=level)
        return enc["codes"], enc["mask_imp"]
    n_q = model.n_codebooks
    z, feat = model.encoder(audio, return_feat=True)
    imp_map = model.quantizer.importance(feat, z.shape[-1])
    mask = generate_mask_ste(imp_map * level * n_q, n_q,
                             alpha=model.config.imp2mask_alpha)
    rvq = prepare_rvq(stack_quantizer_weights(model.quantizer))
    _, codes = quantize_fused(rvq, z)
    return codes, mask


def turbo_gate(
    model: DAC_VRVQ,
    clips=None,
    level: float = 1.0,
    min_agreement_db: float = 30.0,
    min_mask_agreement: float = 0.999,
    seed: int = 0,
    probe_dir: str = "data_synth/test",
    **serving_kwargs,
) -> GateResult:
    """Accuracy gate for the turbo profile of ``model`` (live).

    Encodes ``clips`` (B, 1, T) with the exact-codes fast profile and with
    the turbo one (``serving_kwargs`` go to ``make_serving_model``: say
    ``encode_packed=True``), decodes both code streams with the fast decoder, and
    measures the agreement of the two decodes (dB), of the VBR masks, and
    the flip rate of the codes both masks keep. ``passed`` when
    ``agreement_db >= min_agreement_db`` and ``mask_agreement >=
    min_mask_agreement``. Without ``clips`` it probes the wavs of
    ``probe_dir``, else four synthetic harmonic clips."""
    probe = "caller-supplied clips"
    if clips is None:
        clips = _probe_corpus(model, probe_dir)
        probe = (f"held-out corpus {probe_dir} "
                 f"({0 if clips is None else len(clips)} clips)")
    if clips is None:
        clips = synthetic_probe(model.sample_rate, seed)
        probe = "synthetic harmonics (4 clips, fallback)"
    device = next(model.parameters()).device

    exact_m = make_inference_model(model)
    turbo_m = make_serving_model(model, **serving_kwargs)
    with torch.inference_mode():
        audio = torch.as_tensor(np.asarray(clips, np.float32)).to(device)
        codes_e, mask_e = encode_codes(exact_m, audio, level)
        codes_t, mask_t = encode_codes(turbo_m, audio, level)
        rec_e = exact_m.decode_from_codes(codes_e.long(), mask_e).cpu().numpy()
        rec_t = exact_m.decode_from_codes(codes_t.long(), mask_t).cpu().numpy()

    def _db(sig, err):
        return float("inf") if err == 0 else float(
            10 * np.log10(max(sig, 1e-12) / err))

    agreement_db = _db((rec_e ** 2).sum(), ((rec_e - rec_t) ** 2).sum())
    axes = tuple(range(1, rec_e.ndim))
    clip_db = tuple(
        _db(s, e) for s, e in zip((rec_e ** 2).sum(axis=axes),
                                  ((rec_e - rec_t) ** 2).sum(axis=axes)))
    mask_e, mask_t = mask_e.cpu().numpy(), mask_t.cpu().numpy()
    codes_e, codes_t = codes_e.cpu().numpy(), codes_t.cpu().numpy()
    mask_agreement = float((mask_e == mask_t).mean())
    # flips count only where both masks keep the stage
    both = (mask_e > 0) & (mask_t > 0)
    flips = float((codes_e[both] != codes_t[both]).mean()) if both.any() else 0.0
    return GateResult(
        agreement_db=agreement_db,
        mask_agreement=mask_agreement,
        code_flip_rate=flips,
        min_agreement_db=min_agreement_db,
        min_mask_agreement=min_mask_agreement,
        passed=(agreement_db >= min_agreement_db
                and mask_agreement >= min_mask_agreement),
        clip_agreement_db=clip_db,
        min_clip_agreement_db=min(clip_db) if clip_db else float("nan"),
        probe=probe,
    )
