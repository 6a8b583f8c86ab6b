"""Training transforms (counterpart of ``vrvq_tpu/data/transforms.py``).

``instantiate(state, signal)`` draws an item's parameters on the host from
its numpy RandomState, in the JAX package's order, and returns a dict;
``transform(audio, **batched_args)`` applies them to the batch ``(B, C, T)``
on the tensor's device. A transform applies to a row where its ``mask`` is
1 (drawn as ``rand() <= prob``). Ported: the transforms ``conf/`` names
(``Identity``, ``RescaleAudio``, ``ShiftPhase``, ``VolumeNorm``), ``Compose``
and ``build_transform``, which takes each transform's arguments from the
config's ``<Name>.<arg>`` keys (``VolumeNorm.db``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..audio import random_state
from ..ops import stft as stft_ops


def _column(value, audio: torch.Tensor) -> torch.Tensor:
    """A batched parameter as a (B, 1, 1) tensor on the audio's device."""
    return torch.as_tensor(np.asarray(value), dtype=audio.dtype,
                           device=audio.device).reshape(-1, 1, 1)


class BaseTransform:
    def __init__(self, name: Optional[str] = None, prob: float = 1.0):
        self.name = name or type(self).__name__
        self.prob = prob

    def _instantiate(self, state, signal=None) -> Dict:
        return {}

    def instantiate(self, state, signal=None) -> Dict:
        state = random_state(state)
        args = self._instantiate(state, signal)
        args["mask"] = np.float32(state.rand() <= self.prob)
        return {self.name: args}

    def _transform(self, audio: torch.Tensor, **kwargs) -> torch.Tensor:
        return audio

    def __call__(self, audio: torch.Tensor, **all_args) -> torch.Tensor:
        args = all_args.get(self.name, {})
        mask = _column(args.get("mask", 1.0), audio)
        kwargs = {k: v for k, v in args.items() if k != "mask"}
        out = self._transform(audio, **kwargs)
        return mask * out + (1.0 - mask) * audio


class Identity(BaseTransform):
    pass


class RescaleAudio(BaseTransform):
    """Scale each row down to a peak of ``val`` where it exceeds it."""

    def __init__(self, val: float = 1.0, name=None, prob: float = 1.0):
        super().__init__(name=name, prob=prob)
        self.val = val

    def _transform(self, audio):
        peak = torch.amax(torch.abs(audio), dim=(1, 2), keepdim=True)
        return audio * torch.clamp(self.val / torch.clamp(peak, min=1e-9), max=1.0)


class ShiftPhase(BaseTransform):
    """Rotate every STFT bin's phase by a per-row constant ~ U(-pi, pi)."""

    def __init__(self, shift_range=(-np.pi, np.pi), name=None, prob: float = 1.0):
        super().__init__(name=name, prob=prob)
        self.shift_range = shift_range

    def _instantiate(self, state, signal=None):
        lo, hi = self.shift_range
        return {"shift": np.float32(state.uniform(lo, hi))}

    def _transform(self, audio, shift=0.0):
        w, hop = 2048, 512
        spec = stft_ops.stft(audio, w, hop)
        shift = _column(shift, audio).reshape(-1, 1, 1, 1)
        spec = spec * torch.exp(1j * shift.to(torch.complex64))
        return stft_ops.istft(spec, w, hop, audio.shape[-1]).to(audio.dtype)


class VolumeNorm(BaseTransform):
    """Scale each row to a loudness of ``db`` (LUFS): ``("const", v)`` or
    ``("uniform", lo, hi)``, drawn from the item's state. The item's
    loudness is measured on the host (BS.1770, ``ops/loudness.py``) when it
    is drawn; the transform is a gain on the device."""

    def __init__(self, db=("const", -24), name=None, prob: float = 1.0):
        super().__init__(name=name, prob=prob)
        self.db = tuple(db)

    def _draw(self, state) -> float:
        kind = self.db[0]
        if kind == "const":
            return float(self.db[1])
        if kind == "uniform":
            return float(state.uniform(self.db[1], self.db[2]))
        raise ValueError(f"Unknown db spec {self.db}")

    def _instantiate(self, state, signal=None):
        target = self._draw(state)
        loudness = float(signal.loudness()[0]) if signal is not None else -24.0
        return {"gain": np.float32(np.exp((target - loudness) * np.log(10) / 20))}

    def _transform(self, audio, gain=1.0):
        return audio * _column(gain, audio)


class Compose(BaseTransform):
    """Transforms in order, under one more mask of its own."""

    def __init__(self, *transforms: BaseTransform, name=None, prob: float = 1.0):
        super().__init__(name=name, prob=prob)
        self.transforms = list(transforms)
        seen: Dict[str, int] = {}
        for t in self.transforms:  # duplicate names become name.1, name.2
            if t.name in seen:
                seen[t.name] += 1
                t.name = f"{t.name}.{seen[t.name]}"
            else:
                seen[t.name] = 0

    def _instantiate(self, state, signal=None):
        args = {}
        for t in self.transforms:
            args.update(t.instantiate(state, signal))
        return args

    def __call__(self, audio: torch.Tensor, **all_args) -> torch.Tensor:
        args = all_args.get(self.name, {})
        mask = _column(args.get("mask", 1.0), audio)
        out = audio
        for t in self.transforms:
            out = t(out, **args)
        return mask * out + (1.0 - mask) * audio


TRANSFORMS = {"Identity": Identity, "RescaleAudio": RescaleAudio,
              "ShiftPhase": ShiftPhase, "VolumeNorm": VolumeNorm}


def build_transform(augment_prob: float = 1.0,
                    preprocess: Optional[List[str]] = None,
                    augment: Optional[List[str]] = None,
                    postprocess: Optional[List[str]] = None,
                    cfg=None) -> Compose:
    """``Compose(preprocess, augment (at augment_prob), postprocess)``, each
    a ``Compose`` of the named transforms (``Identity`` when empty), each
    built with ``cfg.kwargs(name)`` (a ``config.Config``, in the scope of
    the caller) when ``cfg`` is given."""

    def chain(names):
        unknown = [n for n in names or [] if n not in TRANSFORMS]
        if unknown:
            raise NotImplementedError(
                f"transforms not ported: {unknown} (ported: {sorted(TRANSFORMS)})")
        return [TRANSFORMS[n](**(cfg.kwargs(n) if cfg is not None else {}))
                for n in (names or ["Identity"])]

    return Compose(Compose(*chain(preprocess), name="preprocess"),
                   Compose(*chain(augment), name="augment", prob=augment_prob),
                   Compose(*chain(postprocess), name="postprocess"))

