"""Weight-norm folding for inference.

Counterpart of ``vrvq_tpu/nn/fold.py``. Every conv of the codec is
weight-normed (``w = g * v / max(||v||, 1e-32)``) and a live conv recomputes
``w`` on every call (``nn/layers.py``). ``fold_weight_norm`` computes each
effective kernel once, in float32, with the live conv's own expression, so
in eager PyTorch the folded ``w`` is the very tensor a live call builds, and
a float32 folded stack gives the live stack's outputs bit for bit. The folded
state drives the same modules built with ``folded=True``.

Layouts: a conv's ``v (out, in, k)`` has ``g`` per out-channel, a transposed
conv's ``v (in, out, k)`` ``g`` per IN-channel (the JAX package's
``_TRANSPOSED_NAMES`` case). Both put ``g``'s axis first, so one expression
folds both. The folded tree keeps each layout, with ``{v, g} -> {w}``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from .layers import weight_norm


def _fold_conv(v: torch.Tensor, g: torch.Tensor,
               dtype: Optional[torch.dtype]) -> torch.Tensor:
    w = weight_norm(v.float(), g.float().reshape(-1, 1, 1), (1, 2))
    return w if dtype is None else w.to(dtype)


def fold_weight_norm(state_dict: Mapping[str, torch.Tensor],
                     dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """Fold every ``{prefix.v, prefix.g}`` pair of a conv stack's state dict
    into ``prefix.w`` and cast every other floating tensor to ``dtype`` when
    given (say ``torch.bfloat16``), as the JAX fold casts every leaf. Snake
    ``alpha`` stays float32, as the Snake kernel reads it, holding the value
    that ``dtype`` rounds it to. Pass a stack's tensors (the decoder's, say),
    not the quantizer's: its projections are never folded."""
    out = {}
    with torch.no_grad():
        for key, value in state_dict.items():
            prefix, _, name = key.rpartition(".")
            pair = f"{prefix}.v" in state_dict and f"{prefix}.g" in state_dict
            if pair and name == "v":
                out[f"{prefix}.w"] = _fold_conv(value, state_dict[f"{prefix}.g"],
                                                dtype)
            elif pair and name == "g":
                continue
            elif dtype is None or not value.is_floating_point():
                out[key] = value
            elif name == "alpha":
                out[key] = value.to(dtype).float()
            else:
                out[key] = value.to(dtype)
    return out
