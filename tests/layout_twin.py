"""The (B, C, T) twin of a model whose bfloat16 decoder runs channels-last:
what the channels-last path is held to, on the CPU and on the card. Imports
neither JAX nor the JAX package, so the card's tests can use it."""

import torch


def ncl_twin(model):
    """A clone of ``model`` computing its decoder in (B, C, T) on the same
    parameter values, as the bfloat16 decoder ran before it went
    channels-last: every conv's channels-last switch off and its kernel
    contiguous."""
    twin = model.clone(padding=model.padding)
    for mod in twin.decoder.modules():
        if getattr(mod, "channels_last", False):
            mod.channels_last = False
            if hasattr(mod, "w"):
                mod.w = torch.nn.Parameter(mod.w.contiguous(), requires_grad=False)
    return twin
