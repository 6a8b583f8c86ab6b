"""Seeded random weights in the upstream (reference) layout, drawn on the
device in two calls, and handed to the program through its own converters.

Every weight-normed conv: ``v`` uniform in +-1/sqrt(fan_in), ``g = ||v||``
(so the effective kernel is ``v``), the bias uniform in +-1/sqrt(fan_in);
Snake alpha uniform in [0.5, 1.5); codebooks N(0, 1). The same seed gives
the same tensors on any run, so the reference draws them again after the
window instead of keeping a copy."""

from __future__ import annotations

import math

import torch
from torch import nn

from .reference.codec import Snake, WNConv
from .reference.train import WNConv2d

SEED_MIX = 0x5EED_C0DEC  # keeps the weights' stream apart from the data's


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """The device generator of ``seed``'s stream ``stream``: 0 the codec's
    weights, 1 the clips, 2 the discriminator's weights."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + SEED_MIX + stream) % (2 ** 63))


def _parts(module: nn.Module):
    """The modules that hold parameters, in a fixed order."""
    for m in module.modules():
        if isinstance(m, (WNConv, WNConv2d, Snake, nn.Embedding)):
            yield m


@torch.no_grad()
def draw(module: nn.Module, seed: int, stream: int = 0) -> nn.Module:
    """Fill every parameter of ``module`` (a reference ``Codec`` or
    ``Discriminator``, on its device) from ``seed``'s stream ``stream``."""
    device = next(module.parameters()).device
    mods = list(_parts(module))
    n_uni = sum(m.weight_v.numel() + m.bias.numel()
                if not isinstance(m, (Snake, nn.Embedding)) else
                (m.alpha.numel() if isinstance(m, Snake) else 0) for m in mods)
    n_norm = sum(m.weight.numel() for m in mods if isinstance(m, nn.Embedding))
    gen = generator(seed, device, stream)
    u = torch.rand(n_uni, generator=gen, device=device)
    z = torch.randn(n_norm, generator=gen, device=device)
    iu = iz = 0

    def take(n):
        nonlocal iu
        iu += n
        return u[iu - n:iu]

    for m in mods:
        if isinstance(m, nn.Embedding):
            n = m.weight.numel()
            m.weight.copy_(z[iz:iz + n].view_as(m.weight))
            iz += n
        elif isinstance(m, Snake):
            m.alpha.copy_(0.5 + take(m.alpha.numel()).view_as(m.alpha))
        else:
            v = m.weight_v
            transposed = getattr(m, "transposed", False)
            fan_in = (v.shape[0] if transposed else v.shape[1]) * math.prod(v.shape[2:])
            b = 1.0 / math.sqrt(fan_in)
            v.copy_((take(v.numel()).view_as(v) * 2 - 1) * b)
            dims = tuple(range(1, v.ndim))
            norm = torch.sqrt(torch.sum(v * v, dim=dims, keepdim=True))
            m.weight_g.copy_(norm)
            m.bias.copy_((take(m.bias.numel()) * 2 - 1) * b)
    return module


def host_state(module: nn.Module) -> dict:
    """``module``'s state dict on the host, float32, for the program's
    converters."""
    return {k: v.detach().to("cpu", torch.float32) for k, v in module.state_dict().items()}
