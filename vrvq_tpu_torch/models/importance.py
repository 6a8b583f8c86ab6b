"""Importance subnet (counterpart of ``vrvq_tpu/models/importance.py``): a
Snake + k=3 conv head 1024 -> 1024 -> 512 -> 128 -> 32 -> 8 -> 1 with a final
sigmoid, fed by the encoder's activation after its last block. Its convs are
always padded, in the padding-free codec too. (B, d_input, T) -> (B, 1, T).
``detach_input`` stops the gradient at the input (``vrvq_a2_dt.yml``)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..nn.layers import Snake1d, WNConv1d


class ImportanceSubnet(nn.Module):
    def __init__(self, d_input: int, d_feat: int,
                 intermediate_channels: Sequence[int] = (512, 128, 32, 8),
                 out_channels: int = 1, detach_input: bool = False):
        super().__init__()
        self.detach_input = detach_input
        self.in_snake = Snake1d(d_input)
        self.in_conv = WNConv1d(d_input, d_feat, 3, padding=1)
        ins = [d_feat] + list(intermediate_channels)
        outs = list(intermediate_channels) + [out_channels]
        self.n_layers = len(ins)
        for i, (cin, cout) in enumerate(zip(ins, outs)):
            self.add_module(f"snake_{i}", Snake1d(cin))
            self.add_module(f"conv_{i}", WNConv1d(cin, cout, 3, padding=1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.detach_input:
            x = x.detach()
        x = self.in_conv(self.in_snake(x))
        for i in range(self.n_layers):
            x = getattr(self, f"conv_{i}")(getattr(self, f"snake_{i}")(x))
        return torch.sigmoid(x)
