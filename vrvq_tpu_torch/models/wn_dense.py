"""Weight-normed 1x1 projection as a matmul (counterpart of
``vrvq_tpu/models/wn_dense.py``): ``v (in, out)``, ``g (out,)``, the norm taken
per out-channel over the input axis."""

from __future__ import annotations

import torch
from torch import nn

from ..nn.layers import weight_norm


class WNDense1x1(nn.Module):
    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.v = nn.Parameter(torch.empty(in_features, out_features))
        self.g = nn.Parameter(torch.empty(out_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def weight(self) -> torch.Tensor:
        """Effective weight (in, out)."""
        return weight_norm(self.v, self.g.reshape(1, -1), (0,))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, in, T) -> (B, out, T)."""
        y = x.transpose(1, 2) @ self.weight() + self.bias
        return y.transpose(1, 2)
