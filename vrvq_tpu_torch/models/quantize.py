"""Variable-bitrate residual vector quantization, eval mode.

Counterpart of ``vrvq_tpu/models/quantize.py`` (``VectorQuantize`` and
``VBRResidualVectorQuantize``). Tensors are ``(B, D, T)`` at every public
method; the nearest-codebook search flattens frames to rows. Distances are
float32 and the argmax keeps the first maximum, as in the JAX module.
Training (random levels, dropout partitions, losses) and the CBR-only
``ResidualVectorQuantize`` are not ported.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.masks import generate_mask_ste
from .importance import ImportanceSubnet
from .wn_dense import WNDense1x1


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """``x / max(||x||, eps)`` over the last axis."""
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp(norm, min=eps)


class VectorQuantize(nn.Module):
    """One factorized-VQ stage: in_proj -> nearest normalized code ->
    straight-through sum -> out_proj. ``codebook (K, d)``."""

    def __init__(self, input_dim: int, codebook_size: int, codebook_dim: int):
        super().__init__()
        self.in_proj = WNDense1x1(input_dim, codebook_dim)
        self.out_proj = WNDense1x1(codebook_dim, input_dim)
        self.codebook = nn.Parameter(torch.empty(codebook_size, codebook_dim))

    def forward(self, z: torch.Tensor):
        """z (B, D, T) -> (z_q (B, D, T), indices (B, T), z_e (B, d, T))."""
        z_e = self.in_proj(z)
        z_q, indices = self.decode_latents(z_e)
        z_q = z_e + (z_q - z_e)
        return self.out_proj(z_q), indices, z_e

    def decode_code(self, embed_id: torch.Tensor) -> torch.Tensor:
        """(B, T) indices -> (B, d, T) codebook rows."""
        return self.codebook[embed_id].transpose(1, 2)

    def decode_latents(self, latents: torch.Tensor):
        """Nearest-code search; latents (B, d, T) -> (z_q (B, d, T), (B, T))."""
        b, d, t = latents.shape
        enc = _l2_normalize(latents.transpose(1, 2).reshape(b * t, d).float())
        cb = _l2_normalize(self.codebook.float())
        dist = (
            torch.sum(enc * enc, dim=1, keepdim=True)
            - 2.0 * (enc @ cb.T)
            + torch.sum(cb * cb, dim=1, keepdim=True).T
        )
        indices = torch.argmax(-dist, dim=1).reshape(b, t)
        return self.decode_code(indices).to(latents.dtype), indices


class VBRResidualVectorQuantize(nn.Module):
    """All Nq stages run on the residual; a per-frame importance map gates how
    many each frame keeps (VBR at a ``level``), or ``n_quantizers`` stages
    are kept everywhere (CBR)."""

    def __init__(self, input_dim: int, n_codebooks: int, codebook_size: int,
                 codebook_dim: int, imp2mask_alpha: float = 1.0):
        super().__init__()
        self.n_codebooks = n_codebooks
        self.imp2mask_alpha = imp2mask_alpha
        for i in range(n_codebooks):
            self.add_module(f"quantizers_{i}",
                            VectorQuantize(input_dim, codebook_size,
                                           codebook_dim))
        self.imp_subnet = ImportanceSubnet(input_dim, input_dim)

    @property
    def quantizers(self):
        return [getattr(self, f"quantizers_{i}") for i in range(self.n_codebooks)]

    def importance(self, feat_enc: torch.Tensor, frames: int) -> torch.Tensor:
        """Importance map (B, 1, frames). A padding-free encoder's feature is
        2 frames longer than z (its k=3 out conv shrinks unpadded): the map
        is center-cropped to the latent frames."""
        imp_map = self.imp_subnet(feat_enc)
        extra = imp_map.shape[-1] - frames
        if extra > 0:
            lo = extra // 2
            imp_map = imp_map[..., lo:lo + frames]
        return imp_map

    def forward(self, z: torch.Tensor, n_quantizers: Optional[int] = None,
                feat_enc: Optional[torch.Tensor] = None,
                level: Optional[float] = None) -> dict:
        """z, feat_enc (B, D, T). Returns z_q (B, D, T), z_q_is
        (B, n, D, T), codes (B, n, T), latents (B, n*d, T), imp_map
        (B, 1, T) or None and mask_imp (B, n, T)."""
        bs, _, frames = z.shape
        vbr = n_quantizers is None
        if vbr and level is None:
            raise ValueError("level must be specified in VBR inference")
        if not vbr and not 1 <= int(n_quantizers) <= self.n_codebooks:
            raise ValueError(
                f"n_quantizers must be in [1, {self.n_codebooks}], "
                f"got {n_quantizers}"
            )
        n_stages = self.n_codebooks if vbr else int(n_quantizers)

        residual = z
        z_q_is, codes, latents = [], [], []
        for quantizer in self.quantizers[:n_stages]:
            z_q_i, indices_i, z_e_i = quantizer(residual)
            z_q_is.append(z_q_i)
            residual = residual - z_q_i
            codes.append(indices_i)
            latents.append(z_e_i)

        if vbr:
            imp_map = self.importance(feat_enc, frames)
            mask_imp = generate_mask_ste(
                imp_map * level * self.n_codebooks, self.n_codebooks,
                alpha=self.imp2mask_alpha,
            )
        else:
            # all-ones mask over the stages run (CBR inside the VBR model)
            imp_map = None
            mask_imp = torch.ones((bs, n_stages, frames), dtype=z.dtype,
                                  device=z.device)

        z_q_is = torch.stack(z_q_is, dim=1)
        return {
            "z_q": torch.sum(z_q_is * mask_imp[:, :, None, :], dim=1),
            "z_q_is": z_q_is,
            "codes": torch.stack(codes, dim=1),
            "latents": torch.cat(latents, dim=1),
            "imp_map": imp_map,
            "mask_imp": mask_imp,
        }

    def from_codes(self, codes: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """codes (B, n, T) [+ mask (B, n, T), 1 = keep] -> z_q (B, D, T)."""
        z_q = 0.0
        for i in range(codes.shape[1]):
            q = self.quantizers[i]
            z_q_i = q.out_proj(q.decode_code(codes[:, i, :]))
            if mask is not None:
                z_q_i = z_q_i * mask[:, i:i + 1, :]
            z_q = z_q + z_q_i
        return z_q
