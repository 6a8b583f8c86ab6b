"""Variable-bitrate residual vector quantization, in eval and train mode.

Counterpart of ``vrvq_tpu/models/quantize.py`` (``VectorQuantize`` and
``VBRResidualVectorQuantize``). Tensors are ``(B, D, T)`` at every public
method; the nearest-codebook search flattens frames to rows. Distances are
float32 and the argmax keeps the first maximum, as in the JAX module.

Train mode draws one level per clip and partitions the batch into
importance-masked, random-depth (dropout) and full-codebook rows; the draws
come from a ``torch.Generator`` or are passed in (``levels``, ``depths``).
Under data parallelism a train forward sees its rows of a larger batch
(``rows = (offset, total)``): the draws and the partition are the whole
batch's, and the forward keeps the part of each that its rows hold, so the
ranks together compute the one forward of the whole batch.
The straight-through estimator and the mask's are detached as the JAX
module's ``stop_gradient``: the encoder gets the gradient of z_q, the
importance subnet that of the smooth mask.

``ResidualVectorQuantize`` is the constant-bitrate quantizer of the CBR
codec (``model_type: CBR``, ``conf/original_dac/cbr.yml``): ``n_quantizers``
stages in eval, all of them in train with per-sample quantizer dropout (the
first ``int(B * quantizer_dropout)`` rows keep a depth drawn in [1, Nq]).
Both quantizers rebuild z_q from codes (``from_codes``) and from the
stages' latents (``from_latents``).

``codebook_dim`` is one width for every stage or a sequence of one a stage
(the JAX ``codebook_dims``); the latents of the stages then lie side by
side at those widths.

``GatedResidualVectorQuantize`` holds what the VBR quantizer shares with
``DAC_MOE``'s router quantizer (``models/dac_moe.py``): the stages on the
residual, the train-mode draws and batch partition, the masked sums. A
subclass gives the per-frame scores (``importance``) and their mask
(``gate``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..ops.masks import generate_mask_hard, generate_mask_ste
from .importance import ImportanceSubnet
from .wn_dense import WNDense1x1


def local_parts(counts: Sequence[int], rows: Optional[Tuple[int, int]],
                bs: int) -> List[Tuple[int, int]]:
    """A train batch's parts (``counts`` rows each, in batch order) as the
    rows ``[offset, offset + bs)`` of that batch of ``total`` rows hold them,
    ``rows = (offset, total)`` (None: the whole batch, ``(0, bs)``). For each
    part: how many of its rows are local, and the index within the part of
    the first of them."""
    offset, total = (0, bs) if rows is None else rows
    if sum(counts) != total or not 0 <= offset <= total - bs:
        raise ValueError(f"rows {offset}..{offset + bs} of a batch of {total} "
                         f"(parts {list(counts)})")
    out, start = [], 0
    for n in counts:
        lo, hi = max(start, offset), min(start + n, offset + bs)
        out.append((hi - lo, lo - start) if hi > lo else (0, 0))
        start += n
    return out


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

    def forward(self, z: torch.Tensor, losses: bool = False):
        """z (B, D, T) -> (z_q (B, D, T), indices (B, T), z_e (B, d, T)), and
        with ``losses`` the per-frame commitment and codebook losses (B, T)
        after them."""
        z_e = self.in_proj(z)
        z_q, indices = self.decode_latents(z_e)
        out = ()
        if losses:
            commitment = torch.mean(torch.square(z_e - z_q.detach()), dim=1)
            codebook = torch.mean(torch.square(z_q - z_e.detach()), dim=1)
            out = (commitment, codebook)
        z_q = z_e + (z_q - z_e).detach()  # straight-through
        return (self.out_proj(z_q), indices, z_e) + out

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


class _Stages(nn.Module):
    """``n_codebooks`` factorized-VQ stages (``quantizers_{i}``, stage i of
    width ``codebook_dims[i]``) and what rebuilds z_q from their codes or
    latents."""

    def __init__(self, input_dim: int, n_codebooks: int, codebook_size: int,
                 codebook_dim: Union[int, Sequence[int]],
                 quantizer_dropout: float = 0.0):
        super().__init__()
        self.n_codebooks = n_codebooks
        self.codebook_dims = ([codebook_dim] * n_codebooks
                              if isinstance(codebook_dim, int)
                              else list(codebook_dim))
        if len(self.codebook_dims) != n_codebooks:
            raise ValueError(f"codebook_dim {codebook_dim} has "
                             f"{len(self.codebook_dims)} entries for "
                             f"{n_codebooks} codebooks")
        self.quantizer_dropout = quantizer_dropout
        for i, d in enumerate(self.codebook_dims):
            self.add_module(f"quantizers_{i}",
                            VectorQuantize(input_dim, codebook_size, d))

    @property
    def quantizers(self):
        return [getattr(self, f"quantizers_{i}") for i in range(self.n_codebooks)]

    def n_stages(self, n_quantizers: Optional[int]) -> int:
        if n_quantizers is None:
            return self.n_codebooks
        if not 1 <= int(n_quantizers) <= self.n_codebooks:
            raise ValueError(
                f"n_quantizers must be in [1, {self.n_codebooks}], "
                f"got {n_quantizers}"
            )
        return int(n_quantizers)

    def random_depths(self, n: int, generator: Optional[torch.Generator],
                      device) -> Optional[torch.Tensor]:
        """``n`` quantizer-dropout depths drawn in [1, Nq], or None."""
        if n == 0:
            return None
        return torch.randint(1, self.n_codebooks + 1, (n,), generator=generator,
                             device=device)

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

    def from_latents(self, latents: torch.Tensor):
        """latents (B, sum d_i, T), the stages' in-projections side by side ->
        (z_q (B, D, T), z_p (B, sum d_i, T) the nearest codebook rows, codes
        (B, n, T)), over the whole stages the width holds."""
        ends = [0]
        for d in self.codebook_dims:
            ends.append(ends[-1] + d)
        n = max(i for i, end in enumerate(ends) if end <= latents.shape[1])
        z_q, z_p, codes = 0.0, [], []
        for i in range(n):
            q = self.quantizers[i]
            z_p_i, codes_i = q.decode_latents(latents[:, ends[i]:ends[i + 1], :])
            z_p.append(z_p_i)
            codes.append(codes_i)
            z_q = z_q + q.out_proj(z_p_i)
        return z_q, torch.cat(z_p, dim=1), torch.stack(codes, dim=1)


class ResidualVectorQuantize(_Stages):
    """The CBR quantizer: ``n_quantizers`` stages on the residual (all Nq by
    default); in train mode all Nq, each row keeping the stages under its
    depth (Nq for all but the first ``int(B * quantizer_dropout)`` rows)."""

    def draws(self, batch: int, generator: Optional[torch.Generator],
              device) -> dict:
        """A train forward's random numbers for ``batch`` rows: the dropout
        rows' ``depths``."""
        return {"depths": self.random_depths(
            int(batch * self.quantizer_dropout), generator, device)}

    def forward(self, z: torch.Tensor, n_quantizers: Optional[int] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                depths: Optional[Sequence[int]] = None,
                rows: Optional[Tuple[int, int]] = None) -> dict:
        """z (B, D, T) -> z_q (B, D, T), codes (B, n, T), latents
        (B, n * d, T), and in train mode ``commitment_loss`` and
        ``codebook_loss`` (each row's stage means, masked by its depth, then
        the batch mean, summed over the stages). ``depths`` pins the dropout
        rows' draws; ``rows = (offset, total)``: z holds those rows of a
        train batch of ``total`` (draws and dropout rows are that batch's)."""
        bs = z.shape[0]
        if train and n_quantizers is not None:
            raise ValueError("train mode runs every stage (n_quantizers=None)")
        n_stages = self.n_stages(n_quantizers)
        if train:
            total = bs if rows is None else rows[1]
            n_all = int(total * self.quantizer_dropout)
            (n_dropout, first), _ = local_parts((n_all, total - n_all), rows, bs)
            if depths is None and n_all > 0:
                depths = self.draws(total, generator, z.device)["depths"]
            keep = torch.full((bs,), float(self.n_codebooks + 1), dtype=z.dtype,
                              device=z.device)
            if n_dropout > 0:
                keep = torch.cat([torch.as_tensor(depths, device=z.device)
                                  .reshape(-1)[first:first + n_dropout]
                                  .to(z.dtype), keep[n_dropout:]])
        residual = z
        z_q, commitment, codebook = 0.0, 0.0, 0.0
        codes, latents = [], []
        for i, quantizer in enumerate(self.quantizers[:n_stages]):
            z_q_i, indices_i, z_e_i, *stage_losses = quantizer(residual, train)
            residual = residual - z_q_i
            codes.append(indices_i)
            latents.append(z_e_i)
            if train:
                mask = (float(i) < keep).to(z.dtype)
                z_q_i = z_q_i * mask[:, None, None]
                commitment = commitment + torch.mean(
                    torch.mean(stage_losses[0], dim=1) * mask)
                codebook = codebook + torch.mean(
                    torch.mean(stage_losses[1], dim=1) * mask)
            z_q = z_q + z_q_i
        out = {"z_q": z_q, "codes": torch.stack(codes, dim=1),
               "latents": torch.cat(latents, dim=1),
               "imp_map": None, "mask_imp": None}
        if train:
            out["commitment_loss"] = commitment
            out["codebook_loss"] = codebook
        return out


class GatedResidualVectorQuantize(_Stages):
    """All Nq stages run on the residual; per-frame scores of the encoder's
    feature gate which stages each frame keeps (at a ``level``, or at random
    levels in train mode), or ``n_quantizers`` stages are kept everywhere
    (CBR). Subclasses give ``importance`` (the scores, cropped to the latent
    frames) and ``gate`` (their mask, straight-through)."""

    # train mode draws levels in [level_min, level_max]: the JAX VBR
    # quantizer asserts level_min < level_max, DAC_MOE's router <=
    equal_levels_ok = False

    def __init__(self, input_dim: int, n_codebooks: int, codebook_size: int,
                 codebook_dim: Union[int, Sequence[int]],
                 imp2mask_alpha: float = 1.0,
                 quantizer_dropout: float = 0.0,
                 full_codebook_rate: float = 0.0,
                 level_min: Optional[float] = None,
                 level_max: Optional[float] = None,
                 level_dist: str = "uniform"):
        super().__init__(input_dim, n_codebooks, codebook_size, codebook_dim,
                         quantizer_dropout)
        self.imp2mask_alpha = imp2mask_alpha
        self.full_codebook_rate = full_codebook_rate
        self.level_min = level_min
        self.level_max = level_max
        self.level_dist = level_dist

    def importance(self, feat_enc: torch.Tensor, frames: int) -> torch.Tensor:
        raise NotImplementedError

    def gate(self, scaled: torch.Tensor) -> torch.Tensor:
        """The mask (B, Nq, T) of the scores scaled by ``level * Nq``."""
        raise NotImplementedError

    @staticmethod
    def crop(imp_map: torch.Tensor, frames: int) -> torch.Tensor:
        """A padding-free encoder's feature is 2 frames longer than z (its
        k=3 out conv shrinks unpadded): the scores are center-cropped to the
        latent frames."""
        extra = imp_map.shape[-1] - frames
        if extra > 0:
            lo = extra // 2
            imp_map = imp_map[..., lo:lo + frames]
        return imp_map

    def partition(self, batch: int):
        """``(n_imps, n_dropout, n_full)``: the train batch's importance-masked,
        random-depth and full-codebook rows, truncated with ``int`` as in
        JAX."""
        n_full = int(batch * self.full_codebook_rate)
        n_dropout = int(batch * self.quantizer_dropout)
        return batch - n_full - n_dropout, n_dropout, n_full

    def random_levels(self, u: torch.Tensor) -> torch.Tensor:
        """Levels from uniform draws ``u`` in [0, 1): uniform or log-uniform
        in ``[level_min, level_max]``."""
        lo, hi = self.level_min, self.level_max
        ordered = lo is not None and hi is not None and (
            lo <= hi if self.equal_levels_ok else lo < hi)
        if not ordered:
            raise ValueError(
                f"train mode needs level_min {'<=' if self.equal_levels_ok else '<'}"
                f" level_max, got {lo}, {hi}")
        if self.level_dist == "uniform":
            return u * (hi - lo) + lo
        if self.level_dist == "log_uniform":
            return torch.exp(u * (math.log(hi) - math.log(lo)) + math.log(lo))
        raise ValueError(f"Invalid level_dist {self.level_dist!r}")

    def draws(self, batch: int, generator: Optional[torch.Generator],
              device) -> dict:
        """A train forward's random numbers for ``batch`` rows, in the order
        the forward draws them: each row's ``levels (B,)``, then the
        dropout rows' ``depths``."""
        u = torch.rand((batch,), generator=generator, device=device)
        return {"levels": self.random_levels(u),
                "depths": self.random_depths(self.partition(batch)[1],
                                             generator, device)}

    def forward(self, z: torch.Tensor, n_quantizers: Optional[int] = None,
                feat_enc: Optional[torch.Tensor] = None,
                level: Optional[float] = None, train: bool = False,
                generator: Optional[torch.Generator] = None,
                levels: Optional[torch.Tensor] = None,
                depths: Optional[Sequence[int]] = None,
                rows: Optional[Tuple[int, int]] = None) -> dict:
        """z, feat_enc (B, D, T). Returns z_q (B, D, T), z_q_is
        (B, n, D, T), codes (B, n, T), latents (B, n*d, T), imp_map
        (B, 1, T) or None and mask_imp (B, n, T).

        ``train=True`` (VBR only) draws each clip's level from ``generator``
        (or takes ``levels (B,)``), gives the dropout rows depths drawn in
        [1, Nq] (or ``depths``), adds the masked ``commitment_loss`` and
        ``codebook_loss`` and keeps the importance rows of ``imp_map``
        (``DAC_MOE``'s router: ``imp_map (B, Nq, T)``). With ``rows =
        (offset, total)`` z holds those rows of a train batch of ``total``:
        the levels, depths and partition are that batch's, and this forward
        keeps its rows of each."""
        bs, _, frames = z.shape
        vbr = n_quantizers is None
        if train and not vbr:
            raise ValueError("train mode is VBR only (n_quantizers=None)")
        if vbr and not train and level is None:
            raise ValueError("level must be specified in VBR inference")
        n_stages = self.n_stages(n_quantizers)
        offset, total = (0, bs) if rows is None else rows
        if train and (levels is None or (
                depths is None and self.partition(total)[1] > 0)):
            drawn = self.draws(total, generator, z.device)
            levels = drawn["levels"] if levels is None else levels
            depths = drawn["depths"] if depths is None else depths

        residual = z
        z_q_is, codes, latents, commits, cbs = [], [], [], [], []
        for quantizer in self.quantizers[:n_stages]:
            z_q_i, indices_i, z_e_i, *stage_losses = quantizer(residual, train)
            z_q_is.append(z_q_i)
            residual = residual - z_q_i
            codes.append(indices_i)
            latents.append(z_e_i)
            if train:
                commits.append(stage_losses[0])
                cbs.append(stage_losses[1])

        if vbr:
            imp_map = self.importance(feat_enc, frames)
            if train:
                scale = torch.as_tensor(levels, device=z.device).reshape(
                    -1)[offset:offset + bs].reshape(bs, 1, 1).to(z)
            else:
                scale = level
            mask_imp = self.gate(imp_map * scale * self.n_codebooks)
        else:
            # all-ones mask over the stages run (CBR inside the VBR model)
            imp_map = None
            mask_imp = torch.ones((bs, n_stages, frames), dtype=z.dtype,
                                  device=z.device)

        n_imps = bs
        if train:
            (n_imps, _), (n_dropout, first), (n_full, _) = local_parts(
                self.partition(total), rows, bs)
            parts = [mask_imp[:n_imps]]
            if n_dropout > 0:
                depths = torch.as_tensor(depths, device=z.device).reshape(
                    -1)[first:first + n_dropout].to(z.dtype)
                parts.append(generate_mask_hard(
                    depths.reshape(n_dropout, 1, 1).expand(n_dropout, 1, frames),
                    self.n_codebooks))
            if n_full > 0:
                parts.append(torch.ones((n_full, self.n_codebooks, frames),
                                        dtype=z.dtype, device=z.device))
            mask_imp = torch.cat(parts, dim=0)

        z_q_is = torch.stack(z_q_is, dim=1)
        out = {
            "z_q": torch.sum(z_q_is * mask_imp[:, :, None, :], dim=1),
            "z_q_is": z_q_is,
            "codes": torch.stack(codes, dim=1),
            "latents": torch.cat(latents, dim=1),
            "imp_map": imp_map[:n_imps] if imp_map is not None else None,
            "mask_imp": mask_imp,
        }
        if train:
            mask_sg = mask_imp.detach()
            out["commitment_loss"] = torch.mean(
                torch.sum(torch.stack(commits, dim=1) * mask_sg, dim=1))
            out["codebook_loss"] = torch.mean(
                torch.sum(torch.stack(cbs, dim=1) * mask_sg, dim=1))
        return out


class VBRResidualVectorQuantize(GatedResidualVectorQuantize):
    """The VBR quantizer: a conv importance subnet gives one score per frame
    (B, 1, T), whose scaled value sets how many stages the frame keeps (a
    prefix of them). ``detach_imp_map_input`` stops the importance subnet's
    gradient at its input, so the encoder gets none through it."""

    def __init__(self, input_dim: int, n_codebooks: int, codebook_size: int,
                 codebook_dim: Union[int, Sequence[int]],
                 detach_imp_map_input: bool = False, **gated):
        super().__init__(input_dim, n_codebooks, codebook_size, codebook_dim,
                         **gated)
        self.imp_subnet = ImportanceSubnet(input_dim, input_dim,
                                           detach_input=detach_imp_map_input)

    def importance(self, feat_enc: torch.Tensor, frames: int) -> torch.Tensor:
        """Importance map (B, 1, frames)."""
        return self.crop(self.imp_subnet(feat_enc), frames)

    def gate(self, scaled: torch.Tensor) -> torch.Tensor:
        return generate_mask_ste(scaled, self.n_codebooks,
                                 alpha=self.imp2mask_alpha)
