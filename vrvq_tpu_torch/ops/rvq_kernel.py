"""Fused residual vector quantization: all Nq stages in one kernel.

Counterpart of ``vrvq_tpu/ops/rvq_kernel.py``. ``fused_rvq`` launches the CUDA
kernel (``kernels/csrc/rvq.cu``, the port of the Pallas ``_rvq_kernel``) for
tensors on the card and runs ``fused_rvq_reference`` for tensors on the CPU.
The kernel keeps the residual on chip across the stages and reads the
winning codebook row instead of the TPU kernel's one-hot matmul.

Inputs are the effective (weight-norm-resolved) projection weights, see
``stack_quantizer_weights``. Frames are rows: ``z (F, D)``. The kernel runs
one cluster of ``cs`` CTAs per tile of frames, CTA r owning a 1/cs slice of
the channels and of the codes; it reads, per stage and CTA, one contiguous
block of wi^T, wo, bo, the normalized codebook^T, its squared norms, the
codebook and bi (``pack_rvq``). ``prepare_rvq`` packs them once for callers
that quantize many windows with the same weights (``quantize_fused``), and
``fused_rvq`` on every call.

Any codebook_dim from 1 to ``MAX_CODEBOOK_DIM`` and any D and K: the packing
pads d to the next power of two (the widths the kernel is built for), and D
and K to ``cs`` slices of a multiple of 4 floats, with zero components and
channels and with codes that can never win (``padded_dims``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..kernels import check, library
from ..utils import count


class RVQWeights(NamedTuple):
    wi: torch.Tensor  # (Nq, D, d)
    bi: torch.Tensor  # (Nq, d)
    wo: torch.Tensor  # (Nq, d, D)
    bo: torch.Tensor  # (Nq, D)
    cb: torch.Tensor  # (Nq, K, d)


def check_uniform_widths(quantizer) -> list:
    """The quantizer's stages, if they share one codebook width; else
    ``ValueError`` naming the widths."""
    stages = list(quantizer.quantizers)
    widths = [q.codebook.shape[1] for q in stages]
    if len(set(widths)) > 1:
        raise ValueError(
            f"the fused quantizer takes one codebook width for every stage; "
            f"this quantizer's are {widths}: serve it with "
            f"fused_quantizer=False")
    return stages


def stack_quantizer_weights(quantizer) -> RVQWeights:
    """Resolve weight norm and stack every stage's projections and codebook.

    ``quantizer``: a ``VBRResidualVectorQuantize`` or the CBR quantizer (its
    ``quantizers``). Stages of different codebook widths do not stack (the
    JAX package's ``jnp.stack`` fails there too): ``ValueError``."""
    stages = check_uniform_widths(quantizer)
    return RVQWeights(
        torch.stack([q.in_proj.weight() for q in stages]),
        torch.stack([q.in_proj.bias for q in stages]),
        torch.stack([q.out_proj.weight() for q in stages]),
        torch.stack([q.out_proj.bias for q in stages]),
        torch.stack([q.codebook for q in stages]),
    )


class PreparedRVQ(NamedTuple):
    """``RVQWeights`` with the kernel's packed operand."""

    weights: RVQWeights
    cluster: int  # CTAs per cluster
    packed: torch.Tensor  # (Nq, cluster, stage floats)


CLUSTER_SIZES = (8, 4, 2, 1)  # portable sizes, largest first
MAX_CODEBOOK_DIM = 32  # the widest d the kernel is built for
SLICE_CAP = 128  # channels or codes of one CTA above which a larger cluster pads


def cluster_size(d_model: int, k: int) -> int:
    """CTAs per cluster: the largest size that splits the D channels and the
    K codes into slices of a multiple of 4 floats (16-byte copies), raised,
    where that leaves a slice wider than ``SLICE_CAP`` (shared memory grows
    with it), to the smallest size whose padded slices are no wider."""
    exact = next((cs for cs in CLUSTER_SIZES
                  if d_model % (4 * cs) == 0 and k % (4 * cs) == 0), 0)
    narrow = next((cs for cs in reversed(CLUSTER_SIZES)
                   if max(-(-d_model // cs), -(-k // cs)) <= SLICE_CAP),
                  CLUSTER_SIZES[0])
    return max(exact, narrow)


def padded_dims(d_model: int, k: int, d_code: int, cs: int) -> Tuple[int, int, int]:
    """(Dp, Kp, dp): D and K padded to ``cs`` slices of a multiple of 4, and
    d to the next power of two."""
    def slices(n):
        return cs * 4 * -(-n // (4 * cs))
    return slices(d_model), slices(k), 1 << (d_code - 1).bit_length()


def pack_rvq(weights: RVQWeights, cn: torch.Tensor, cn2: torch.Tensor,
             cs: int) -> torch.Tensor:
    """(Nq, cs, floats): for stage s and CTA r, one contiguous block of
    wi^T[:, rDp/cs:(r+1)Dp/cs] (dp, Dp/cs), wo[:, same] (dp, Dp/cs), bo[same],
    cn^T[:, rKp/cs:(r+1)Kp/cs] (dp, Kp/cs), cn2[same], cb[same] (Kp/cs, dp),
    bi, then zeros to a multiple of 4 floats. ``cn`` is the normalized
    codebook (Nq, K, d), ``cn2`` its squared norms (Nq, K). Padding
    (``padded_dims``): zeros everywhere, except a padded code's ``cn2``,
    which is +inf so that it never wins."""
    n_q, d_model, d_code = weights.wi.shape
    k = weights.cb.shape[1]
    dp_model, kp, dp = padded_dims(d_model, k, d_code, cs)
    dc, kc = dp_model // cs, kp // cs

    def pad(t, *widths, value=0.0):  # zeros (or value) after each trailing axis
        spec = [p for w, n in zip(reversed(widths), reversed(t.shape[1:]))
                for p in (0, w - n)]
        return torch.nn.functional.pad(t, spec, value=value)

    def by_rank(t, width):  # (Nq, dp, cs * width) -> (Nq, cs, dp * width)
        return t.reshape(n_q, dp, cs, width).transpose(1, 2).reshape(
            n_q, cs, dp * width)

    blocks = [
        by_rank(pad(weights.wi.transpose(1, 2), dp, dp_model), dc),
        by_rank(pad(weights.wo, dp, dp_model), dc),
        pad(weights.bo, dp_model).reshape(n_q, cs, dc),
        by_rank(pad(cn.transpose(1, 2), dp, kp), kc),
        pad(cn2, kp, value=float("inf")).reshape(n_q, cs, kc),
        pad(weights.cb, kp, dp).reshape(n_q, cs, kc * dp),
        pad(weights.bi, dp)[:, None, :].expand(n_q, cs, dp),
    ]
    floats = sum(b.shape[2] for b in blocks)
    blocks.append(weights.wi.new_zeros(n_q, cs, -floats % 4))
    return torch.cat(blocks, dim=2).contiguous()


def prepare_rvq(weights: RVQWeights) -> PreparedRVQ:
    """Weight preparation for the kernel, so that it scores exactly as the
    plain version does: the codebook normalized and its squared norms taken
    with the plain version's expressions on the unpadded codebook, then
    padded and packed by CTA."""
    weights = RVQWeights(*(t.contiguous() for t in weights))
    cs = cluster_size(weights.wi.shape[1], weights.cb.shape[1])
    cn = _normalize(weights.cb)
    return PreparedRVQ(weights, cs,
                       pack_rvq(weights, cn, torch.sum(cn * cn, dim=2), cs))


def _normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    n = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp(n, min=eps)


def _stages(z, wi, bi, wo, bo, cb):
    """The plain residual loop: yields each stage's scores ``-dist (F, K)``,
    codes ``(F,)`` and out_proj output ``(F, D)``."""
    residual = z.float()
    for i in range(wi.shape[0]):
        e = residual @ wi[i] + bi[i]
        en = _normalize(e)
        cn = _normalize(cb[i])
        dist = (
            torch.sum(en * en, dim=1, keepdim=True)
            - 2.0 * (en @ cn.T)
            + torch.sum(cn * cn, dim=1, keepdim=True).T
        )
        idx = torch.argmax(-dist, dim=1)  # first max on ties
        # the module path's straight-through arithmetic, which is not
        # out_proj(zq) in floating point
        zq_e = e + (cb[i][idx] - e)
        out = zq_e @ wo[i] + bo[i]
        residual = residual - out
        yield -dist, idx, out


def fused_rvq_reference(z, wi, bi, wo, bo, cb, mask=None):
    """Plain version of the fused kernel. z (F, D); mask (F, Nq) or None.
    Returns (z_q (F, D), codes (F, Nq) int32)."""
    z_q = torch.zeros_like(z, dtype=torch.float32)
    codes = []
    for i, (_, idx, out) in enumerate(_stages(z, wi, bi, wo, bo, cb)):
        codes.append(idx)
        if mask is not None:
            out = out * mask[:, i:i + 1]
        z_q = z_q + out
    return z_q.to(z.dtype), torch.stack(codes, dim=1).to(torch.int32)


def reference_margins(z, wi, bi, wo, bo, cb) -> torch.Tensor:
    """Smallest top-2 score margin of each frame over the stages of the plain
    version (F,): frames whose margin is tiny may take another code under
    another summation order."""
    margin = torch.full((z.shape[0],), float("inf"), device=z.device)
    for scores, _, _ in _stages(z, wi, bi, wo, bo, cb):
        top = torch.topk(scores, 2, dim=1).values
        margin = torch.minimum(margin, top[:, 0] - top[:, 1])
    return margin


def fused_rvq(
    z: torch.Tensor,
    wi: torch.Tensor,
    bi: torch.Tensor,
    wo: torch.Tensor,
    bo: torch.Tensor,
    cb: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused RVQ with optional VBR gating.

    z (F, D) frames; mask (F, Nq) stage gate (1 = keep) or None for all
    stages. Returns (z_q (F, D), codes (F, Nq) int32). The kernel has no
    backward: an input that requires grad under grad mode raises."""
    _check_no_grad(z, wi, bi, wo, bo, cb, mask)
    if z.device.type == "cpu":
        return fused_rvq_reference(z, wi, bi, wo, bo, cb, mask)
    if z.device.type != "cuda":
        raise ValueError(f"fused_rvq: unsupported device {z.device}")
    weights = RVQWeights(wi, bi, wo, bo, cb)
    _check(z, weights, mask)
    return fused_rvq_prepared(z, prepare_rvq(weights), mask)


def _check_no_grad(*tensors) -> None:
    """Raise where a gradient would be wanted: the kernel has none, and the
    training path runs the per-stage module quantizer instead."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            "fused_rvq: the kernel has no backward; call it under "
            "torch.no_grad() or torch.inference_mode() (training runs the "
            "module quantizer)")


def _check(z, weights: RVQWeights, mask) -> None:
    n_q, d_model, d_code = weights.wi.shape
    k = weights.cb.shape[1]
    f = z.shape[0]
    expected = {
        "z": (z, (f, d_model)), "wi": (weights.wi, (n_q, d_model, d_code)),
        "bi": (weights.bi, (n_q, d_code)), "wo": (weights.wo, (n_q, d_code, d_model)),
        "bo": (weights.bo, (n_q, d_model)), "cb": (weights.cb, (n_q, k, d_code)),
    }
    if mask is not None:
        expected["mask"] = (mask, (f, n_q))
    for name, (t, shape) in expected.items():
        if t.device != z.device:
            raise ValueError(f"fused_rvq: {name} is on {t.device}, z on {z.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"fused_rvq: {name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(
                f"fused_rvq: {name} has shape {tuple(t.shape)}, expected {shape}"
            )
    if not 1 <= d_code <= MAX_CODEBOOK_DIM:
        raise ValueError(
            f"fused_rvq: codebook_dim {d_code} not in [1, {MAX_CODEBOOK_DIM}]")


def fused_rvq_prepared(
    z: torch.Tensor, prepared: PreparedRVQ, mask: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fused_rvq`` on weights that ``prepare_rvq`` has prepared."""
    w = prepared.weights
    _check_no_grad(z, prepared.packed, mask, *w)
    if z.device.type == "cpu":
        return fused_rvq_reference(z, *w, mask)
    if z.device.type != "cuda":
        raise ValueError(f"fused_rvq: unsupported device {z.device}")
    _check(z, w, mask)
    n_q, d_model, d_code = w.wi.shape
    k = w.cb.shape[1]
    f = z.shape[0]
    cs = prepared.cluster
    dp_model, kp, dp = padded_dims(d_model, k, d_code, cs)
    lib = library()
    floats = lib.vrvq_rvq_stage_floats(dp_model, kp, dp, cs)
    if tuple(prepared.packed.shape) != (n_q, cs, floats):
        raise ValueError(
            f"fused_rvq: packed weights {tuple(prepared.packed.shape)}, the "
            f"kernel reads {(n_q, cs, floats)}")
    smem = lib.vrvq_rvq_smem_bytes(dp_model, kp, dp, n_q, cs)
    limit = getattr(torch.cuda.get_device_properties(z.device),
                    "shared_memory_per_block_optin", None)
    if limit is not None and smem > limit:
        raise ValueError(
            f"fused_rvq: needs {smem} B of shared memory per CTA, the card "
            f"allows {limit} (D={d_model}, K={k}, d={d_code}, Nq={n_q}, "
            f"cluster {cs})"
        )
    z = z.contiguous()
    if z.data_ptr() % 16:  # the kernel reads z in float4s
        z = z.clone()
    mask = mask.contiguous() if mask is not None else None
    z_q = torch.empty_like(z)
    codes = torch.empty((f, n_q), dtype=torch.int32, device=z.device)
    if f == 0:
        return z_q, codes
    # the runtime launches on (and raises the shared-memory limit of) the
    # current card: make it z's
    with torch.cuda.device(z.device):
        err = lib.vrvq_rvq_forward(
            z.data_ptr(), prepared.packed.data_ptr(),
            mask.data_ptr() if mask is not None else None,
            z_q.data_ptr(), codes.data_ptr(), f, d_model, dp_model, n_q, kp, dp,
            cs,
            torch.cuda.current_stream(z.device).cuda_stream,
        )
    count("launches.rvq")
    check(err, "fused_rvq")
    return z_q, codes


def quantize_fused(prepared: PreparedRVQ, z_bdt: torch.Tensor,
                   mask_bnt: Optional[torch.Tensor] = None):
    """(B, D, T) latents (+ (B, Nq, T) mask) through ``fused_rvq_prepared``.
    Returns (z_q (B, D, T), codes (B, Nq, T))."""
    b, d, t = z_bdt.shape
    n_q = prepared.weights.wi.shape[0]
    z = z_bdt.transpose(1, 2).reshape(b * t, d)
    mask = None
    if mask_bnt is not None:
        mask = mask_bnt.transpose(1, 2).reshape(b * t, n_q)
    z_q, codes = fused_rvq_prepared(z, prepared, mask)
    return (
        z_q.reshape(b, t, d).transpose(1, 2),
        codes.reshape(b, t, n_q).transpose(1, 2),
    )
