"""The comparison that decides ``correct``, and the reference's precisions.

Each cell's driver hands the program's answers (and the inputs it made)
here once the window has closed and the program is freed; the reference
recomputes what it needs in blocks and the numbers go to ``Run.check``
against the cell's limits (``checks/<cell>.json``).

``precision(mode)`` is the arithmetic the reference runs in: ``exact``
(float32, TF32 off: the configurations' precision), ``tf32`` (TF32 on, the
control of a float32 stack) and ``fp8`` (each conv's input, weight and
output rounded to float8 e4m3 with a per-tensor scale, so that every
activation the stack keeps is fp8: the control of a bfloat16 stack)."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .reference import codec as ref_codec


@contextlib.contextmanager
def precision(mode: str):
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = cuda.allow_tf32, cudnn.allow_tf32
    cuda.allow_tf32 = cudnn.allow_tf32 = mode == "tf32"
    try:
        yield
    finally:
        cuda.allow_tf32, cudnn.allow_tf32 = saved


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale, back in its
    dtype."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


def emulate_fp8(module: torch.nn.Module, on: bool) -> None:
    """Round every conv's input, weight and output of ``module`` to fp8
    (or not)."""
    for m in module.modules():
        if isinstance(m, ref_codec.WNConv):
            m.round = fp8 if on else None


def rng(seed: int, stream: int) -> np.random.Generator:
    """The benchmark's host generator of ``seed``'s stream ``stream``."""
    return np.random.default_rng([int(seed) % (2 ** 63), stream])


def code_mismatch(codes_p, counts_p, codes_r, counts_r) -> np.ndarray:
    """Per row: the share of (stage, frame) entries on which the program
    and the reference disagree: one keeps the stage and the other not, or
    both keep it with another code. codes (B, Nq, F), counts (B, F)."""
    codes_p, codes_r = np.asarray(codes_p, np.int64), np.asarray(codes_r, np.int64)
    counts_p, counts_r = np.asarray(counts_p, np.int64), np.asarray(counts_r, np.int64)
    stage = np.arange(codes_p.shape[1])[None, :, None]
    keep_p, keep_r = stage < counts_p[:, None, :], stage < counts_r[:, None, :]
    differ = (keep_p != keep_r) | (keep_p & keep_r & (codes_p != codes_r))
    return differ.reshape(len(differ), -1).mean(axis=1)


def rel_err(x, ref) -> np.ndarray:
    """Per row: ||x - ref|| / ||ref||."""
    x = np.asarray(x, np.float64).reshape(len(x), -1)
    ref = np.asarray(ref, np.float64).reshape(len(ref), -1)
    return np.linalg.norm(x - ref, axis=1) / np.maximum(np.linalg.norm(ref, axis=1), 1e-30)


def reference_codec(keys: dict, seed: int, device, padding: bool = True):
    """The reference codec with the cell's weights, drawn again from the
    seed."""
    from .weights import draw

    model = ref_codec.Codec(keys, padding=padding).to(device)
    return draw(model, seed).eval()
