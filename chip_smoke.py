#!/usr/bin/env python3
"""Drive vrvq_tpu_torch, the PyTorch + CUDA port, on one NVIDIA card.

Run from the repo root with no arguments: ``python3 chip_smoke.py``. It builds
the kernels (one ``nvcc`` call), then runs four phases and prints one line
for each:

  device   the card's name and power limit, torch and CUDA versions, TF32 off,
           the kernel build time;
  kernels  each kernel against its plain PyTorch version on the same inputs
           at the flagship's shapes: the error, the kernel's and the plain
           version's times (CUDA events) and the card's lower bound;
  serve    the flagship DAC_VRVQ (random seeded weights, 81.56M parameters)
           compresses a seeded 10 s 44.1 kHz clip in VBR through the chunked
           padding-free path with the fused-RVQ kernel, round-trips the .dac
           file and decompresses it; the kernels' launch counts of this run;
  agree    on a 3 s clip, three 1 s windows of the same chunked path: the
           kernel path against the port's plain path (code flips only on
           near-tie frames, identical masks, SI-SDR of the kernel decode
           against the plain decode of the same .dac), and the Snake kernel
           against its plain version at every shape the serve run gave it.

Then a JSON line of the kernels at the main path's shapes, the card's ``nvidia-smi`` line, and as the
last line ``{"ok": true, "device": {...}}``. Any failed check raises and the
script exits non-zero; without CUDA it exits non-zero at once.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
FLAGSHIP_PARAMS = 81_559_668  # the JAX DAC_VRVQ at the flagship config
SNAKE_SHAPES = [(1, 96, 441344), (1, 1536, 862)]  # decoder tail, decoder head
SNAKE_TOL = 1e-6
RVQ_FRAMES = 862  # latent frames of a 10 s clip at 44.1 kHz, hop 512
WINDOW_S = 1.0  # the serve phase's padding-free window
AGREE_CLIP_S = 3.0  # longer than the window: the chunked path
ZQ_ATOL = 1e-4
TIE_MARGIN = 1e-5
MIN_SISDR_DB = 60.0


def phase(name: str, **fields) -> None:
    print(f"{name} " + json.dumps(fields), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn`` on the card, by CUDA events, after a warm-up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, n_flops: float) -> dict:
    """Least time on an H100 SXM at its data-sheet rates: the larger of the
    bytes over the memory rate and the f32 operations over the f32 rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "flops_ms": t_ops}


def si_sdr(estimate: np.ndarray, reference: np.ndarray) -> float:
    est = estimate.astype(np.float64).ravel()
    ref = reference.astype(np.float64).ravel()
    target = (np.dot(est, ref) / np.dot(ref, ref)) * ref
    noise = est - target
    return float(10.0 * np.log10(np.dot(target, target) / max(np.dot(noise, noise), 1e-300)))


def device_phase(port, build):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    port.disable_tf32()
    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0
    ptxas = build.library_path(build.find_nvcc()).with_suffix(".log")
    registers = [ln.strip() for ln in ptxas.read_text().splitlines()
                 if "registers" in ln] if ptxas.exists() else []
    phase("device", nvidia_smi=smi, torch=torch.__version__,
          cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
          matmul_tf32=torch.backends.cuda.matmul.allow_tf32,
          cudnn_tf32=torch.backends.cudnn.allow_tf32,
          build_s=build_s, ptxas=registers)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    return smi


def snake_check(shape, gen, timed: bool = True):
    from vrvq_tpu_torch.ops.snake import snake, snake_reference

    x = (3.0 * torch.randn(shape, generator=gen)).to(DEVICE)
    alpha = (0.5 + torch.rand(shape[1], generator=gen)).to(DEVICE)
    y = snake(x, alpha)
    ref = snake_reference(x, alpha)
    torch.cuda.synchronize()
    err = (y - ref).abs().max().item()
    assert torch.allclose(y, ref, atol=SNAKE_TOL, rtol=SNAKE_TOL), (shape, err)
    if not timed:
        return {"shape": list(shape), "max_abs_err": err}
    n = x.numel()
    return {
        "shape": list(shape), "max_abs_err": err,
        "ms": cuda_ms(lambda: snake(x, alpha)),
        "plain_ms": cuda_ms(lambda: snake_reference(x, alpha)),
        # x read, alpha read, y written; ~5 operations and a sin per element
        **bound(4.0 * (2 * n + shape[1]), 5.0 * n),
    }


def rvq_check(weights, gen, frames: int):
    from vrvq_tpu_torch.ops.rvq_kernel import (
        fused_rvq_prepared, fused_rvq_reference, prepare_rvq,
        reference_margins)

    # as the main path calls it: weights prepared once, then the launch
    prepared = prepare_rvq(weights)
    n_q, d_model, d_code = weights.wi.shape
    k = weights.cb.shape[1]
    z = torch.randn(frames, d_model, generator=gen).to(DEVICE)
    mask = (torch.rand(frames, n_q, generator=gen) > 0.5).float().to(DEVICE)
    margins = reference_margins(z, *weights)
    near_tie = margins <= TIE_MARGIN
    out = {"frames": frames, "near_tie_frames": int(near_tie.sum())}
    for mode, m in [("vbr", mask), ("cbr", None)]:
        zq, codes = fused_rvq_prepared(z, prepared, m)
        rzq, rcodes = fused_rvq_reference(z, *weights, m)
        torch.cuda.synchronize()
        agree = (codes == rcodes).all(dim=1)
        flipped = ~agree
        assert not (flipped & ~near_tie).any(), f"{mode}: codes differ off ties"
        err = (zq - rzq)[agree].abs().max().item()
        assert torch.allclose(zq[agree], rzq[agree], atol=ZQ_ATOL, rtol=0), err
        out[f"{mode}_flipped_frames"] = int(flipped.sum())
        out[f"{mode}_max_abs_err"] = err
    w_bytes = sum(t.numel() for t in weights) * 4
    io_bytes = frames * (2 * d_model + 2 * n_q) * 4  # z, z_q, mask, codes
    flops = frames * n_q * (2 * d_model * d_code + 2 * k * d_code
                                + 2 * d_code * d_model)
    out.update(
        ms=cuda_ms(lambda: fused_rvq_prepared(z, prepared, mask)),
        plain_ms=cuda_ms(lambda: fused_rvq_reference(z, *weights, mask)),
        max_abs_err=max(out["vbr_max_abs_err"], out["cbr_max_abs_err"]),
        **bound(w_bytes + io_bytes, flops),
    )
    return out


def serve_phase(port, build, model):
    from vrvq_tpu_torch.nn.layers import Snake1d

    sr = model.sample_rate
    clip = port.synthetic_clip(10.0, sr, SEED)
    signal = port.Signal(clip, sr)
    proc = port.CodecProcessor(model, fused_quantizer=True)

    def round_trip(tmp):
        t0 = time.perf_counter()
        dac = proc.compress(signal, win_duration=WINDOW_S, level=1.0)
        t1 = time.perf_counter()
        path = dac.save(Path(tmp) / "clip.dac")
        loaded = port.DACFile.load(path)
        t2 = time.perf_counter()
        out = proc.decompress(loaded)
        t3 = time.perf_counter()
        return dac, path.stat().st_size, out, t1 - t0, t3 - t2

    # the warm-up also records every shape the path hands the Snake kernel
    snake_shapes = set()
    hooks = [m.register_forward_pre_hook(
                 lambda _, args: snake_shapes.add(tuple(args[0].shape)))
             for m in proc.model_nopad.modules()
             if isinstance(m, Snake1d)]
    with tempfile.TemporaryDirectory() as tmp:
        round_trip(tmp)  # warm-up: cuBLAS/cuDNN handles, allocator
        for h in hooks:
            h.remove()
        build.LAUNCHES.clear()
        dac, size, out, enc_s, dec_s = round_trip(tmp)
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)

    audio = out.audio_data
    assert dac.padding is False and dac.vbr_counts is not None
    assert audio.shape == (1, 1, clip.shape[-1]), audio.shape
    # float32 samples times the float64 loudness gain, as in the JAX package
    assert audio.dtype == np.float64, audio.dtype
    assert np.isfinite(audio).all()
    assert launches.get("snake", 0) > 0 and launches.get("rvq", 0) > 0, launches

    kept = {}
    for level in (0.5, 2.0):
        kept[level] = float(proc.compress(signal, win_duration=WINDOW_S,
                                          level=level).vbr_counts.mean())
    assert kept[2.0] > kept[0.5], kept

    seconds = clip.shape[-1] / sr
    phase("serve", params=sum(p.numel() for p in model.parameters()),
          clip_s=seconds, windows=int(dac.codes.shape[-1] // dac.chunk_length),
          frames=int(dac.codes.shape[-1]), dac_bytes=size,
          mean_kept_codebooks=float(dac.vbr_counts.mean()),
          mean_kept_at_level={str(k): v for k, v in kept.items()},
          encode_s=enc_s, decode_s=dec_s, encode_rtf=seconds / enc_s,
          decode_rtf=seconds / dec_s, launches=launches,
          snake_shapes=len(snake_shapes))
    return launches, sorted(snake_shapes)


def agree_phase(port, model, snake_shapes, gen):
    from vrvq_tpu_torch.ops.rvq_kernel import (
        reference_margins, stack_quantizer_weights)

    sr = model.sample_rate
    signal = port.Signal(port.synthetic_clip(AGREE_CLIP_S, sr, SEED + 1), sr)
    plain = model.clone(padding=True).use_kernels(False)
    with torch.inference_mode():
        weights = stack_quantizer_weights(plain.quantizer)

    class PlainProcessor(port.CodecProcessor):
        """The plain path, which also keeps each window's smallest top-2
        score margin per frame over the quantizer's stages."""

        margins = []

        def _encode(self, variant, audio, n_quantizers, level, rvq=None):
            z = variant.encoder(audio)
            b, d, t = z.shape
            frames = z.transpose(1, 2).reshape(b * t, d)
            self.margins.append(
                reference_margins(frames, *weights).reshape(b, t).cpu().numpy())
            return super()._encode(variant, audio, n_quantizers, level, rvq)

    kernel_proc = port.CodecProcessor(model, fused_quantizer=True)
    plain_proc = PlainProcessor(plain, fused_quantizer=False)
    fused = kernel_proc.compress(signal, win_duration=WINDOW_S, level=1.0)
    ref = plain_proc.compress(signal, win_duration=WINDOW_S, level=1.0)
    assert fused.padding is False and ref.padding is False
    windows = int(fused.codes.shape[-1] // fused.chunk_length)
    assert windows > 1, windows

    flipped = (fused.codes != ref.codes).any(axis=1)  # (B, frames)
    near_tie = np.concatenate(plain_proc.margins, axis=-1) <= TIE_MARGIN
    assert flipped.shape == near_tie.shape, (flipped.shape, near_tie.shape)
    assert not (flipped & ~near_tie).any(), "codes differ off near ties"
    mask_agree = float((fused.vbr_counts == ref.vbr_counts).mean())
    assert mask_agree == 1.0, mask_agree

    # the padding-free decode of the same .dac, kernel against plain
    kernel_audio = kernel_proc.decompress(fused).audio_data
    plain_audio = plain_proc.decompress(fused).audio_data
    sdr = si_sdr(kernel_audio, plain_audio)
    assert sdr >= MIN_SISDR_DB, sdr

    # Snake at every shape the serve run gave it; the largest is timed
    largest = max(snake_shapes, key=np.prod)
    with torch.inference_mode():
        checks = [snake_check(s, gen, timed=s == largest) for s in snake_shapes]
    snake_window = next(c for c in checks if c["shape"] == list(largest))
    snake_window["max_abs_err"] = max(c["max_abs_err"] for c in checks)

    phase("agree", windows=windows, frames=int(fused.codes.shape[-1]),
          code_flip_rate=float((fused.codes != ref.codes).mean()),
          flipped_frames=int(flipped.sum()), near_tie_frames=int(near_tie.sum()),
          mask_agreement=mask_agree, decode_si_sdr_db=sdr,
          max_abs_diff=float(np.abs(kernel_audio - plain_audio).max()),
          snake_shapes=len(checks), snake_window=snake_window)
    return snake_window


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 1
    import vrvq_tpu_torch as port
    from vrvq_tpu_torch.kernels import build
    from vrvq_tpu_torch.ops.rvq_kernel import stack_quantizer_weights

    smi = device_phase(port, build)

    model = port.build_model(port.FLAGSHIP, device=DEVICE, seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == FLAGSHIP_PARAMS, n_params

    gen = torch.Generator().manual_seed(SEED)
    with torch.inference_mode():
        snakes = [snake_check(s, gen) for s in SNAKE_SHAPES]
        weights = stack_quantizer_weights(model.quantizer)
        rvq = rvq_check(weights, gen, RVQ_FRAMES)
        # the frames of one serve window, as the chunked main path calls K1
        window_frames = port.CodecProcessor(model).window_geometry(WINDOW_S)[2]
        rvq_window = rvq_check(weights, gen, window_frames)
    phase("kernels", snake=snakes, rvq=rvq, rvq_window=rvq_window)

    launches, snake_shapes = serve_phase(port, build, model)
    snake_window = agree_phase(port, model, snake_shapes, gen)

    # each kernel at the largest shape the chunked main path gives it
    kernels = [
        {"name": "snake", "route": "cuda",
         "source": "vrvq_tpu_torch/kernels/csrc/snake.cu",
         "replaces": "vrvq_tpu/ops/snake.py:33",
         "launches": launches["snake"],
         "max_abs_err": snake_window["max_abs_err"],
         "ms": snake_window["ms"], "plain_ms": snake_window["plain_ms"],
         "bound_ms": snake_window["bound_ms"],
         "bound_by": snake_window["bound_by"],
         "library_ms": None, "shape": snake_window["shape"]},
        {"name": "fused_rvq", "route": "cuda",
         "source": "vrvq_tpu_torch/kernels/csrc/rvq.cu",
         "replaces": "vrvq_tpu/ops/rvq_kernel.py:130",
         "launches": launches["rvq"], "max_abs_err": rvq_window["max_abs_err"],
         "ms": rvq_window["ms"], "plain_ms": rvq_window["plain_ms"],
         "bound_ms": rvq_window["bound_ms"], "bound_by": rvq_window["bound_by"],
         "library_ms": None, "frames": rvq_window["frames"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
