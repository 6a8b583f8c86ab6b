#!/usr/bin/env python3
"""Drive vrvq_tpu_torch, the PyTorch + CUDA port, on one NVIDIA card.

Run from the repo root with no arguments: ``python3 chip_smoke.py``. It builds
the kernels (one ``nvcc`` call), then runs four phases and prints one line
for each:

  device   the card's name and power limit, torch and CUDA versions, TF32 off,
           the kernel build time;
  kernels  each kernel against its plain PyTorch version on the same inputs
           at the flagship's shapes (K1 also at 28 stages, the 24 kbps
           size): the error, the kernel's and the plain version's device
           times and the card's lower bound;
  serve    the flagship DAC_VRVQ (random seeded weights, 81.56M parameters)
           compresses a seeded 10 s 44.1 kHz clip in VBR through the chunked
           padding-free path with the fused-RVQ kernel, round-trips the .dac
           file and decompresses it; the kernels' launch counts of this run
           and the census of the Snake kernel's shapes (shape -> launches);
  agree    on a 3 s clip, three 1 s windows of the same chunked path: the
           kernel path against the port's plain path (code flips only on
           near-tie frames, identical masks, SI-SDR of the kernel decode
           against the plain decode of the same .dac), and the Snake kernel
           against its plain version, timed, at every shape of the census.

Times are device times with a cold L2 (``vrvq_tpu_torch.kernel_times``: a
CUDA graph of launches, each after a copy that evicts the L2 cache, less the
graph of copies alone), taken on the inputs that the kernel was compared on.
Then a JSON line of the kernels on
the main path (K2 summed over the census, each shape weighted by its
launches; K1 at one window's 72 frames), the card's ``nvidia-smi`` line, and
as the last line ``{"ok": true, "device": {...}}``. Any failed check raises
and the script exits non-zero; without CUDA it exits non-zero at once.
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

import vrvq_tpu_torch as port
from vrvq_tpu_torch import kernel_times as kt
from vrvq_tpu_torch.kernels import build
from vrvq_tpu_torch.models.quantize import VBRResidualVectorQuantize
from vrvq_tpu_torch.ops import rvq_kernel as rvq_ops
from vrvq_tpu_torch.ops import snake as snake_ops

SEED = 0
DEVICE = "cuda"
FLAGSHIP_PARAMS = 81_559_668  # the JAX DAC_VRVQ at the flagship config
SNAKE_TOL = 1e-6
RVQ_FRAMES = 862  # latent frames of a 10 s clip at 44.1 kHz, hop 512
NQ_24KBPS = 28  # conf/base_24kbps.yml: the most stages a config asks for
WINDOW_S = 1.0  # the serve phase's padding-free window
AGREE_CLIP_S = 3.0  # longer than the window: the chunked path
ZQ_ATOL = 1e-4
TIE_MARGIN = kt.TIE_MARGIN
MIN_SISDR_DB = 60.0


def phase(name: str, **fields) -> None:
    print(f"{name} " + json.dumps(fields), flush=True)


def si_sdr(estimate: np.ndarray, reference: np.ndarray) -> float:
    est = estimate.astype(np.float64).ravel()
    ref = reference.astype(np.float64).ravel()
    target = (np.dot(est, ref) / np.dot(ref, ref)) * ref
    noise = est - target
    return float(10.0 * np.log10(np.dot(target, target) / max(np.dot(noise, noise), 1e-300)))


def device_phase():
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


def snake_check(shape, gen):
    """K2 against its plain version at ``shape``; the same inputs timed."""
    out = kt.time_snake(snake_ops, *kt.snake_inputs(shape, gen))
    assert out["max_abs_err"] <= SNAKE_TOL, (shape, out["max_abs_err"])
    return out


def rvq_check(weights, gen, frames: int):
    """K1 against its plain version at ``frames``, VBR (the inputs then
    timed) and CBR, with the weights prepared once, as the main path
    prepares them once per ``compress``."""
    n_q, d_model, _ = weights.wi.shape
    z, mask = kt.rvq_inputs(frames, n_q, d_model, gen)
    out = kt.time_rvq(rvq_ops, weights, z, mask)
    checks = {"vbr": out, "cbr": kt.rvq_compare(
        rvq_ops, z, weights, rvq_ops.prepare_rvq(weights), None)}
    for mode, c in checks.items():
        assert c["flipped_off_tie"] == 0, f"{mode}: codes differ off ties: {c}"
        assert c["max_abs_err"] <= ZQ_ATOL, f"{mode}: z_q differs: {c}"
        out.update({f"{mode}_{k}": c[k]
                    for k in ("flipped_frames", "max_abs_err")})
    out["max_abs_err"] = max(out["vbr_max_abs_err"], out["cbr_max_abs_err"])
    return out


def weights_24kbps(gen):
    """The quantizer's weights at 28 stages of the flagship's width, drawn
    as the flagship's are (uniform projections, N(0, 1) codebooks)."""
    q = port.init_params(
        VBRResidualVectorQuantize(1024, NQ_24KBPS, 1024, 8), gen)
    with torch.inference_mode():
        return rvq_ops.stack_quantizer_weights(q.to(DEVICE).eval())


def serve_phase(model):
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

    with tempfile.TemporaryDirectory() as tmp:
        # the warm-up (cuBLAS/cuDNN handles, allocator) also takes the census
        # of the shapes the path hands the Snake kernel
        with kt.snake_census(proc.model_nopad) as census:
            round_trip(tmp)
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
    assert sum(census.values()) == launches["snake"], (census, launches)

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
          snake_census=[[list(k), v] for k, v in sorted(census.items())])
    return launches, census


def agree_phase(model, census, gen):
    sr = model.sample_rate
    signal = port.Signal(port.synthetic_clip(AGREE_CLIP_S, sr, SEED + 1), sr)
    plain = model.clone(padding=True).use_kernels(False)
    with torch.inference_mode():
        weights = rvq_ops.stack_quantizer_weights(plain.quantizer)

    class PlainProcessor(port.CodecProcessor):
        """The plain path, which also keeps each window's smallest top-2
        score margin per frame over the quantizer's stages."""

        margins = []

        def _encode(self, variant, audio, n_quantizers, level, rvq=None):
            z = variant.encoder(audio)
            b, d, t = z.shape
            frames = z.transpose(1, 2).reshape(b * t, d)
            self.margins.append(
                rvq_ops.reference_margins(frames, *weights).reshape(b, t).cpu().numpy())
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

    # Snake at every shape of the census, timed; summed over one clip with
    # each shape weighted by its launches
    with torch.inference_mode():
        checks = [snake_check(s, gen) for s in sorted(census)]
    snake_clip = {k: kt.census_sum(checks, census, k)
                  for k in ("ms", "plain_ms", "bound_ms")}
    snake_clip["max_abs_err"] = max(c["max_abs_err"] for c in checks)

    phase("agree", windows=windows, frames=int(fused.codes.shape[-1]),
          code_flip_rate=float((fused.codes != ref.codes).mean()),
          flipped_frames=int(flipped.sum()), near_tie_frames=int(near_tie.sum()),
          mask_agreement=mask_agree, decode_si_sdr_db=sdr,
          max_abs_diff=float(np.abs(kernel_audio - plain_audio).max()),
          snake_shapes=len(checks), snake_clip=snake_clip,
          snake_by_shape=[{k: c[k] for k in ("shape", "ms", "plain_ms", "bound_ms")}
                          for c in checks])
    return snake_clip


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 1
    smi = device_phase()

    model = port.build_model(port.FLAGSHIP, device=DEVICE, seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == FLAGSHIP_PARAMS, n_params

    gen = torch.Generator().manual_seed(SEED)
    with torch.inference_mode():
        snakes = [snake_check(s, gen) for s in kt.SNAKE_ONE_SHOT]
        weights = rvq_ops.stack_quantizer_weights(model.quantizer)
        rvq = rvq_check(weights, gen, RVQ_FRAMES)
        # the frames of one serve window, as the chunked main path calls K1
        window_frames = port.CodecProcessor(model).window_geometry(WINDOW_S)[2]
        rvq_window = rvq_check(weights, gen, window_frames)
    w28 = weights_24kbps(gen)
    with torch.inference_mode():
        rvq_28 = [rvq_check(w28, gen, f) for f in (window_frames, RVQ_FRAMES)]
    phase("kernels", snake=snakes, rvq=rvq, rvq_window=rvq_window,
          rvq_24kbps=rvq_28)

    launches, census = serve_phase(model)
    snake_clip = agree_phase(model, census, gen)

    # K2 summed over one clip's census; K1 at one window, the one-shot sizes
    # beside each
    kernels = [
        {"name": "snake", "route": "cuda",
         "source": "vrvq_tpu_torch/kernels/csrc/snake.cu",
         "replaces": "vrvq_tpu/ops/snake.py:33",
         "launches": launches["snake"],
         "max_abs_err": max(snake_clip["max_abs_err"],
                            *(c["max_abs_err"] for c in snakes)),
         "ms": snake_clip["ms"], "plain_ms": snake_clip["plain_ms"],
         "bound_ms": snake_clip["bound_ms"], "bound_by": "bytes",
         "library_ms": None,
         "per": f"10 s clip: {launches['snake']} launches over "
                f"{len(census)} shapes",
         "one_shot": [{k: c[k] for k in ("shape", "ms", "plain_ms", "bound_ms")}
                      for c in snakes]},
        {"name": "fused_rvq", "route": "cuda",
         "source": "vrvq_tpu_torch/kernels/csrc/rvq.cu",
         "replaces": "vrvq_tpu/ops/rvq_kernel.py:130",
         "launches": launches["rvq"],
         "max_abs_err": max(c["max_abs_err"] for c in [rvq, rvq_window, *rvq_28]),
         "ms": rvq_window["ms"], "plain_ms": rvq_window["plain_ms"],
         "bound_ms": rvq_window["bound_ms"], "bound_by": rvq_window["bound_by"],
         "library_ms": None, "per": f"launch at {rvq_window['frames']} frames",
         "one_shot": {k: rvq[k] for k in ("frames", "ms", "plain_ms", "bound_ms")}},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
