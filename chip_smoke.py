#!/usr/bin/env python3
"""Drive vrvq_tpu_torch, the PyTorch + CUDA port, on one NVIDIA card.

Run from the repo root with no arguments: ``python3 chip_smoke.py``. It
builds the kernels (one ``nvcc`` call), then runs sixteen phases and prints
one line for each:

  device   the card's name and power limit, torch and CUDA versions, TF32 off,
           the kernel build time;
  kernels  each kernel against its plain PyTorch version on the same inputs
           at the flagship's shapes (K1 also at 28 stages, the 24 kbps
           size): the error, the kernel's and the plain version's device
           times and the card's lower bound; K1 also at a window's frames
           for every codebook width d in {1, 2, 3, 16, 32} and at
           D = K = 1000 and 6 (flips and errors, untimed);
  serve    the flagship DAC_VRVQ (random seeded weights, 81.56M parameters)
           compresses a seeded 10 s 44.1 kHz clip in VBR through the chunked
           padding-free path with the fused-RVQ kernel, round-trips the .dac
           file and decompresses it, twice (the same .dac bytes, here and in
           every profile of the fast phase); the kernels' launch counts of
           this run and the census of the Snake kernel's shapes (shape ->
           launches);
  agree    on a 3 s clip, three 1 s windows of the same chunked path: the
           kernel path against the port's plain path (code flips only on
           near-tie frames, identical masks, SI-SDR of the kernel decode
           against the plain decode of the same .dac), and the Snake kernel
           against its plain version, timed, at every shape of the census;
  fast     the folded float32 profile's codes and audio equal to the live
           model's; the fast (bfloat16 folded decoder, polynomial Snake),
           turbo (polynomial Snake in the encoder too) and bfloat16-exact
           profiles serve the 10 s clip (launches of each Snake mode, census,
           real-time factors); the Snake kernel in all four modes against
           its plain versions at every census shape, each mode timed at the
           census of the profile that runs it; decode SI-SDR of the fast
           profile against the exact one; ``turbo_gate`` on seeded clips;
  pool     8 streams x 10 s through ``StreamPool(max_batch=8)`` and
           ``DecoderPool`` in 1 s pushes: flips against the single-stream
           codes (near ties and others), decode agreement with the
           single-stream decoder, launches per window (K1, K2, every kernel)
           and the real-time factors over all streams; the Snake kernel at
           every pooled (batch > 1) shape of one round trip: timed in the
           pool's mode, every mode's error;
  entropy  a range-coded .dac of the serve phase's codes and the pool's
           chunks as ``PacketCodec`` packets, both round trips exact;
  reference the flagship's codes and audio against the CPU's
           (``vrvq_tpu_torch/reference.py``): flips on near-tie and other
           frames, mask agreement, decode SI-SDR of the fixture's codes,
           and as a control the same decode with TF32 convs, which must
           fall under the bar that the float32 decode clears;
  packed   the time-packed layouts (``nn/layers.py``) on 4 seeded 10 s
           clips, the padded one-shot codec: the turbo + packed-encoder
           profile's compress (codes from K1, ``fast.encode_codes``)
           against the turbo profile's on the same clips (flips on near
           ties and others, mask agreement, decode SI-SDR, the latents'
           largest relative difference), ``turbo_gate(encode_packed=True)``
           on seeded clips; the fast decoder (bfloat16) with
           ``decode_packed`` 1 and 2 and ``decode_packed_up`` 1 and 2, and
           the folded float32 decoder with each of them, on the turbo
           codes: the float32 ones against the unpacked float32 decoder
           (60 dB), the bfloat16 ones against the float32 decode, as close
           as the unpacked bfloat16 decoder is (0.05 dB), and against it
           (40 dB); the working memory of every run; K2's
           launches of every packed run no more than the unpacked run's;
           real-time factors, device ms by class and kernel counts of each
           profile (``profile_serve.one_shot``); K2 against its plain
           version, timed, at every shape of every run's census
           (bit-identical in the polynomial and bfloat16 modes), K1 on the
           runs' calls and at 13,792 frames (16 x 10 s at once);
  eval     one seeded 3 s clip in each format (wav, flac with LPC
           subframes, mp3 where libmp3lame and libmpg123 load, m4a where the
           FFmpeg shim builds; named ``split_NNNN_<class>``), each read back:
           wav and flac (and a fixed-subframe flac) equal to the written
           16-bit PCM bit for bit, mp3 and m4a at the JAX package's test
           bars, the host ms per second of audio of each reader; then
           ``cli.evaluate`` of the flagship (seeded weights) on the folder at
           levels 1 and 2 with ViSQOL (per-level means, kbps rising with the
           level, ViSQOL in [0, 1], the seconds of loading, the sweep, the
           metrics and ViSQOL), and again with ``--fast 1``; the report's
           SI-SDR and mel on one clip against the same evaluation with the
           Snake kernels swapped for their plain versions (1e-3 relative);
           ``cli.stream_demo`` of the flac with the fused quantizer and wire
           packets against compress + decompress of the file (60 dB); K2
           against its plain version, timed, at every shape of the three
           paths' censuses (the evaluator's batch-1 encoder and batch-2
           level decode are shapes no earlier phase gives it);
  train    ``train()`` of the flagship generator and discriminator (MPD
           2/3/5/7/11, MRD 2048/1024/512) on 32 seeded 1 s wavs through the
           port's loader, batch 16 x 0.38 s, vrvq_a2.yml's lambdas: 3 steps
           with a validation and a save at steps 0 and 2, the saved
           ``latest`` loaded and held bit for bit against the trained
           state, step 3 taken on the trained state (the uninterrupted
           step: every parameter of both networks must get a non-zero
           gradient) and again through ``train()`` resumed from ``latest``
           (the same losses, and both networks and optimizers after it, bit
           for bit; the differences printed); finite losses, both
           grad norms, ms per step, clips per second, peak memory, the
           launches of K2's forward and backward per step (K1 never); K2's
           backward against its plain version at every shape of the train
           step's Snake census (errors, bit-identity of two launches, device
           time against its bound), and K2's forward over the same census;
  configs  every file of ``conf/`` read by the port's YAML reader; the CBR
           flagship built from ``conf/original_dac/cbr.yml`` serves the 10 s
           clip at 8 and 4 stages, and the 24 kbps model from
           ``conf/vrvq/vrvq_a2_24k.yml`` (28 codebooks) at level 1, each
           through K1 against the port's plain path (flips on near ties
           only, decode SI-SDR), with K1 timed at 28 stages on a window;
  cli      ``python -m vrvq_tpu_torch.cli.train`` on
           ``conf/vrvq/vrvq_a2_b64_1chip.yml`` at flagship width (batch 64 as
           4 micro-batches of 16 x 0.38 s, the polynomial Snake in both
           stacks), pointed at 32 seeded wavs and cut to 3 steps with a
           validation of one batch of 16 x 0.38 s (each override printed as
           a reduction): the polynomial backward kernel launched, every
           parameter a non-zero gradient, finite falling losses, ms a step,
           clips a second, peak memory; its step-1 checkpoint loaded here
           and held bit for bit against the file, and that step taken here
           again under the census of both Snake modes; the train CLI on
           ``conf/original_dac/cbr.yml`` for 2 steps at batch 16; the
           inference CLI's level sweep of one 1 s example from the first
           run's last checkpoint; K2's polynomial forward and backward
           against their plain versions over the accumulated step's census;
  trained  a harmonic corpus of 2 s clips from ``cli.make_synth_dataset``;
           ``cli.train`` on ``conf/vrvq/vrvq_a2_synth_demo.yml`` at flagship
           width from it for 2 steps, under the census of K2's forward and
           backward calls; ``cli.measure_trained``'s 1000-step floor refused,
           then its every line at 2 x 1 s with the corpus as the gates'
           probe (the verdicts mean nothing this early); ``cli.evaluate`` at
           the 12 default levels (kbps rising); K2 in each mode over the
           training's, the measurement's and the evaluation's censuses and
           K1 at every frame count of the measurement, against their plain
           versions;
  trainer_io the native I/O library (built with ``g++``): the eval phase's wav,
           LPC flac and fixed-subframe flac clips read natively and by the
           plain readers (bit for bit; host ms per second of audio of each),
           the native loudness of their 0.38 s excerpts against the numpy
           meter (ms per excerpt); the serve phase's range-coded .dac and the
           pool's packets through the C++ and the Python range coder (byte
           for byte; host ms per window of each); ``train()`` of the
           flagship with MSD (``Discriminator.rates: [1, 2]``) for 2 steps
           at batch 16 x 0.38 s on 32 seeded 1 s clips, as LPC flac and as
           wav of the same samples, each loaded serially and by 4 prefetching
           threads (``data_ms`` of the four runs), with samples of two
           ``val_idx`` items at every step: the prefetched batches equal
           ``load_batch``'s, the native counters rise, every discriminator
           parameter gets a non-zero gradient, the other three runs equal
           the prefetched flac run bit for bit (losses, gradients, parameters),
           the event file holds the scalars, audio and images, and K2's
           forward launches equal the run's Snake calls and its backward
           launches the train census's; ``cli.export_torch`` of the run's
           checkpoint, whose ``weights.pth`` loads back through
           ``torch_ckpt`` to a decode of a 1 s clip equal to the trained
           model's bit for bit;
  parallel the flagship's step at batch 16 x 0.38 s (``vrvq_a2.yml``, MPD +
           MRD, the same pinned draws of the global batch throughout) in one
           process, the reference, and again (the same losses, gradients and
           parameters, bit for bit: the step runs cuDNN's deterministic
           algorithms); (c) the same with ``remat`` (losses within 1e-5
           relative, the update within 1e-4 relative L2: the gradients it
           took, each network's as one vector, and the parameters of both,
           ``agreement``; both peak memories, the step-time ratio, K2's
           launches); (a) two gloo ranks on the one card (8 + 8 rows,
           ZeRO-sharded AdamW) through ``trainer.load`` and the train step:
           losses within 1e-4 relative of the one-rank step, the update
           within 1e-3 relative L2, both ranks' parameters bit-identical,
           the consolidated optimizer state in the replicated layout (their
           ms: two ranks sharing a card, no scaling number), and K2's
           forward and backward against their plain versions at every shape
           of a rank's Snake census; (b) one NCCL rank through
           ``cli.train``'s torchrun-environment path, one step and a save,
           beside (a); with two or more cards also two NCCL ranks against
           the one-rank step as in (a), with clips/s on 1 and 2 cards, and
           ``cli.train`` with no flag (it spawns a rank a card);
           (d) ``CodecProcessor(devices=[every card])`` through
           ``StreamPool`` and ``DecoderPool`` on the pool phase's 8 streams x
           10 s: codes against the one-card pool's (0 flips on one card; none
           off a near tie on more), the one-card pool's codes decoded (the
           same audio on one card; 60 dB on more), and with two or more
           cards K1 and K2 (every mode, and the backward) on the last card
           against their plain versions, at a card's block of the batch.

Times are device times with a cold L2 (``vrvq_tpu_torch.kernel_times``: a
CUDA graph of launches, each after a copy that evicts the L2 cache, less the
graph of copies alone), taken on the inputs that the kernel was compared on.
Then a JSON line of the kernels on the main paths (K2 in each mode summed
over the census of the path that runs it, each shape weighted by its
launches, and over the pool's census; K2's exact bfloat16 mode over the
bfloat16 encoder's census; K1 at one window's 72 frames and at a
pool batch's 576, and at 28 stages; K2's forward and backward over the train
step's census, in the exact and in the polynomial mode; K2's forward and
backward in the trainer_io phase's run (the forward timed over that run's
census, the backward at the train step's); K2's forward and
backward in the parallel phase's one-rank steps (the train step's census)
and in its ranks' steps (a rank's census), K1 and K2 in its pool over the
cards, timed at the pool's census; K2 over the evaluator's census, exact and
fast, and over ``stream_demo``'s, K1 in ``stream_demo``; K2 in each mode
over each packed phase run's census, K1 over its compresses), each
with the launches of its path (counts cleared just before the path runs,
read just after), the card's ``nvidia-smi`` line, and as the last line
``{"ok": true, "device": {...}}``. Any failed check raises and the script
exits non-zero; without CUDA it exits non-zero at once.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import hashlib
import importlib.util
import io
import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import vrvq_tpu_torch as port
from vrvq_tpu_torch import kernel_times as kt
from vrvq_tpu_torch import profile_serve
from vrvq_tpu_torch import reference
from vrvq_tpu_torch.infer import fast, streaming
from vrvq_tpu_torch.cli import evaluate as cli_eval
from vrvq_tpu_torch.cli import export_torch as cli_export
from vrvq_tpu_torch.cli import make_synth_dataset as cli_synth
from vrvq_tpu_torch.cli import measure_trained as cli_measure
from vrvq_tpu_torch.cli import stream_demo as cli_stream
from vrvq_tpu_torch.cli import train as cli_train
from vrvq_tpu_torch.config import FLAGSHIP_YAML, REPO, Config, model_config, parse_args
from vrvq_tpu_torch.data import audio_io, ffdecode, flac_py, mpeg
from vrvq_tpu_torch.kernels import build
from vrvq_tpu_torch.metrics import si_sdr
from vrvq_tpu_torch.models import codec as codec_mod
from vrvq_tpu_torch.models.importance import ImportanceSubnet
from vrvq_tpu_torch.native import io as native_io
from vrvq_tpu_torch.ops import rangecoder
from vrvq_tpu_torch.ops.loudness import integrated_loudness
from vrvq_tpu_torch.models.quantize import VBRResidualVectorQuantize
from vrvq_tpu_torch.ops import rvq_kernel as rvq_ops
from vrvq_tpu_torch.ops import snake as snake_ops
from vrvq_tpu_torch.parallel import dist as pdist
from vrvq_tpu_torch.train import trainer
from vrvq_tpu_torch.train.checkpoint import load_gen_params
from vrvq_tpu_torch.train.tracker import read_events

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
POOL_STREAMS = 8  # StreamPool(max_batch=8): a batch of 8 windows a push
POOL_CLIP_S = 10.0
MIN_POOL_DECODE_DB = 60.0  # DecoderPool against StreamingDecoder, same codes
MIN_FAST_DB = 30.0  # fast decode against exact (turbo_gate's bar)
# the card's decode of the fixture's codes against the CPU's: far above the
# same decode with TF32 convs (printed as the control, which must fall under)
MIN_REFERENCE_DB = 90.0
SNAKE_BF16_TOL = 0.0  # bfloat16 modes: the plain version rounds as the kernel
SNAKE_MODES = ("snake", "snake_approx", "snake_bf16", "snake_approx_bf16")
# K1's codebook shapes beyond the flagship's (n_q, D, K, d), at a window's
# frames: every codebook width, and sizes no cluster of 4-wide slices splits
TRAIN_WAVS = 32  # seeded 1 s clips the train phase's loader reads
TRAIN_BATCH = 16
TRAIN_DURATION_S = 0.38  # conf/dataset.yml: train/AudioDataset.duration
TRAIN_STEPS = 4  # 3 through train(), the 4th resumed from `latest`
# K2's backward against its plain version: dx's largest difference over
# max|dx| (the kernel repeats the plain version's roundings: 0 is expected)
# and dalpha's over max|dalpha| (a float32 sum in another order)
SNAKE_BWD_DX_TOL = 1e-6
SNAKE_BWD_DALPHA_TOL = 1e-4
SNAKE_APPROX_BWD_DALPHA_TOL = 1e-6
# the cli phase: conf/vrvq/vrvq_a2_b64_1chip.yml (batch 64 as 4 micro-batches
# of 16 x 0.38 s, the polynomial Snake in both stacks) through the train CLI,
# then conf/original_dac/cbr.yml at batch 16, then the inference CLI
B64_YAML = "conf/vrvq/vrvq_a2_b64_1chip.yml"
CBR_YAML = "conf/original_dac/cbr.yml"
CLI_STEPS = 3
CBR_STEPS = 2
CLI_TIMEOUT_S = 420
# the trained phase: the synth demo's corpus and run, cut to size
SYNTH_DEMO_YAML = "conf/vrvq/vrvq_a2_synth_demo.yml"
TRAINED_CORPUS = {"train": 16, "val": 16, "test": 8}  # 2 s clips, as the generator makes
TRAINED_STEPS = 2
TRAINED_MEASURE = (2, 1.0)  # the profiles' batch x seconds: the JAX script's CPU sizes
TRAINED_EVAL_CLIPS = 1
# the models phase: DAC_MOE's VBR levels and train batch (x TRAIN_DURATION_S),
# and a per-stage codebook_dim list at the flagship's width
MOE_LEVELS = (0.5, 1.0, 2.0)
MOE_TRAIN_BATCH = 4
STAGE_WIDTHS = (16, 16, 8, 8, 8, 8, 4, 4)
RVQ_WIDE_SHAPES = [(8, 1024, 1024, d) for d in (1, 2, 3, 16, 32)] + [
    (8, 1000, 1000, 8), (8, 6, 6, 8)]
# the parallel phase: the flagship's step at batch 16 x 0.38 s in one rank
# and in two (2 x 8 rows), remat against the plain step
# the trainer_io phase: train() with MSD, the prefetcher and the samples
IO_STEPS = 2
IO_WORKERS = 4
IO_RATES = [1, 2]
IO_VAL_IDX = [0, 1]
IO_EXCERPT_S = 0.38  # loudness is measured on the loader's excerpts
PAR_STEPS = 4  # step 1 compared, steps 2-4 timed
PAR_LOSS_RTOL = 1e-4  # two ranks against one: every loss and grad norm
PAR_UPDATE_REL_L2 = 1e-3  # the update: each network's gradient, the parameters
REMAT_LOSS_RTOL = 1e-5  # remat against the plain step
REMAT_UPDATE_REL_L2 = 1e-4
PAR_TIMEOUT_S = 300
# the eval phase: one seeded 3 s clip in each format, named by class, through
# cli.evaluate (levels 1 and 2) and cli.stream_demo
EVAL_CLIP_S = 3.0
EVAL_CLIPS = (("split_0000_speech", ".wav"), ("split_0001_music", ".flac"),
              ("split_0002_noise+music", ".mp3"), ("split_0003_tone", ".m4a"))
EVAL_LEVELS = "1,2"
EVAL_REL = 1e-3  # eval.json's SI-SDR and mel, kernels against plain
MIN_MP3_DB = 20.0  # tests/test_mp3.py's bar against the source
MIN_AAC_DB = 15.0  # tests/test_mp4.py's, after aligning out the priming
# the packed phase: the padded one-shot codec on seeded 10 s clips (batch 4:
# at the JAX bench's batch 16 the phase would take minutes; profile_serve
# --batch 16 and profile_stages measure that shape)
PACKED_BATCH = 4
PACKED_CLIP_S = 10.0
PACKED_RVQ_FRAMES = 16 * RVQ_FRAMES  # 13,792: the one shot of 16 x 10 s
DECODE_PACKINGS = {"decode_packed_1": dict(decode_packed=1),
                   "decode_packed_2": dict(decode_packed=2),
                   "decode_packed_up_1": dict(decode_packed_up=1),
                   "decode_packed_up_2": dict(decode_packed_up=2)}
# a packed bfloat16 decode's SI-SDR against the float32 decode may fall this
# far under the unpacked bfloat16 decode's (H100 runs spread 0.004 dB), and
# against the unpacked bfloat16 decode it must clear MIN_PACKED_BF16_DB
# (H100 runs read 46.5 to 62.6 dB); each layout is also held in float32 to
# the unpacked float32 decode at MIN_SISDR_DB
MAX_BF16_LOSS_DB = 0.05
MIN_PACKED_BF16_DB = 40.0


_LAST_PHASE = [time.perf_counter()]


def phase(name: str, **fields) -> None:
    """One phase's JSON line, with the seconds since the last one ended."""
    now = time.perf_counter()
    fields["phase_s"] = now - _LAST_PHASE[0]
    _LAST_PHASE[0] = now
    print(f"{name} " + json.dumps(fields), flush=True)


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
          cublas_workspace=os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
          build_s=build_s, ptxas=registers)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    return smi


def snake_check(shape, gen, mode: str = "snake", timed: bool = True):
    """K2 in ``mode`` (an ``ops.snake.mode_name``) against its plain version
    at ``shape``; the same inputs timed when ``timed``. float32 modes within
    ``SNAKE_TOL``, bfloat16 ones bit-identical."""
    dtype = torch.bfloat16 if mode.endswith("_bf16") else torch.float32
    out = kt.time_snake(snake_ops, *kt.snake_inputs(shape, gen, dtype),
                        approx="approx" in mode, timed=timed)
    tol = SNAKE_BF16_TOL if dtype == torch.bfloat16 else SNAKE_TOL
    assert out["max_abs_err"] <= tol, (mode, shape, out["max_abs_err"])
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


def uniform_weights(gen, n_q, d_model, k, d_code):
    """K1's weights drawn as the codec's initialization draws them:
    projections uniform in +-1/sqrt(fan_in), codebooks N(0, 1), small
    biases."""
    return rvq_ops.RVQWeights(*(t.to(DEVICE) for t in (
        (2 * torch.rand(n_q, d_model, d_code, generator=gen) - 1) / d_model ** 0.5,
        0.1 * torch.randn(n_q, d_code, generator=gen),
        (2 * torch.rand(n_q, d_code, d_model, generator=gen) - 1) / d_code ** 0.5,
        0.1 * torch.randn(n_q, d_model, generator=gen),
        torch.randn(n_q, k, d_code, generator=gen))))


def rvq_shape_check(gen, shape, frames: int):
    """K1 against its plain version at a codebook ``shape`` (n_q, D, K, d),
    VBR and CBR, untimed: codes equal off near ties, z_q within ``ZQ_ATOL``."""
    n_q, d_model, k, d_code = shape
    weights = uniform_weights(gen, n_q, d_model, k, d_code)
    z, mask = kt.rvq_inputs(frames, n_q, d_model, gen)
    prepared = rvq_ops.prepare_rvq(weights)
    out = {"n_q": n_q, "D": d_model, "K": k, "d": d_code, "frames": frames}
    for mode, m in (("vbr", mask), ("cbr", None)):
        c = kt.rvq_compare(rvq_ops, z, weights, prepared, m)
        assert c["flipped_off_tie"] == 0, f"{shape} {mode}: codes differ off ties: {c}"
        assert c["max_abs_err"] <= ZQ_ATOL, f"{shape} {mode}: z_q differs: {c}"
        out.update({f"{mode}_{k}": c[k] for k in (
            "flipped_frames", "near_tie_frames", "max_abs_err")})
    return out


def serve_clip(model):
    sr = model.sample_rate
    return port.Signal(port.synthetic_clip(10.0, sr, SEED), sr)


def serve(model, signal, fused: bool = True, **request):
    """The serving path of ``model`` on ``signal``: compress (``request``:
    VBR at level 1 by default, or a CBR ``n_quantizers``; 1 s windows, the
    fused quantizer unless ``fused`` is off), the ``.dac`` saved and loaded,
    decompress. A warm-up round trip (cuBLAS/cuDNN handles, allocator) takes
    the census of the Snake kernel's (mode, shape) -> launches; the launch
    counts are cleared just before the timed round trip and read just
    after. The two round trips' ``.dac`` files must be the same bytes."""
    proc = port.CodecProcessor(model, fused_quantizer=fused)
    request = request or {"level": 1.0}

    def round_trip(tmp):
        t0 = time.perf_counter()
        dac = proc.compress(signal, win_duration=WINDOW_S, **request)
        t1 = time.perf_counter()
        path = dac.save(Path(tmp) / "clip.dac")
        loaded = port.DACFile.load(path)
        t2 = time.perf_counter()
        out = proc.decompress(loaded)
        t3 = time.perf_counter()
        return dac, path.read_bytes(), out, t1 - t0, t3 - t2

    with tempfile.TemporaryDirectory() as tmp:
        with kt.snake_census(proc.model_nopad, by_mode=True) as census:
            first = round_trip(tmp)[1]
        build.LAUNCHES.clear()
        dac, data, out, enc_s, dec_s = round_trip(tmp)
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
    assert data == first, "two compresses of the clip gave other .dac bytes"
    size = len(data)
    seconds = signal.signal_duration
    assert (launches.get("rvq", 0) > 0) == fused, launches
    for mode in {m for m, _ in census}:
        assert launches.get(mode, 0) == sum(
            n for (m, _), n in census.items() if m == mode), (census, launches)
    return {"proc": proc, "dac": dac, "dac_bytes": size, "out": out,
            "launches": launches, "census": census, "encode_s": enc_s,
            "decode_s": dec_s, "encode_rtf": seconds / enc_s,
            "decode_rtf": seconds / dec_s}


def of_mode(census, mode):
    """shape -> launches of one mode of a by-mode census."""
    return {s: n for (m, s), n in census.items() if m == mode}


def serve_phase(model):
    signal = serve_clip(model)
    run = serve(model, signal)
    dac, out, launches = run["dac"], run["out"], run["launches"]
    census = of_mode(run["census"], "snake")
    audio = out.audio_data
    assert dac.padding is False and dac.vbr_counts is not None
    assert audio.shape == (1, 1, signal.signal_length), audio.shape
    # float32 samples times the float64 loudness gain, as in the JAX package
    assert audio.dtype == np.float64, audio.dtype
    assert np.isfinite(audio).all()
    assert set(launches) == {"snake", "rvq"}, launches

    kept = {}
    for level in (0.5, 2.0):
        kept[level] = float(run["proc"].compress(
            signal, win_duration=WINDOW_S, level=level).vbr_counts.mean())
    assert kept[2.0] > kept[0.5], kept

    phase("serve", params=sum(p.numel() for p in model.parameters()),
          clip_s=signal.signal_duration,
          windows=int(dac.codes.shape[-1] // dac.chunk_length),
          frames=int(dac.codes.shape[-1]), dac_bytes=run["dac_bytes"],
          mean_kept_codebooks=float(dac.vbr_counts.mean()),
          mean_kept_at_level={str(k): v for k, v in kept.items()},
          **{k: run[k] for k in ("encode_s", "decode_s", "encode_rtf",
                                 "decode_rtf", "launches")},
          snake_census=[[list(k), v] for k, v in sorted(census.items())])
    return launches, census, dac


class MarginProcessor(port.CodecProcessor):
    """The plain path (``fused_quantizer=False`` on a model whose Snakes run
    their plain versions), which also keeps each window's smallest top-2
    score margin per frame over the quantizer's stages (``margins``)."""

    def __init__(self, model):
        super().__init__(model.clone(padding=True).use_kernels(False),
                         fused_quantizer=False)
        with torch.inference_mode():
            self.weights = rvq_ops.stack_quantizer_weights(self.model.quantizer)
        self.margins = []

    def _encode(self, variant, audio, n_quantizers, level, rvq=None):
        z = variant.encoder(audio)
        b, d, t = z.shape
        frames = z.transpose(1, 2).reshape(b * t, d)
        self.margins.append(rvq_ops.reference_margins(
            frames, *self.weights).reshape(b, t).cpu().numpy())
        return super()._encode(variant, audio, n_quantizers, level, rvq)


def flips(codes, other, near_tie):
    """Frames (B, T) whose codes differ in any stage, split by ``near_tie``."""
    flipped = (codes != other).any(axis=1)
    assert flipped.shape == near_tie.shape, (flipped.shape, near_tie.shape)
    return {"flipped_frames": int(flipped.sum()),
            "flipped_near_tie": int((flipped & near_tie).sum()),
            "flipped_off_tie": int((flipped & ~near_tie).sum()),
            "near_tie_frames": int(near_tie.sum()),
            "code_flip_rate": float((codes != other).mean())}


def agree_phase(model, census, gen):
    sr = model.sample_rate
    signal = port.Signal(port.synthetic_clip(AGREE_CLIP_S, sr, SEED + 1), sr)
    kernel_proc = port.CodecProcessor(model, fused_quantizer=True)
    plain_proc = MarginProcessor(model)
    fused = kernel_proc.compress(signal, win_duration=WINDOW_S, level=1.0)
    ref = plain_proc.compress(signal, win_duration=WINDOW_S, level=1.0)
    assert fused.padding is False and ref.padding is False
    windows = int(fused.codes.shape[-1] // fused.chunk_length)
    assert windows > 1, windows

    near_tie = np.concatenate(plain_proc.margins, axis=-1) <= TIE_MARGIN
    split = flips(fused.codes, ref.codes, near_tie)
    assert split["flipped_off_tie"] == 0, f"codes differ off near ties: {split}"
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
    snake_clip = census_row(checks, census)

    phase("agree", windows=windows, frames=int(fused.codes.shape[-1]), **split,
          mask_agreement=mask_agree, decode_si_sdr_db=sdr,
          max_abs_diff=float(np.abs(kernel_audio - plain_audio).max()),
          snake_shapes=len(checks), snake_clip=snake_clip,
          snake_by_shape=[{k: c[k] for k in ("shape", "ms", "plain_ms", "bound_ms")}
                          for c in checks])
    return snake_clip


def census_row(checks, census):
    """K2 over one run of a path: ms, plain_ms and bound_ms summed over its
    census (each shape weighted by its launches), the largest error."""
    row = {k: kt.census_sum(checks, census, k)
           for k in ("ms", "plain_ms", "bound_ms")}
    row["max_abs_err"] = max(c["max_abs_err"] for c in checks)
    row["shapes"] = len(checks)
    return row


# the path whose census times each Snake mode: exact float32 in the serve
# phase, the others in the profile that runs them
MODE_PATHS = {"snake_approx_bf16": "fast", "snake_approx": "turbo",
              "snake_bf16": "bf16_exact"}


def fast_phase(model, serve_dac, census, gen):
    sr = model.sample_rate
    # the folded float32 profile (encoder too) against the live model
    agree_sig = port.Signal(port.synthetic_clip(AGREE_CLIP_S, sr, SEED + 1), sr)
    folded = fast.make_inference_model(model, decode_dtype=None,
                                       snake_approx=False, fold_encoder=True)
    live_proc = port.CodecProcessor(model, fused_quantizer=True)
    fold_proc = port.CodecProcessor(folded, fused_quantizer=True)
    a = live_proc.compress(agree_sig, win_duration=WINDOW_S, level=1.0)
    b = fold_proc.compress(agree_sig, win_duration=WINDOW_S, level=1.0)
    assert np.array_equal(a.codes, b.codes), "folded codes differ"
    assert np.array_equal(a.vbr_counts, b.vbr_counts), "folded counts differ"
    assert np.array_equal(live_proc.decompress(a).audio_data,
                          fold_proc.decompress(a).audio_data), "folded audio differs"

    profiles = {
        "fast": fast.make_inference_model(model),
        "turbo": fast.make_serving_model(model),
        "bf16_exact": fast.make_inference_model(model, snake_approx=False),
    }
    signal = serve_clip(model)
    runs = {name: serve(m, signal) for name, m in profiles.items()}
    for name, run in runs.items():
        assert np.isfinite(run["out"].audio_data).all(), name
    # the fast profile's codes are the live encoder's; its decode of the
    # serve phase's codes against the live decode
    assert np.array_equal(runs["fast"]["dac"].codes, serve_dac.codes)
    exact_audio = live_proc.decompress(serve_dac).audio_data
    fast_audio = runs["fast"]["proc"].decompress(serve_dac).audio_data
    fast_db = si_sdr(fast_audio, exact_audio)
    assert fast_db >= MIN_FAST_DB, fast_db

    # every mode at every shape any profile gives the kernel (errors only),
    # then each mode timed at the census of its path
    shapes = sorted({s for run in runs.values() for _, s in run["census"]}
                    | set(census))
    modes = ("snake", *MODE_PATHS)
    with torch.inference_mode():
        errors = {mode: max(snake_check(s, gen, mode, timed=False)["max_abs_err"]
                            for s in shapes) for mode in modes}
        rows = {}
        for mode, path in MODE_PATHS.items():
            mode_census = of_mode(runs[path]["census"], mode)
            checks = [snake_check(s, gen, mode) for s in sorted(mode_census)]
            rows[mode] = {**census_row(checks, mode_census),
                          "launches": runs[path]["launches"][mode],
                          "path": path}

    gate = fast.turbo_gate(model, clips=fast.synthetic_probe(sr, SEED))
    phase("fast", folded_codes_equal=True, folded_audio_equal=True,
          fast_decode_si_sdr_db=fast_db, census_shapes=len(shapes),
          max_abs_err_by_mode=errors, snake_by_mode=rows,
          profiles={name: {k: run[k] for k in (
              "encode_rtf", "decode_rtf", "launches", "dac_bytes")}
              for name, run in runs.items()},
          turbo_gate={k: v for k, v in gate.__dict__.items()})
    return rows, errors


def pool_phase(model, gen):
    """8 live streams in 1 s pushes through one StreamPool and DecoderPool,
    against the same streams one window at a time."""
    sr = model.sample_rate
    streams = {f"s{i}": port.synthetic_clip(POOL_CLIP_S, sr, SEED + 10 + i)[0, 0]
               for i in range(POOL_STREAMS)}
    proc = port.CodecProcessor(model, fused_quantizer=True)
    block = sr  # 1 s pushes

    def encode_all():
        pool = streaming.StreamPool(proc, win_duration=WINDOW_S, level=1.0,
                                    max_batch=POOL_STREAMS)
        for sid in streams:
            pool.add_stream(sid)
        chunks, batches = [], []
        for start in range(0, int(POOL_CLIP_S * sr), block):
            for sid, x in streams.items():
                pool.push(sid, x[start: start + block])
            batches.append(len(pool._pending))
            chunks += pool.poll()
        for sid in streams:
            pool.flush(sid)
        batches.append(len(pool._pending))
        chunks += pool.poll()
        return chunks, batches

    def decode_all(chunks):
        dp = streaming.DecoderPool(proc, win_duration=WINDOW_S,
                                   max_batch=POOL_STREAMS)
        out = []
        for i in range(0, len(chunks), POOL_STREAMS):
            for sid, codes, counts in chunks[i: i + POOL_STREAMS]:
                dp.push(sid, codes, counts)
            out += dp.poll()
        return out

    # warm-up (the batch shapes' conv plans) and the census of the Snake
    # kernel's (mode, shape) -> launches of one round trip
    with kt.snake_census(proc.model_nopad, by_mode=True) as census:
        decode_all(encode_all()[0])
    build.LAUNCHES.clear()
    t0 = time.perf_counter()
    chunks, batches = encode_all()
    t1 = time.perf_counter()
    enc_launches = dict(build.LAUNCHES)
    build.LAUNCHES.clear()
    t2 = time.perf_counter()
    audio = decode_all(chunks)
    t3 = time.perf_counter()
    dec_launches = dict(build.LAUNCHES)
    windows = len(chunks)
    assert windows == len(audio) and enc_launches.get("rvq", 0) > 0

    # every kernel of one more round trip, from the profiler
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        decode_all(encode_all()[0])
        torch.cuda.synchronize()
    device_kernels = sum(1 for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA)

    # the same windows one at a time (batch 1): codes, margins, decode
    rvq = proc.prepared_rvq()[0]
    weights = rvq.weights
    by_stream = {sid: [(c, n) for s, c, n in chunks if s == sid] for sid in streams}
    single, margins, single_audio = {}, {}, {}
    window, hop, _, delay = proc.window_geometry(WINDOW_S)
    with torch.inference_mode():
        for sid, x in streams.items():
            wb = streaming._WindowBuffer(window, hop, delay)
            codes, mins = [], []
            for w in wb.push(x) + wb.flush():
                z = proc.model_nopad.encoder(torch.from_numpy(w[None, None]).to(DEVICE))
                frames = z.transpose(1, 2).reshape(-1, z.shape[1])
                codes.append(rvq_ops.quantize_fused(rvq, z)[1][0].cpu().numpy())
                mins.append(rvq_ops.reference_margins(frames, *weights).cpu().numpy())
            single[sid], margins[sid] = codes, mins
            dec = streaming.StreamingDecoder(proc, win_duration=WINDOW_S)
            single_audio[sid] = [a for c, n in by_stream[sid] for a in dec.push(c, n)]
    pooled = np.concatenate([c for sid in streams for c, _ in by_stream[sid]], -1)
    alone = np.concatenate([c for sid in streams for c in single[sid]], -1)
    near = np.concatenate([m for sid in streams for m in margins[sid]]) <= TIE_MARGIN
    split = flips(pooled[None], alone[None], near[None])
    assert split["flipped_off_tie"] == 0, f"pool codes differ off near ties: {split}"
    pool_audio = {sid: np.concatenate([a for s, a in audio if s == sid])
                  for sid in streams}
    decode_db = min(si_sdr(pool_audio[sid][None],
                           np.concatenate(single_audio[sid])[None])
                    for sid in streams)
    assert decode_db >= MIN_POOL_DECODE_DB, decode_db

    seconds = POOL_STREAMS * POOL_CLIP_S

    def k2(launches):
        return sum(n for k, n in launches.items() if k.startswith("snake"))

    # K2 at every pooled shape (batch > 1): timed in the mode the pool ran,
    # every mode's error on the same shapes
    census_modes = {m for m, _ in census}
    for mode in census_modes:
        assert enc_launches.get(mode, 0) + dec_launches.get(mode, 0) == sum(
            n for (m, _), n in census.items() if m == mode), (census, mode)
    shapes = sorted({s for _, s in census})
    assert max(s[0] for s in shapes) > 1, shapes
    with torch.inference_mode():
        errors = {mode: max(snake_check(s, gen, mode, timed=False)["max_abs_err"]
                            for s in shapes) for mode in SNAKE_MODES}
        rows = {}
        for mode in census_modes:
            mode_census = of_mode(census, mode)
            checks = [snake_check(s, gen, mode) for s in sorted(mode_census)]
            rows[mode] = {**census_row(checks, mode_census),
                          "launches": enc_launches.get(mode, 0)
                          + dec_launches.get(mode, 0)}

    phase("pool", streams=POOL_STREAMS, clip_s=POOL_CLIP_S, windows=windows,
          batches=batches, **split, decode_min_si_sdr_db=decode_db,
          encode_launches=enc_launches, decode_launches=dec_launches,
          launches_per_window={
              "rvq": enc_launches["rvq"] / windows,
              "snake": (k2(enc_launches) + k2(dec_launches)) / windows,
              "all_kernels": device_kernels / windows},
          compress_s=t1 - t0, decompress_s=t3 - t2,
          compress_rtf=seconds / (t1 - t0), decompress_rtf=seconds / (t3 - t2),
          census_shapes=len(shapes), max_abs_err_by_mode=errors,
          snake_by_mode=rows)
    return enc_launches, {"chunks": chunks, "margins": margins, "audio": audio}, rows


def entropy_phase(model, serve_dac, chunks):
    cfg = model.config
    with tempfile.TemporaryDirectory() as tmp:
        path = serve_dac.save(Path(tmp) / "rc.dac", entropy=True,
                              codebook_size=cfg.codebook_size)
        packed = serve_dac.save(Path(tmp) / "packed.dac",
                                codebook_size=cfg.codebook_size)
        back = port.DACFile.load(path)
        rc_bytes, packed_bytes = path.stat().st_size, packed.stat().st_size
    counts = serve_dac.vbr_counts
    kept = np.arange(cfg.n_codebooks)[None, :, None] < counts[:, None, :]
    assert np.array_equal(back.vbr_counts, counts)
    assert np.array_equal(back.codes[kept], serve_dac.codes[kept])
    # the pool's chunks, stream by stream, as packets
    packets = 0
    by_stream = {}
    for sid, codes, cnt in chunks:
        by_stream.setdefault(sid, []).append((codes, cnt))
    for sid, items in by_stream.items():
        tx = streaming.PacketCodec(cfg.n_codebooks, cfg.codebook_size)
        rx = streaming.PacketCodec(cfg.n_codebooks, cfg.codebook_size)
        for codes, cnt in items:
            packet = tx.pack(codes, cnt)
            packets += len(packet)
            got, got_cnt = rx.unpack(packet)
            keep = np.arange(cfg.n_codebooks)[:, None] < cnt[None, :]
            assert np.array_equal(got_cnt, cnt) and np.array_equal(got[keep], codes[keep])
    phase("entropy", dac_bytes_range_coded=rc_bytes, dac_bytes_bit_packed=packed_bytes,
          stream_chunks=len(chunks), packet_bytes=packets, round_trips_exact=True)


def reference_phase(model):
    fixture = reference.load()
    out = reference.compute(model)
    margins = MarginProcessor(model)
    sr = model.sample_rate
    margins.compress(port.Signal(reference.clip(sr), sr),
                     win_duration=reference.WINDOW_S, level=reference.LEVEL)
    near_tie = np.concatenate(margins.margins, axis=-1) <= TIE_MARGIN
    codes = out["codes"]
    split = flips(codes, fixture["codes"].astype(codes.dtype), near_tie)
    assert split["flipped_off_tie"] == 0, f"codes differ off near ties: {split}"
    n_q = codes.shape[1]
    stage = np.arange(n_q)[None, :, None]
    mask_agree = float(((stage < out["counts"][:, None, :])
                        == (stage < fixture["counts"][:, None, :])).mean())
    # the fixture's codes decoded on the card, against the CPU's decode
    dac = port.DACFile(
        codes=fixture["codes"].astype(np.int32), vbr_counts=fixture["counts"],
        chunk_length=int(fixture["chunk_length"]),
        original_length=int(reference.CLIP_S * sr),
        input_db=float(fixture["input_db"]), channels=1, sample_rate=sr,
        padding=False)
    proc = port.CodecProcessor(model, fused_quantizer=True)

    def decode_db():
        card = proc.decompress(dac).audio_data[0, 0, : fixture["audio"].size]
        return si_sdr(card[None], fixture["audio"][None])

    sound_db = decode_db()
    # the control: the same decode with TF32 convs and matmuls, which the
    # bar must tell apart from the float32 decode
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32_db = decode_db()
    finally:
        port.disable_tf32()
    assert sound_db >= MIN_REFERENCE_DB > tf32_db, (sound_db, tf32_db)
    phase("reference", fixture=str(reference.FIXTURE.name),
          frames=int(codes.shape[-1]), **split, mask_agreement=mask_agree,
          counts_equal=float((out["counts"] == fixture["counts"]).mean()),
          decode_si_sdr_db=sound_db, min_decode_si_sdr_db=MIN_REFERENCE_DB,
          tf32_control_decode_si_sdr_db=tf32_db,
          own_decode_si_sdr_db=si_sdr(out["audio"][None], fixture["audio"][None]))


def tests_module(name: str):
    """``tests/<name>.py`` of this repo, loaded by path (on the card's machine
    another project's ``tests`` package shadows this repo's)."""
    spec = importlib.util.spec_from_file_location(f"_repo_tests_{name}",
                                                  REPO / "tests" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@contextlib.contextmanager
def rvq_calls():
    """While open, records (frames, weights) of every ``fused_rvq_prepared``
    call, in whichever model makes it (the CLIs build their own)."""
    calls = []
    inner = rvq_ops.fused_rvq_prepared

    def record(z, prepared, mask=None):
        calls.append((int(z.shape[0]), prepared.weights))
        return inner(z, prepared, mask)

    rvq_ops.fused_rvq_prepared = record
    try:
        yield calls
    finally:
        rvq_ops.fused_rvq_prepared = inner


@contextlib.contextmanager
def snake_backward_calls():
    """While open, counts the input shapes of every ``ops.snake.snake_backward``
    call (the autograd backward of K2's float32 modes), by the launch counter
    each call adds to: a Counter of (name, shape) -> calls."""
    calls = collections.Counter()
    inner = snake_ops.snake_backward

    def record(x, alpha, grad, approx=False):
        name = "snake_approx_backward" if approx else "snake_backward"
        calls[name, tuple(x.shape)] += 1
        return inner(x, alpha, grad, approx)

    snake_ops.snake_backward = record
    try:
        yield calls
    finally:
        snake_ops.snake_backward = inner


def counted(fn, *args, plain: bool = False, **kwargs):
    """``fn``'s result, the kernels' launches of its run (counts cleared just
    before, read just after) and its Snake census: a launch for every Snake
    call of each mode, or with ``plain`` (the plain versions) none at all."""
    with kt.snake_census(by_mode=True) as census:
        build.LAUNCHES.clear()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
    if plain:
        assert not launches, launches
        return out, launches, census
    for mode in {m for m, _ in census}:
        assert launches.get(mode, 0) == sum(
            n for (m, _), n in census.items() if m == mode), (census, launches)
    return out, launches, census


def snr_db(ref, got) -> float:
    n = min(ref.shape[-1], got.shape[-1])
    ref, got = ref[..., :n], got[..., :n]
    return float(10 * np.log10((ref ** 2).sum() / max(((ref - got) ** 2).sum(), 1e-12)))


def aligned_snr_db(ref, got, max_lag: int = 5000) -> float:
    """SNR after aligning out an AAC encoder's priming delay."""
    n = min(ref.shape[-1], got.shape[-1]) - max_lag
    r = ref[0, :n]
    lag = max(range(max_lag), key=lambda lg: float(np.dot(r, got[0, lg:lg + n])))
    return snr_db(ref[:, :n], got[:, lag:lag + n])


def write_eval_clips(folder: Path, sr: int):
    """One seeded 3 s mono clip in each format of ``EVAL_CLIPS`` (mp3 where
    libmp3lame and libmpg123 load, m4a where the FFmpeg shim builds), and a
    fixed-subframe flac of the flac's clip beside the folder; each read back
    and checked: wav and flac equal to the written 16-bit PCM bit for bit, mp3
    and m4a at the JAX package's test bars. Returns the readers' line and
    the flac's path."""
    flac_enc, mp3_enc = tests_module("flac_encoder"), tests_module("mp3_encoder")
    folder.mkdir()
    formats, flac_path = {}, None
    for i, (stem, ext) in enumerate(EVAL_CLIPS):
        x = port.synthetic_clip(EVAL_CLIP_S, sr, SEED + 200 + i)[0]  # (1, T)
        pcm = np.round(np.clip(x, -1.0, 1.0) * 32767.0).astype(np.int64)
        path = folder / f"{stem}{ext}"
        if ext == ".wav":
            audio_io.write_wav(path, x, sr)
        elif ext == ".flac":
            flac_enc.write_flac(path, pcm, sr, block_size=4096, subframe_kind="lpc", order=2)
            flac_enc.write_flac(folder.parent / "fixed.flac", pcm, sr, block_size=4096,
                                subframe_kind="fixed", order=2)
            flac_path = path
        elif ext == ".mp3":
            if not (mp3_enc.lame_available() and mpeg.available()):
                formats[ext] = {"unavailable": "libmp3lame or libmpg123 not found"}
                continue
            path.write_bytes(mp3_enc.encode_mp3(x, sr))
        elif ext == ".m4a":
            if not ffdecode.available():
                formats[ext] = {"unavailable": ffdecode._REASON}
                continue
            ffdecode.encode_aac(path, x, sr)
        paths = [path] + ([folder.parent / "fixed.flac"] if ext == ".flac" else [])
        for p in paths:
            t0 = time.perf_counter()
            got, got_sr = audio_io.read_audio(p)
            ms = (time.perf_counter() - t0) * 1000 / EVAL_CLIP_S
            assert got_sr == sr and got.shape[0] == 1, (p, got.shape, got_sr)
            row = {"host_ms_per_audio_s": ms, "frames": int(got.shape[-1])}
            if ext in (".wav", ".flac"):
                assert np.array_equal(np.round(got * 32768.0).astype(np.int64), pcm), p
                row["bit_exact"] = True
            elif ext == ".mp3":
                row["snr_db"] = snr_db(x, got)
                assert got.shape == x.shape and row["snr_db"] > MIN_MP3_DB, (p, row)
            else:
                row["aligned_snr_db"] = aligned_snr_db(x, got)
                assert abs(got.shape[-1] - x.shape[-1]) < 2048, (p, got.shape)
                assert row["aligned_snr_db"] > MIN_AAC_DB, (p, row)
            formats[p.name if p.name == "fixed.flac" else ext] = row
    return formats, flac_path


def snake_mode_row(census, mode, gen, base_census, known=None):
    """K2 in ``mode`` against its plain version, timed, at every shape of
    that mode in a path's census (a check of this run in ``known``, shape ->
    check of the same mode, is reused): ms, plain and bound summed over the
    census (each shape weighted by its launches), and the shapes new beside
    ``base_census``."""
    mode_census = of_mode(census, mode)
    known = known or {}
    with torch.inference_mode():
        checks = [known.get(s) or snake_check(s, gen, mode) for s in sorted(mode_census)]
    return {**census_row(checks, mode_census),
            "launches": sum(mode_census.values()),
            "new_shapes": len(set(mode_census) - set(base_census))}


def rvq_stream_row(calls, launches, gen):
    """K1 against its plain version, timed, at every frame count of a run's
    recorded calls, with that run's weights: ms, plain and bound the mean of
    a launch over the run's calls, and the census frames -> launches."""
    frames = collections.Counter(f for f, _ in calls)
    assert sum(frames.values()) == launches, (frames, launches)
    weights = calls[0][1]
    with torch.inference_mode():
        checks = {f: rvq_check(weights, gen, f) for f in sorted(frames)}
    assert len({c["bound_by"] for c in checks.values()}) == 1, checks
    row = {k: sum(n * checks[f][k] for f, n in frames.items()) / launches
           for k in ("ms", "plain_ms", "bound_ms")}
    return {**row, "launches": launches, "frames": dict(frames),
            "bound_by": checks[min(frames)]["bound_by"],
            "max_abs_err": max(c["max_abs_err"] for c in checks.values())}


def eval_argv(folder: Path, out: Path, *extra):
    return ["--args.load", FLAGSHIP_YAML, "--data_dir", str(folder), "--duration",
            str(EVAL_CLIP_S), "--levels", EVAL_LEVELS, "--out", str(out), *extra]


def eval_phase(gen, serve_census):
    """cli.evaluate and cli.stream_demo at flagship width (seeded weights) on
    a clip in each format: the readers checked, the evaluator's report and
    its Snake census (exact, and the fast profile's), the report's SI-SDR and
    mel against the plain path on one clip, the stream against compress +
    decompress of the same file."""
    sr = port.FLAGSHIP.sample_rate
    with tempfile.TemporaryDirectory() as tmp:
        folder = Path(tmp) / "clips"
        formats, flac_path = write_eval_clips(folder, sr)
        clip_formats = [c.suffix for c in sorted(folder.iterdir())]
        n_clips = len(clip_formats)

        seconds = {}
        report, launches, census = counted(cli_eval.main, eval_argv(
            folder, Path(tmp) / "eval.json", "--visqol", "1", "--fast", "0"), seconds)
        levels = report["levels"]
        assert report["num_examples"] == n_clips and len(levels) == 2, report
        low, high = levels.values()  # levels 1 and 2
        assert high["kbps"] > low["kbps"], levels
        for lv in levels.values():
            assert all(np.isfinite(v["mean"]) for k, v in lv.items()
                       if isinstance(v, dict)), lv
            assert 0.0 <= lv["ViSQOL"]["mean"] <= 1.0, lv
        assert launches.get("snake", 0) > 0 and set(launches) == {"snake"}, launches
        fast_report, fast_launches, fast_census = counted(cli_eval.main, eval_argv(
            folder, Path(tmp) / "fast.json", "--fast", "1"))
        assert fast_launches.get("snake_approx_bf16", 0) > 0, fast_launches

        # one clip through the kernels and through the plain versions
        one = parse_args(eval_argv(folder, Path(tmp) / "one.json", "--fast", "0",
                                   "--num_examples", "1"), base_dir=REPO)
        model = cli_eval.load_model(one, DEVICE, fast=False)
        kernel_one, one_launches, _ = counted(cli_eval.evaluate, one, model=model)
        plain_one, _, _ = counted(cli_eval.evaluate, one, plain=True,
                                  model=model.clone(padding=True).use_kernels(False))
        assert one_launches.get("snake", 0) > 0, one_launches
        kernel_one, plain_one = kernel_one["levels"], plain_one["levels"]
        plain_rel = {}
        for lv, stats in kernel_one.items():
            for m in ("SI-SDR", "mel"):
                a, b = stats[m]["mean"], plain_one[lv][m]["mean"]
                plain_rel[f"{lv} {m}"] = abs(a - b) / abs(b)
        assert max(plain_rel.values()) <= EVAL_REL, plain_rel

        with rvq_calls() as k1_calls:
            stream, stream_launches, stream_census = counted(cli_stream.main, [
                "--args.load", FLAGSHIP_YAML, "--input", str(flac_path), "--output",
                str(Path(tmp) / "stream.wav"), "--level", "1.0", "--fused_quantizer",
                "1", "--entropy", "1"])
        assert stream_launches.get("rvq", 0) > 0 and stream_launches.get("snake", 0) > 0
        proc = port.CodecProcessor(model, fused_quantizer=True)
        dac = proc.compress(port.Signal.load(flac_path), win_duration=1.0,
                            normalize_db=None, level=1.0)
        expected = proc.decompress(dac).audio_data
        got = port.Signal(stream["audio"][None, None], sr).normalize(dac.input_db)
        stream_db = si_sdr(got.audio_data[..., : expected.shape[-1]], expected)
        assert stream_db >= MIN_SISDR_DB, stream_db
        assert audio_io.read_audio(stream["output"])[0].shape[-1] == stream["samples"]
        del model, proc

    # --fast 1 runs the encoder's Snakes exact in float32: those outside the
    # --fast 0 census (none expected) are held against the plain version too
    assert {m for m, _ in census} == {"snake"}, census
    assert {m for m, _ in fast_census} <= {"snake", "snake_approx_bf16"}, fast_census
    assert {m for m, _ in stream_census} == {"snake"}, stream_census
    fast_exact = of_mode(fast_census, "snake")
    outside = sorted(set(fast_exact) - set(of_mode(census, "snake")))
    with torch.inference_mode():
        for shape in outside:
            snake_check(shape, gen, timed=False)
    rows = {"eval": snake_mode_row(census, "snake", gen, serve_census),
            "eval_fast": {**snake_mode_row(fast_census, "snake_approx_bf16", gen,
                                           serve_census),
                          "exact_launches": sum(fast_exact.values()),
                          "exact_shapes_outside_eval": len(outside)},
            "stream": snake_mode_row(stream_census, "snake", gen, serve_census),
            "stream_rvq": rvq_stream_row(k1_calls, stream_launches["rvq"], gen),
            "clips": n_clips, "formats": clip_formats}
    phase("eval", clips=n_clips, formats=formats,
          levels={lv: {m: (v["mean"] if isinstance(v, dict) else v)
                       for m, v in stats.items()} for lv, stats in levels.items()},
          per_class_top_level=sorted(report["per_class_top_level"]),
          codebook_entropy_bits=report["codebook_entropy_bits"],
          imp_map_energy_corr=report.get("imp_map_energy_corr"),
          seconds=seconds, visqol_ms_per_pair=seconds["visqol"] * 1000 / (
              n_clips * len(levels)),
          launches=launches, fast_launches=fast_launches,
          fast_si_sdr={lv: s["SI-SDR"]["mean"] for lv, s in fast_report["levels"].items()},
          plain_rel_err=plain_rel, one_clip_launches=one_launches,
          stream_launches=stream_launches,
          stream={k: v for k, v in stream.items() if k != "audio"},
          stream_vs_compress_si_sdr_db=stream_db,
          by_path=rows)
    return rows


def write_wavs(wav_dir: Path) -> Path:
    """``TRAIN_WAVS`` seeded 1 s clips at 44.1 kHz in ``wav_dir``."""
    wav_dir.mkdir()
    for i in range(TRAIN_WAVS):
        port.Signal(port.synthetic_clip(1.0, 44100, SEED + 100 + i),
                    44100).write(wav_dir / f"clip_{i:02d}.wav")
    return wav_dir


def train_config(wav_dir: Path) -> dict:
    """The flagship's training config (``conf/vrvq/vrvq_a2.yml``) as a dict
    on ``wav_dir``, at batch 16 x 0.38 s, 3 steps with a validation (one
    batch of 16 clips of 0.38 s) and a save at steps 0 and 2."""
    cfg = Config.load(FLAGSHIP_YAML, base_dir=REPO).to_dict()
    cfg.update({
        "train/build_dataset.folders": {"music": [str(wav_dir)]},
        "val/build_dataset.folders": {"music": [str(wav_dir)]},
        "train/AudioDataset.duration": TRAIN_DURATION_S,
        "val/AudioDataset.duration": TRAIN_DURATION_S,
        "val/AudioDataset.n_examples": TRAIN_BATCH,
        "batch_size": TRAIN_BATCH, "val_batch_size": TRAIN_BATCH,
        "num_iters": TRAIN_STEPS - 1, "valid_freq": 2, "seed": SEED,
    })
    return cfg


def same_bits(a, b, where: str = "") -> None:
    """Assert two state dicts (nested dicts, lists, tensors, numbers) equal
    bit for bit."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            same_bits(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            same_bits(x, y, f"{where}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert (a.dtype, a.shape, a.device) == (b.dtype, b.shape, b.device), where
        bits = (lambda t: t.reshape(-1).view(torch.uint8)) if a.is_floating_point() \
            else (lambda t: t)
        assert torch.equal(bits(a), bits(b)), where
    else:
        assert a == b, (where, a, b)


def snake_backward_check(shape, gen, approx: bool = False):
    """K2's backward in the float32 mode of ``approx`` against its plain
    version at ``shape``, timed."""
    x, alpha = kt.snake_inputs(shape, gen)
    g = torch.randn(shape, generator=gen).to(DEVICE)
    out = kt.time_snake_backward(snake_ops, x, alpha, g, approx=approx)
    dalpha_tol = SNAKE_APPROX_BWD_DALPHA_TOL if approx else SNAKE_BWD_DALPHA_TOL
    assert out["bit_identical"], (shape, out)
    assert out["dx_rel_err"] <= SNAKE_BWD_DX_TOL, (shape, out)
    assert out["dalpha_rel_err"] <= dalpha_tol, (shape, out)
    return out


def config_serve(model, signal, fused: bool = True, **request):
    """``serve`` of ``model`` at ``request``, against the port's plain path
    on the same clip: code flips split by near ties (the smallest top-2
    margin over all of the frame's stages), VBR counts, and the SI-SDR of the
    kernel decode against the plain decode of the same ``.dac``."""
    run = serve(model, signal, fused, **request)
    dac = run["dac"]
    plain = MarginProcessor(model)
    ref = plain.compress(signal, win_duration=WINDOW_S, **request)
    near_tie = np.concatenate(plain.margins, axis=-1) <= TIE_MARGIN
    split = flips(dac.codes, ref.codes, near_tie)
    assert split["flipped_off_tie"] == 0, f"{request}: codes differ off near ties: {split}"
    if "level" in request:
        assert np.array_equal(dac.vbr_counts, ref.vbr_counts), request
    else:
        assert dac.vbr_counts is None and dac.codes.shape[1] == request["n_quantizers"]
    sdr = si_sdr(run["out"].audio_data, plain.decompress(dac).audio_data)
    assert sdr >= MIN_SISDR_DB, (request, sdr)
    return {"request": request, "codes_shape": list(dac.codes.shape), **split,
            "decode_si_sdr_db": sdr, "dac_bytes": run["dac_bytes"],
            "launches": run["launches"],
            **{k: run[k] for k in ("encode_rtf", "decode_rtf")}}


def configs_phase(gen):
    """Every file of ``conf/`` through the port's reader; the CBR flagship
    (``conf/original_dac/cbr.yml``) at 8 and 4 stages and the 24 kbps model
    (``conf/vrvq/vrvq_a2_24k.yml``, 28 codebooks) at level 1 serve the
    10 s clip through K1; K1 timed at 28 stages on a window."""
    files = sorted(p.relative_to(REPO) for p in (REPO / "conf").rglob("*.yml"))
    cfgs = {str(p): Config.load(p, base_dir=REPO) for p in files}
    rows = {}
    cbr = port.build_model(model_config(cfgs["conf/original_dac/cbr.yml"]),
                           device=DEVICE, seed=SEED)
    signal = serve_clip(cbr)
    for nq in (8, 4):
        rows[f"cbr_nq{nq}"] = config_serve(cbr, signal, n_quantizers=nq)
    cbr_params = sum(p.numel() for p in cbr.parameters())
    del cbr
    m24 = port.build_model(model_config(cfgs["conf/vrvq/vrvq_a2_24k.yml"]),
                           device=DEVICE, seed=SEED)
    assert m24.n_codebooks == NQ_24KBPS
    rows["24kbps_level1"] = config_serve(m24, signal, level=1.0)
    window_frames = port.CodecProcessor(m24).window_geometry(WINDOW_S)[2]
    with torch.inference_mode():
        rvq_28 = rvq_check(rvq_ops.stack_quantizer_weights(m24.quantizer), gen,
                           window_frames)
    phase("configs", files=len(files), cbr_params=cbr_params,
          params_24kbps=sum(p.numel() for p in m24.parameters()),
          rvq_24kbps_window=rvq_28, **rows)
    del m24
    torch.cuda.empty_cache()
    return {**rvq_28, "launches": rows["24kbps_level1"]["launches"]["rvq"]}


def router_params(cfg) -> int:
    """Parameters of DAC_MOE's router: a Linear from the feature to Nq."""
    return cfg.feature_dim * cfg.n_codebooks + cfg.n_codebooks


def moe_vbr(moe, signal):
    """DAC_MOE's VBR serving path (``encode`` at a level, then
    ``decode_from_codes(codes, mask)``, one shot on the padded clip) with
    the kernels, against ``use_kernels(False)`` on the card: flips split by
    near ties, masks equal, decode SI-SDR; K2's launches of a clip at
    level 1 (counts cleared just before, read just after)."""
    plain = moe.clone(padding=True).use_kernels(False)
    audio = moe.preprocess(torch.from_numpy(
        np.asarray(signal.audio_data, np.float32)).to(DEVICE))
    out = {}
    with torch.inference_mode():
        weights = rvq_ops.stack_quantizer_weights(moe.quantizer)
        z = plain.encoder(audio)
        near_tie = (rvq_ops.reference_margins(
            z.transpose(1, 2).reshape(-1, z.shape[1]), *weights)
            <= TIE_MARGIN).reshape(z.shape[0], -1).cpu().numpy()
        for level in MOE_LEVELS:
            got, want = moe.encode(audio, level=level), plain.encode(audio, level=level)
            split = flips(got["codes"].cpu().numpy(), want["codes"].cpu().numpy(),
                          near_tie)
            assert split["flipped_off_tie"] == 0, (level, split)
            assert torch.equal(got["mask_imp"], want["mask_imp"]), level
            mask = got["mask_imp"]
            prefix = (mask[:, 1:] <= mask[:, :-1]).all(dim=1)
            out[str(level)] = {**split,
                               "mean_kept_stages": mask.sum(dim=1).mean().item(),
                               "prefix_mask_frames": prefix.float().mean().item()}
        build.LAUNCHES.clear()
        got = moe.encode(audio, level=1.0)
        kernel_audio = moe.decode_from_codes(got["codes"], got["mask_imp"])
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        plain_audio = plain.decode_from_codes(got["codes"], got["mask_imp"])
        sdr = si_sdr(kernel_audio.cpu().numpy(), plain_audio.cpu().numpy())
    assert sdr >= MIN_SISDR_DB, sdr
    assert set(launches) == {"snake"}, launches
    return {"levels": out, "decode_si_sdr_db": sdr, "launches_a_clip": launches}


def moe_train_step(moe, sr):
    """One train forward and backward of DAC_MOE at batch
    ``MOE_TRAIN_BATCH`` x ``TRAIN_DURATION_S`` with seeded draws: every
    parameter (the router's too) a finite non-zero gradient; K2's forward
    and backward launches."""
    moe.train()
    x = torch.from_numpy(np.concatenate([
        port.synthetic_clip(TRAIN_DURATION_S, sr, SEED + 200 + i)
        for i in range(MOE_TRAIN_BATCH)])).to(DEVICE)
    draws = torch.Generator(device=DEVICE).manual_seed(SEED)
    build.LAUNCHES.clear()
    out = moe(x, train=True, generator=draws)
    loss = ((out["audio"] - x).abs().mean() + out["vq/commitment_loss"]
            + out["vq/codebook_loss"])
    loss.backward()
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    bad = [n for n, p in moe.named_parameters()
           if p.grad is None or not bool(torch.isfinite(p.grad).all())
           or not bool(torch.count_nonzero(p.grad))]
    assert not bad, f"parameters without a finite non-zero gradient: {bad}"
    assert launches.get("snake", 0) == launches.get("snake_backward", -1) > 0, launches
    assert launches.get("rvq", 0) == 0, launches
    router = moe.quantizer.router.weight.grad.abs().max().item()
    moe.zero_grad(set_to_none=True)
    moe.eval()
    return {"batch": MOE_TRAIN_BATCH, "duration_s": TRAIN_DURATION_S,
            "loss": loss.item(), "launches": launches,
            "router_max_abs_grad": router,
            "params_with_gradient": sum(1 for _ in moe.parameters())}


def bf16_encoder(model, signal, gen):
    """The flagship through ``make_inference_model(encode_dtype=bfloat16)``
    and the exact fast profile, each serving the clip: K2's exact bfloat16
    mode bit-identical to its plain version at every shape the encoder gave
    it, timed over that census; K1 on the bfloat16 latents of three windows
    against the plain quantizer on the same latents; as numbers only, the
    codes and masks against the exact profile's, decode SI-SDR and RTFs."""
    runs = {"exact": serve(fast.make_inference_model(model), signal),
            "bf16_encoder": serve(fast.make_inference_model(
                model, encode_dtype=torch.bfloat16), signal)}
    run, exact = runs["bf16_encoder"], runs["exact"]
    census = of_mode(run["census"], "snake_bf16")
    assert census and run["launches"]["snake_bf16"] == sum(census.values())
    with torch.inference_mode():
        checks = [snake_check(s, gen, "snake_bf16") for s in sorted(census)]
    row = {**census_row(checks, census), "launches": run["launches"]["snake_bf16"],
           "path": "bf16_encoder"}
    proc = run["proc"]
    rvq = proc.prepared_rvq()[0]
    window, hop, _, _ = proc.window_geometry(WINDOW_S)
    audio = torch.from_numpy(np.asarray(signal.audio_data, np.float32)).to(DEVICE)
    k1 = []
    with torch.inference_mode():
        for i in range(3):
            z = proc.model_nopad.encoder(audio[..., i * hop: i * hop + window])
            frames = z.transpose(1, 2).reshape(-1, z.shape[1]).contiguous()
            c = kt.rvq_compare(rvq_ops, frames, rvq.weights, rvq, None)
            assert c["flipped_off_tie"] == 0 and c["max_abs_err"] <= ZQ_ATOL, c
            k1.append({"frames": frames.shape[0], **c})
    stage = np.arange(model.n_codebooks)[None, :, None]
    masks = [stage < r["dac"].vbr_counts[:, None, :] for r in (exact, run)]
    return row, {
        "k1_on_bf16_latents": k1,
        "snake_bf16_census": row,
        "code_share_differing_from_exact": float((run["dac"].codes
                                                  != exact["dac"].codes).mean()),
        "mask_agreement_with_exact": float((masks[0] == masks[1]).mean()),
        "decode_si_sdr_db_against_exact": si_sdr(run["out"].audio_data,
                                                 exact["out"].audio_data),
        "launches": run["launches"],
        **{f"{name}_{k}": r[k] for name, r in runs.items()
           for k in ("encode_rtf", "decode_rtf")}}


def models_phase(gen):
    """The model surface at flagship width (the ``DAC_VRVQ.*`` keys of
    ``conf/vrvq/vrvq_a2.yml``) on the serve phase's clip: DAC_MOE in VBR
    (encode at three levels, decode, the VBR compress raise), in CBR at 8
    and 4 stages through ``CodecProcessor``, and one train step; the
    bfloat16 encoder profile (returns its K2 row); per-stage codebook
    widths on the module path."""
    cfg = model_config(Config.load(FLAGSHIP_YAML, base_dir=REPO))
    moe = port.build_model(cfg, device=DEVICE, seed=SEED, model_class=port.DAC_MOE)
    with torch.device("meta"):
        n_imp = sum(p.numel() for p in ImportanceSubnet(
            cfg.feature_dim, cfg.feature_dim).parameters())
    n_moe = sum(p.numel() for p in moe.parameters())
    assert n_moe == FLAGSHIP_PARAMS - n_imp + router_params(cfg), n_moe
    signal = serve_clip(moe)
    vbr = moe_vbr(moe, signal)
    try:
        port.CodecProcessor(moe).compress(signal, win_duration=WINDOW_S, level=1.0)
        raise AssertionError("a VBR compress of DAC_MOE did not raise")
    except NotImplementedError as e:
        vbr["compress_raises"] = str(e)
    cbr = {f"nq{nq}": config_serve(moe, signal, fused=False, n_quantizers=nq)
           for nq in (8, 4)}
    train = moe_train_step(moe, moe.sample_rate)
    del moe
    torch.cuda.empty_cache()

    model = port.build_model(cfg, device=DEVICE, seed=SEED)
    bf16_row, bf16 = bf16_encoder(model, signal, gen)
    del model
    torch.cuda.empty_cache()

    wide = port.build_model(dataclasses.replace(cfg, codebook_dim=STAGE_WIDTHS),
                            device=DEVICE, seed=SEED)
    try:
        port.CodecProcessor(wide, fused_quantizer=True)
        raise AssertionError("the fused quantizer took mixed widths")
    except ValueError as e:
        fused_raise = str(e)
    run = serve(wide, signal, fused=False)
    dac = run["dac"]
    with tempfile.TemporaryDirectory() as tmp:
        back = port.DACFile.load(dac.save(Path(tmp) / "w.dac"))
    # a VBR .dac stores the codes its counts keep
    kept = np.arange(cfg.n_codebooks)[None, :, None] < dac.vbr_counts[:, None, :]
    assert np.array_equal(back.vbr_counts, dac.vbr_counts)
    assert np.array_equal(back.codes[kept], dac.codes[kept])
    assert np.isfinite(run["out"].audio_data).all()
    widths = {"codebook_dim": list(STAGE_WIDTHS),
              "params": sum(p.numel() for p in wide.parameters()),
              "codes_shape": list(dac.codes.shape),
              "mean_kept_codebooks": float(dac.vbr_counts.mean()),
              "dac_round_trip_exact": True, "fused_raises": fused_raise,
              **{k: run[k] for k in ("encode_rtf", "decode_rtf", "launches")}}
    del wide
    torch.cuda.empty_cache()
    phase("models", moe_params=n_moe, moe_vbr=vbr, moe_cbr=cbr, moe_train=train,
          bf16_encoder=bf16, stage_widths=widths)
    return bf16_row


def train_phase(gen):
    """See the module docstring. Returns the kernel rows of K2's forward and
    backward over the train step's census."""
    with tempfile.TemporaryDirectory() as tmp:
        cfg = train_config(write_wavs(Path(tmp) / "wavs"))
        save = Path(tmp) / "ckpt"
        torch.cuda.reset_peak_memory_stats()
        build.LAUNCHES.clear()
        run = trainer.train(cfg, str(save), device=DEVICE)
        torch.cuda.synchronize()
        launches = collections.Counter(build.LAUNCHES)
        state = run.train_state
        assert state.step == TRAIN_STEPS - 1, state.step
        n_gen = sum(p.numel() for p in state.generator.parameters())
        n_disc = sum(p.numel() for p in state.discriminator.parameters())
        assert n_gen == FLAGSHIP_PARAMS, n_gen

        # the saved `latest` against the trained state, bit for bit
        loaded = trainer.load({**cfg, "resume": True}, trainer.Tracker(), save,
                              resume=True, device=torch.device(DEVICE))
        for name in ("generator", "discriminator", "opt_g", "opt_d"):
            same_bits(getattr(loaded.train_state, name).state_dict(),
                      getattr(state, name).state_dict(), name)
        assert loaded.train_state.step == state.step
        del loaded

        # step 3 on the trained state: the uninterrupted run's next step,
        # with the Snake census of one train step and its launches
        step = TRAIN_STEPS - 1
        audio = trainer.prepare_audio(
            run.train_data, trainer.load_batch(run.train_data, step, TRAIN_BATCH),
            torch.device(DEVICE))
        with kt.snake_census(state.generator) as census:
            build.LAUNCHES.clear()
            metrics = run.train_step(state, audio, generator=trainer.step_generator(
                SEED, step, torch.device(DEVICE)))
            torch.cuda.synchronize()
            step_launches = dict(build.LAUNCHES)
        uninterrupted = {k: v.float().item() for k, v in metrics.items()}  # as train() logs
        per_step = sum(census.values())
        assert step_launches.get("snake_backward") == per_step, (step_launches, per_step)
        assert step_launches.get("snake") == per_step, (step_launches, per_step)
        assert step_launches.get("rvq", 0) == 0, step_launches
        no_grad = [f"{net}.{n}" for net, m in (("generator", state.generator),
                                                ("discriminator", state.discriminator))
                   for n, p in m.named_parameters()
                   if p.grad is None or not bool(torch.count_nonzero(p.grad))]
        assert not no_grad, f"parameters without a gradient: {no_grad}"

        # step 3 again, through train() resumed from `latest`: the same bits
        build.LAUNCHES.clear()
        resumed = trainer.train({**cfg, "num_iters": TRAIN_STEPS, "resume": True},
                                str(save), device=DEVICE)
        torch.cuda.synchronize()
        launches += build.LAUNCHES
        for name in ("generator", "discriminator", "opt_g", "opt_d"):
            same_bits(getattr(resumed.train_state, name).state_dict(),
                      getattr(state, name).state_dict(), f"resumed {name}")
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    step_metrics = run.metrics + resumed.metrics
    for m in step_metrics:
        assert all(np.isfinite(v) for v in m.values()), m
    assert launches.get("rvq", 0) == 0, launches
    assert launches.get("snake_backward") == TRAIN_STEPS * per_step, launches
    step_ms = run.step_ms + resumed.step_ms
    median_ms = float(np.median(step_ms[1:]))
    resume_diff = {k: resumed.metrics[0][k] - uninterrupted[k] for k in uninterrupted}
    assert resumed.metrics[0] == uninterrupted, resume_diff

    census = dict(census)
    bwd = [snake_backward_check(shape, gen) for shape in census]
    fwd = [snake_check(shape, gen) for shape in census]
    bwd_row = census_row(bwd, census)
    bwd_row.update(dx_rel_err=max(c["dx_rel_err"] for c in bwd),
                   dalpha_rel_err=max(c["dalpha_rel_err"] for c in bwd))
    fwd_row = census_row(fwd, census)
    phase("train", generator_params=n_gen, discriminator_params=n_disc,
          batch=TRAIN_BATCH, duration_s=TRAIN_DURATION_S, steps=len(step_ms),
          losses=step_metrics, step_ms=step_ms, data_ms=run.data_ms + resumed.data_ms,
          median_step_ms_2_to_4=median_ms,
          clips_per_s=TRAIN_BATCH / (median_ms / 1e3),
          peak_memory_gib=peak_gb, launches=dict(launches),
          launches_per_step={k: step_launches.get(k, 0)
                             for k in ("snake", "snake_backward", "rvq")},
          resumed_minus_uninterrupted_step3=resume_diff,
          resumed_state_bit_identical=True,
          snake_census=[[list(k), v] for k, v in sorted(census.items())],
          snake_backward=bwd_row, snake_forward=fwd_row,
          snake_backward_shapes=bwd)
    return {"snake_train": {**fwd_row, "launches": launches.get("snake", 0)},
            "snake_backward": {**bwd_row, "launches": launches["snake_backward"]},
            "per_step": per_step, "census": census,
            "fwd_checks": {tuple(c["shape"]): c for c in fwd},
            "bwd_checks": {tuple(c["shape"]): c for c in bwd}}


def start_cli(module: str, args):
    """Start ``python -m vrvq_tpu_torch.cli.<module> *args`` from the repo
    root; ``finish_cli`` waits for it."""
    cmd = [sys.executable, "-m", f"vrvq_tpu_torch.cli.{module}", *map(str, args)]
    return subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True), time.perf_counter()


def finish_cli(started, timeout: float = CLI_TIMEOUT_S):
    """The started CLI's last line of output (the train CLI's JSON summary)
    and its seconds; it must exit 0 within ``timeout``."""
    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, (proc.args, out[-2000:], err[-4000:])
    return out.strip().splitlines()[-1], time.perf_counter() - t0



def cli_overrides(wav_dir: Path, save: Path, steps: int, **extra) -> dict:
    """What points a config of ``conf/`` at the smoke's wavs and shortens its
    run: ``steps`` steps, a validation of one batch of 16 x 0.38 s (at the
    first and the last step, as the trainer validates), the save path."""
    folders = {"music": [str(wav_dir)]}
    return {"train/build_dataset.folders": folders,
            "val/build_dataset.folders": folders, "num_iters": steps,
            "val/AudioDataset.duration": TRAIN_DURATION_S,
            "val/AudioDataset.n_examples": TRAIN_BATCH,
            "val_batch_size": TRAIN_BATCH, "save_path": str(save), **extra}


def argv(overrides: dict):
    return [a for k, v in overrides.items() for a in (f"--{k}", repr(v))]


def to_cpu(tree):
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_cpu(v) for v in tree)
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


def cli_phase(gen):
    """The train CLI on ``vrvq_a2_b64_1chip.yml`` at flagship width for
    ``CLI_STEPS`` accumulated steps (the polynomial backward launched, every
    parameter a non-zero gradient, finite falling losses); its step-1
    checkpoint loaded in this process and held bit for bit against the
    file, then one more accumulated step here under the Snake census (both
    modes, the launches of a step); the train CLI on ``cbr.yml`` for
    ``CBR_STEPS`` steps at batch 16; the inference CLI on the first run's
    last checkpoint, one example of 1 s. Returns the kernel rows of the
    polynomial forward and backward over the accumulated step's census."""
    with tempfile.TemporaryDirectory() as tmp:
        wav_dir = write_wavs(Path(tmp) / "wavs")
        save = Path(tmp) / "b64"
        over = cli_overrides(wav_dir, save, CLI_STEPS, save_iters=[0])
        cfg = Config.load(B64_YAML, base_dir=REPO)
        cfg.update(over)
        batch = int(cfg["batch_size"])
        micro = batch // int(cfg["grad_accum_steps"])
        line, b64_s = finish_cli(start_cli("train", ["--args.load", B64_YAML,
                                                      *argv(over)]))
        b64 = json.loads(line)
        launches = b64["launches"]
        assert b64["steps"] == CLI_STEPS and b64["device"] == torch.cuda.get_device_name(0)
        assert launches.get("snake_approx_backward", 0) > 0, launches
        assert launches.get("snake_approx", 0) > 0 and launches.get("rvq", 0) == 0
        assert not b64["params_without_gradient"], b64["params_without_gradient"]
        losses = [m["loss"] for m in b64["metrics"]]
        assert all(np.isfinite(v) for m in b64["metrics"] for v in m.values())
        assert losses[-1] < losses[0], losses
        assert all(m["other/batch_size"] == batch for m in b64["metrics"])

        # the step-1 checkpoint, loaded here, against the file bit for bit
        state = trainer.load(cfg, trainer.Tracker(), save, resume=True, tag="0k",
                             device=DEVICE)
        saved = torch.load(save / "0k" / "state.pt", map_location="cpu",
                           weights_only=True)
        ts = state.train_state
        assert ts.step == saved["step"] == 1
        for name in ("generator", "discriminator", "opt_g", "opt_d"):
            same_bits(to_cpu(getattr(ts, name).state_dict()), saved[name], name)
        del saved

        # step 1 again, here, under the census of both Snake modes
        audio = trainer.prepare_audio(
            state.train_data, trainer.load_batch(state.train_data, 1, batch),
            torch.device(DEVICE))
        with kt.snake_census(ts.generator, by_mode=True) as census:
            build.LAUNCHES.clear()
            metrics = state.train_step(ts, audio, generator=trainer.step_generator(
                SEED, 1, torch.device(DEVICE)))
            torch.cuda.synchronize()
            step_launches = dict(build.LAUNCHES)
        step1 = {k: v.item() for k, v in metrics.items()}
        fwd = of_mode(census, "snake_approx")
        # the generator runs twice a micro-batch (the discriminator's phase
        # without a graph), so each shape's backward launches are half its
        # forward's
        bwd = {s: n // 2 for s, n in fwd.items()}
        assert step_launches["snake_approx"] == sum(fwd.values()), step_launches
        assert step_launches["snake_approx_backward"] == sum(bwd.values()), step_launches
        assert all(sh[0] == micro for sh in fwd), fwd
        del state, ts, audio
        torch.cuda.empty_cache()

        # the CBR run and the sweep of the first run's checkpoint, side by side
        cbr_save, results = Path(tmp) / "cbr", Path(tmp) / "results"
        cbr_run = start_cli("train", ["--args.load", CBR_YAML, *argv(cli_overrides(
            wav_dir, cbr_save, CBR_STEPS, batch_size=TRAIN_BATCH))])
        infer_run = start_cli("inference", [
            "--args.load", B64_YAML, "--ckpt_dir", save, "--tag", "latest",
            "--data_dir", wav_dir, "--save_result_dir", results,
            "--num_examples", 1, "--duration", 1.0])
        line, cbr_s = finish_cli(cbr_run)
        _, infer_s = finish_cli(infer_run)
        cbr = json.loads(line)
        assert cbr["steps"] == CBR_STEPS and not cbr["params_without_gradient"]
        assert all(np.isfinite(v) for m in cbr["metrics"] for v in m.values())
        assert cbr["launches"].get("snake_backward", 0) > 0
        assert "vq/rate_loss" not in cbr["metrics"][0]
        meta = json.loads((results / "0" / "metadata.json").read_text())
        pngs = sorted(p.name for p in (results / "0").glob("imp_map_*.png"))
        assert len(meta) == len(pngs) == 12, (meta, pngs)

    gen_fwd = [snake_check(sh, gen, "snake_approx") for sh in sorted(fwd)]
    gen_bwd = [snake_backward_check(sh, gen, approx=True) for sh in sorted(bwd)]
    fwd_row, bwd_row = census_row(gen_fwd, fwd), census_row(gen_bwd, bwd)
    bwd_row.update(dx_rel_err=max(c["dx_rel_err"] for c in gen_bwd),
                   dalpha_rel_err=max(c["dalpha_rel_err"] for c in gen_bwd))
    step_ms = b64["step_ms"]
    median_ms = float(np.median(step_ms[1:]))
    phase("cli", config=B64_YAML,
          reductions={"num_iters": CLI_STEPS, "val/AudioDataset.n_examples": TRAIN_BATCH,
                      "val_batch_size": TRAIN_BATCH,
                      "val/AudioDataset.duration": TRAIN_DURATION_S,
                      "save_iters": [0], "folders": f"{TRAIN_WAVS} seeded 1 s wavs"},
          batch=batch, micro_batch=micro, steps=b64["steps"], step_ms=step_ms,
          data_ms=b64["data_ms"], median_step_ms_2_to_3=median_ms,
          clips_per_s=batch / (median_ms / 1e3), peak_memory_gib=b64["peak_memory_gib"],
          losses=b64["metrics"], launches=launches, cli_train_s=b64_s,
          step1_here=step1, launches_per_step=step_launches,
          snake_census=[[list(k), v] for k, v in sorted(census.items())],
          snake_approx_forward=fwd_row, snake_approx_backward=bwd_row,
          cbr={"config": CBR_YAML, "batch": TRAIN_BATCH, "steps": cbr["steps"],
               "losses": cbr["metrics"], "launches": cbr["launches"],
               "peak_memory_gib": cbr["peak_memory_gib"]},
          inference={"examples": 1, "duration_s": 1.0, "levels": len(meta),
                     "metadata": meta},
          # the two processes shared the card, so no step time of the CBR
          # run is kept and their seconds are not those of either alone
          cbr_and_inference_cli_s_sharing_the_card=[cbr_s, infer_s])
    return {"snake_approx_train": {**fwd_row, "launches": launches["snake_approx"]},
            "snake_approx_backward": {**bwd_row,
                                      "launches": launches["snake_approx_backward"]},
            "per_step": {"forward": sum(fwd.values()), "backward": sum(bwd.values())}}


def trained_phase(gen, serve_census, train_rows):
    """A harmonic corpus from ``cli.make_synth_dataset``, ``cli.train`` on
    ``vrvq_a2_synth_demo.yml`` at flagship width from it for
    ``TRAINED_STEPS`` steps (both CLIs' ``main`` in this process, the
    training under the census of K2's forward and backward calls),
    ``cli.measure_trained`` on that checkpoint (its floor of 1000 steps
    refused, then passed with ``min_steps=0``: the verdicts mean nothing
    this early; every line and the probe checked), ``cli.evaluate`` of it at
    the 12 default levels on ``TRAINED_EVAL_CLIPS`` test clips; K2 in each
    mode over the training's, the measurement's and the evaluation's
    censuses and K1 at every frame count of the measurement's calls, against
    their plain versions (a shape the train phase checked is not checked
    again). Returns the kernel rows."""
    with tempfile.TemporaryDirectory() as tmp:
        corpus, save = Path(tmp) / "data_synth", Path(tmp) / "synth_demo"
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            cli_synth.main(["--out", str(corpus), *(a for k, n in TRAINED_CORPUS.items()
                                                    for a in (f"--{k}", str(n)))])
        corpus_s = time.perf_counter() - t0
        assert printed.getvalue().splitlines() == [
            f"{s}: {n} x 2.0s -> {corpus / s}" for s, n in TRAINED_CORPUS.items()]
        wavs = {s: sorted(p.name for p in (corpus / s).glob("*.wav"))
                for s in TRAINED_CORPUS}
        assert {s: len(w) for s, w in wavs.items()} == TRAINED_CORPUS, wavs
        assert wavs["test"][0] == "test_0000.wav", wavs["test"]
        over = {"train/build_dataset.folders": {"music": [str(corpus / "train")]},
                "val/build_dataset.folders": {"music": [str(corpus / "val")]},
                "num_iters": TRAINED_STEPS, "save_path": str(save)}
        t0 = time.perf_counter()
        with snake_backward_calls() as bwd_calls, \
                contextlib.redirect_stdout(io.StringIO()):
            run, launches, train_census = counted(
                cli_train.main, ["--args.load", SYNTH_DEMO_YAML, *argv(over)])
        train_s = time.perf_counter() - t0
        assert run["launches"] == launches, (run["launches"], launches)
        assert run["steps"] == TRAINED_STEPS and not run["params_without_gradient"]
        assert all(np.isfinite(v) for m in run["metrics"] for v in m.values())
        assert launches.get("rvq", 0) == 0 and launches.get("snake", 0) > 0, launches
        assert {m for m, _ in train_census} == {"snake"}, train_census
        bwd_census = of_mode(bwd_calls, "snake_backward")
        assert set(bwd_calls) == {("snake_backward", sh) for sh in bwd_census}, bwd_calls
        assert launches.get("snake_backward") == sum(bwd_census.values()) == (
            TRAINED_STEPS * train_rows["per_step"]), (launches, train_rows["per_step"])
        torch.cuda.empty_cache()

        try:
            cli_measure.trained_flagship(save, device=DEVICE, config=SYNTH_DEMO_YAML)
            raise AssertionError(f"a checkpoint of {TRAINED_STEPS} steps was not refused")
        except SystemExit as exc:
            refused = str(exc)
        model = cli_measure.trained_flagship(save, min_steps=0, device=DEVICE,
                                             config=SYNTH_DEMO_YAML)
        lines = []
        t0 = time.perf_counter()
        with rvq_calls() as calls:
            _, measure_launches, census = counted(
                cli_measure.measure, model, *TRAINED_MEASURE, str(save),
                str(corpus / "test"), emit=lines.append)
        measure_s = time.perf_counter() - t0
        names = [ln.get("gate", ln.get("profile")) for ln in lines[1:]]
        assert names == ([g for g, _ in cli_measure.GATES]
                         + [f"{t}_vs_base_TRAINED" for t, _ in cli_measure.PACKED_DECODERS]
                         + [p for p, _ in cli_measure.PROFILES]), names
        probe = f"held-out corpus {corpus / 'test'} (8 clips)"
        assert all(ln["probe"] == probe for ln in lines[1:3]), lines[1:3]
        assert all(ln["forward_ms"] > 0 for ln in lines[7:]), lines[7:]
        assert {m for m, _ in census} == {"snake", "snake_approx",
                                          "snake_approx_bf16"}, census
        assert measure_launches.get("rvq", 0) > 0, measure_launches
        del model
        torch.cuda.empty_cache()

        with contextlib.redirect_stdout(io.StringIO()):  # the report is kept below
            report, eval_launches, eval_census = counted(cli_eval.main, [
                "--args.load", SYNTH_DEMO_YAML, "--ckpt_dir", str(save), "--tag",
                "latest", "--data_dir", str(corpus / "test"), "--num_examples",
                str(TRAINED_EVAL_CLIPS), "--duration", "2.0", "--out",
                str(Path(tmp) / "eval.json")])
    levels = report["levels"]
    kbps = [lv["kbps"] for lv in levels.values()]
    assert len(levels) == 12, list(levels)
    assert all(b >= a for a, b in zip(kbps, kbps[1:])) and kbps[-1] > kbps[0], kbps
    assert {m for m, _ in eval_census} == {"snake", "snake_approx_bf16"}, eval_census

    rows = {"snake_trained_train": snake_mode_row(
        train_census, "snake", gen, train_rows["census"], known=train_rows["fwd_checks"])}
    bwd = [train_rows["bwd_checks"].get(sh) or snake_backward_check(sh, gen)
           for sh in sorted(bwd_census)]
    rows["snake_backward_trained_train"] = {
        **census_row(bwd, bwd_census), "launches": launches["snake_backward"],
        "new_shapes": len(set(bwd_census) - set(train_rows["census"]))}
    rows.update({f"{mode}_trained_measure": snake_mode_row(census, mode, gen, serve_census)
                 for mode in ("snake", "snake_approx", "snake_approx_bf16")})
    rows.update({f"{mode}_trained_eval": snake_mode_row(eval_census, mode, gen,
                                                         serve_census)
                 for mode in ("snake", "snake_approx_bf16")})
    rows["fused_rvq_trained"] = rvq_stream_row(calls, measure_launches["rvq"], gen)
    phase("trained", config=SYNTH_DEMO_YAML, corpus={**TRAINED_CORPUS, "seconds": 2.0},
          reductions={"num_iters": TRAINED_STEPS, "corpus": TRAINED_CORPUS,
                      "measure_batch_x_seconds": list(TRAINED_MEASURE),
                      "eval_clips": TRAINED_EVAL_CLIPS},
          corpus_cli_s=corpus_s, train_cli_s=train_s, step_ms=run["step_ms"],
          train_snake_census=[[list(k), v] for k, v in sorted(train_census.items())],
          train_snake_backward_census=[[list(k), v] for k, v in sorted(bwd_census.items())],
          losses=run["metrics"], train_launches=launches,
          peak_memory_gib=run["peak_memory_gib"], refused_under_1000_steps=refused,
          measure_lines=lines, measure_s=measure_s, measure_launches=measure_launches,
          eval_levels={lv: {m: stats[m]["mean"] for m in ("SI-SDR", "mel")}
                       | {"kbps": stats["kbps"]} for lv, stats in levels.items()},
          eval_launches=eval_launches,
          kernel_rows={k: {f: v for f, v in r.items() if f != "frames"}
                       for k, r in rows.items()},
          rvq_frames=rows["fused_rvq_trained"]["frames"])
    return rows


def write_flac_clip(job) -> str:
    """A process-pool job: ``(path, seconds, seed, kind)``'s seeded 44.1 kHz
    clip (``port.synthetic_clip``) as 16-bit flac with ``kind`` subframes of
    order 2, the samples that ``Signal.write`` puts in a wav of that clip."""
    path, seconds, seed, kind = job
    x = port.synthetic_clip(seconds, 44100, seed)[0]
    pcm = np.round(np.clip(x, -1.0, 1.0) * 32767.0).astype(np.int64)
    tests_module("flac_encoder").write_flac(Path(path), pcm, 44100, block_size=4096,
                                            subframe_kind=kind, order=2)
    return path


def host_ms(fn, *args, repeat: int = 3):
    """The least host ms of ``repeat`` calls of ``fn(*args)``, and its result."""
    best, out = float("inf"), None
    for _ in range(repeat):
        t0 = time.perf_counter()
        out = fn(*args)
        best = min(best, 1e3 * (time.perf_counter() - t0))
    return best, out


def reader_rows(clips):
    """Each of the eval phase's clips (wav, LPC flac, fixed flac) read natively
    and by the plain reader, bit for bit, with host ms per second of audio;
    the native loudness of its 0.38 s excerpts against the numpy meter, ms per
    excerpt."""
    rows, n_calls = {}, dict(native_io.IO_CALLS)
    for name, path in clips.items():
        kind = "wav" if path.suffix == ".wav" else "flac"
        plain = (audio_io.read_wav_np if kind == "wav" else flac_py.read_flac)
        native_ms, (got, sr) = host_ms(getattr(native_io, f"read_{kind}"), path)
        plain_ms, (want, _) = host_ms(plain, path, repeat=1 if kind == "flac" else 3)
        assert np.array_equal(got, want), name
        seconds = got.shape[-1] / sr
        rows[name] = {"native_ms_per_audio_s": native_ms / seconds,
                      "plain_ms_per_audio_s": plain_ms / seconds, "bit_exact": True}
    for kind in ("wav", "flac"):
        assert native_io.IO_CALLS[f"{kind}_native"] > n_calls.get(f"{kind}_native", 0)
    x = audio_io.read_wav(clips["wav"])[0]
    n = int(IO_EXCERPT_S * 44100)
    excerpts = [x[:, i * n:(i + 1) * n] for i in range(x.shape[-1] // n)]
    native_ms, native = host_ms(lambda: [native_io.loudness(e, 44100) for e in excerpts])
    plain_ms, plain = host_ms(lambda: [float(integrated_loudness(
        e[None].astype(np.float64), 44100)[0]) for e in excerpts])
    diff = max(abs(a - b) for a, b in zip(native, plain))
    assert diff <= 1e-9, (native, plain)
    rows["loudness"] = {"excerpts": len(excerpts), "excerpt_s": IO_EXCERPT_S,
                        "native_ms_per_excerpt": native_ms / len(excerpts),
                        "plain_ms_per_excerpt": plain_ms / len(excerpts),
                        "max_abs_diff_lu": diff, "native_lufs": native}
    return rows


@contextlib.contextmanager
def python_range_coder():
    """While open, the entropy ``.dac`` and ``PacketCodec`` code with the
    Python range coder (the plain version) in place of the native one."""
    saved = (codec_mod.encode_adaptive, codec_mod.decode_adaptive,
             streaming.AdaptiveCoder)
    codec_mod.encode_adaptive = functools.partial(rangecoder.encode_adaptive,
                                                  backend="python")
    codec_mod.decode_adaptive = functools.partial(rangecoder.decode_adaptive,
                                                  backend="python")
    streaming.AdaptiveCoder = functools.partial(rangecoder.AdaptiveCoder,
                                                backend="python")
    try:
        yield
    finally:
        codec_mod.encode_adaptive, codec_mod.decode_adaptive, \
            streaming.AdaptiveCoder = saved


def range_code(serve_dac, chunks, folder: Path, codebook_size: int, n_codebooks: int):
    """The serve phase's ``.dac`` range-coded and read back, and the pool's
    chunks as ``PacketCodec`` packets, stream by stream: the bytes, and
    host ms of each part."""
    t0 = time.perf_counter()
    path = serve_dac.save(folder / "rc.dac", entropy=True, codebook_size=codebook_size)
    t1 = time.perf_counter()
    back = port.DACFile.load(path)
    t2 = time.perf_counter()
    assert np.array_equal(back.vbr_counts, serve_dac.vbr_counts)
    packets = []
    for sid in sorted({sid for sid, _, _ in chunks}):
        tx = streaming.PacketCodec(n_codebooks, codebook_size)
        rx = streaming.PacketCodec(n_codebooks, codebook_size)
        for s, codes, cnt in chunks:
            if s == sid:
                packets.append(tx.pack(codes, cnt))
                assert np.array_equal(rx.unpack(packets[-1])[1], cnt)
    t3 = time.perf_counter()
    return {"dac": path.read_bytes(), "packets": packets,
            "dac_save_ms": 1e3 * (t1 - t0), "dac_load_ms": 1e3 * (t2 - t1),
            "packets_ms": 1e3 * (t3 - t2)}


def range_coder_row(serve_dac, chunks, folder: Path, cfg):
    """Both backends on the same codes: byte-identical files and packets,
    host ms per window of each."""
    calls = native_io.IO_CALLS["rc_encode_native"]
    native = range_code(serve_dac, chunks, folder, cfg.codebook_size, cfg.n_codebooks)
    assert native_io.IO_CALLS["rc_encode_native"] > calls
    with python_range_coder():
        plain = range_code(serve_dac, chunks, folder, cfg.codebook_size, cfg.n_codebooks)
    assert native["dac"] == plain["dac"] and native["packets"] == plain["packets"]
    windows = -(-serve_dac.codes.shape[-1] // serve_dac.chunk_length)
    per = {}
    for name, out in (("native", native), ("python", plain)):
        per[name] = {"dac_ms_per_window": (out["dac_save_ms"] + out["dac_load_ms"]) / windows,
                     "packet_ms_per_window": out["packets_ms"] / len(chunks)}
    return {"dac_windows": windows, "dac_bytes": len(native["dac"]),
            "packets": len(chunks), "packet_bytes": sum(map(len, native["packets"])),
            "byte_identical": True, **per}


def trainer_io_run(clips: Path, save: Path, workers: int):
    """``train()`` of the flagship with MSD on ``clips``: ``IO_STEPS`` steps at
    batch 16 x 0.38 s, ``workers`` loader threads (0: serial), samples of
    ``IO_VAL_IDX`` at every step. Returns the run, its kernel launches and
    its Snake census (every call, by mode)."""
    cfg = train_config(clips)
    cfg.update({"Discriminator.rates": IO_RATES, "num_workers": workers,
                "sample_freq": 1, "val_idx": IO_VAL_IDX, "num_iters": IO_STEPS})
    with kt.snake_census(by_mode=True) as census:
        build.LAUNCHES.clear()
        run = trainer.train(cfg, str(save), device=DEVICE)
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
    return run, launches, census


def msd_host_syncs(disc) -> dict:
    """Each MSD's forward (with its in-graph resample) at a train batch, run
    with CUDA's sync debug mode set to error: an operation that makes the
    host wait for the card raises. The taps were built on the card by the
    run's steps. Returns the warnings the whole discriminator's forward
    raises in warn mode, by message (reported, not held to a bar)."""
    gen = torch.Generator(DEVICE).manual_seed(SEED)
    x = torch.randn(TRAIN_BATCH, 1, int(TRAIN_DURATION_S * 44100), device=DEVICE,
                    generator=gen)
    msds = [n for n in disc.names if n.startswith("msd")]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for name in msds:
            getattr(disc, name)(x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            disc(x)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return {"msd_forward_syncs": 0, "checked": msds,
            "discriminator_forward_sync_warnings": dict(collections.Counter(
                str(w.message).splitlines()[0][:120] for w in caught))}


def trainer_io_phase(gen, serve_dac, chunks, train_rows):
    """See the module docstring. Returns K2's forward row over the prefetched
    flac run's census and its backward launches."""
    cfg = port.FLAGSHIP
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        flacs, wavs, evals = tmp / "flac", tmp / "wav", tmp / "eval"
        flacs.mkdir()
        evals.mkdir()
        jobs = [(str(flacs / f"clip_{i:02d}.flac"), 1.0, SEED + 100 + i, "lpc")
                for i in range(TRAIN_WAVS)]
        # the eval phase's wav and flac clips (and its fixed-subframe flac)
        jobs += [(str(evals / "lpc.flac"), EVAL_CLIP_S, SEED + 201, "lpc"),
                 (str(evals / "fixed.flac"), EVAL_CLIP_S, SEED + 201, "fixed")]
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(min(8, os.cpu_count() or 1)) as pool:
            pending = pool.map_async(write_flac_clip, jobs)
            write_wavs(wavs)
            audio_io.write_wav(evals / "clip.wav",
                               port.synthetic_clip(EVAL_CLIP_S, 44100, SEED + 200)[0], 44100)
            coder = range_coder_row(serve_dac, chunks, tmp, cfg)
            pending.get(timeout=300)
        readers = reader_rows({"wav": evals / "clip.wav", "flac_lpc": evals / "lpc.flac",
                               "flac_fixed": evals / "fixed.flac"})

        io_before = dict(native_io.IO_CALLS)
        runs, data_ms = {}, {}
        for fmt, folder in (("flac", flacs), ("wav", wavs)):
            for workers in (0, IO_WORKERS):
                run, launches, census = trainer_io_run(folder, tmp / f"{fmt}{workers}",
                                                       workers)
                data_ms[f"{fmt}_{'prefetched' if workers else 'serial'}"] = run.data_ms
                if not workers:  # what data_ms holds: the load, then the transforms
                    load_ms, batch = host_ms(trainer.load_batch, run.train_data, 1,
                                             TRAIN_BATCH)
                    data_ms[f"{fmt}_load_step1_ms"] = load_ms
                    data_ms[f"{fmt}_transform_step1_ms"] = host_ms(
                        lambda: (trainer.prepare_audio(run.train_data, batch, DEVICE),
                                 torch.cuda.synchronize()))[0]
                if (fmt, workers) == ("flac", IO_WORKERS):
                    io_launches, io_census, save = launches, census, tmp / f"{fmt}{workers}"
                runs[fmt, workers] = run
                if (fmt, workers) != ("flac", IO_WORKERS):
                    continue
                # the prefetcher's batches are load_batch's
                with trainer.BatchPrefetcher(run.train_data, TRAIN_BATCH, 0,
                                             IO_WORKERS) as batches:
                    for step in range(IO_STEPS):
                        got = next(batches)[1]["signal"].audio_data
                        want = trainer.load_batch(run.train_data, step, TRAIN_BATCH)
                        assert np.array_equal(got, want["signal"].audio_data), step
        io_calls = {k: native_io.IO_CALLS[k] - io_before.get(k, 0)
                    for k in ("flac_native", "wav_native", "loudness_native")}
        assert min(io_calls.values()) > 0, io_calls

        run = runs["flac", IO_WORKERS]
        ts = run.train_state
        assert ts.step == IO_STEPS
        disc = ts.discriminator
        assert [n for n in disc.names if n.startswith("msd")] == ["msd_1", "msd_2"]
        no_grad = [n for n, p in disc.named_parameters()
                   if p.grad is None or not bool(torch.count_nonzero(p.grad))]
        assert not no_grad, f"discriminator parameters without a gradient: {no_grad}"
        msd_syncs = msd_host_syncs(disc)
        # the same run loaded serially, and both runs on the wav corpus of the
        # same samples: the same losses, gradients and parameters, bit for bit
        ref, agree = snapshot(ts), {}
        for key in (("flac", 0), ("wav", 0), ("wav", IO_WORKERS)):
            other = runs.pop(key)
            err = max(loss_rel_err(m, want) for m, want in zip(other.metrics, run.metrics))
            snap = snapshot(other.train_state)
            a = agreement(snap, ref, ref["params"])
            assert other.metrics == run.metrics, (key, err, other.metrics, run.metrics)
            same_bits(snap, ref, f"trainer_io {key}")
            agree[f"{key[0]}_{'prefetched' if key[1] else 'serial'}"] = {
                "max_loss_rel_err": err, "grad_rel_l2": a["grad_rel_l2"],
                "param_rel_l2": a["param_rel_l2"]}
            del other
        del ref
        torch.cuda.empty_cache()

        # K2: every Snake call launched, the backward at the train census
        per_step = train_rows["per_step"]
        exact = of_mode(io_census, "snake")
        assert {m for m, _ in io_census} == {"snake"}, io_census
        assert io_launches.get("snake") == sum(exact.values()), (io_launches, exact)
        assert io_launches.get("snake_backward") == IO_STEPS * per_step, io_launches
        assert io_launches.get("rvq", 0) == 0, io_launches

        events = read_events(save / "logs")
        kinds = {tag: sorted({k for _, k, _ in vals}) for tag, vals in events.items()}
        for tag, kind in (("loss/train", "simple_value"), ("mel/loss/val", "simple_value"),
                          ("adv/disc_loss/train", "simple_value")):
            assert kinds.get(tag) == [kind], (tag, kinds)
        for i in range(len(IO_VAL_IDX)):
            assert kinds.get(f"signal/sample_{i}.wav") == ["audio"], kinds
            assert [s for s, _, _ in events[f"recons/sample_{i}.wav"]] == list(range(IO_STEPS))
            assert kinds.get(f"recons/sample_{i}.wav") == ["audio"], kinds
            assert kinds.get(f"imp_map/sample_{i}") == ["image"], kinds

        # export the run's generator; the file loads back to the same decode
        weights = tmp / "weights.pth"
        t0 = time.perf_counter()
        cli_export.main(["--args.load", FLAGSHIP_YAML, "--ckpt_dir", str(save),
                         "--tag", "latest", "--out", str(weights)])
        export_s = time.perf_counter() - t0
        load_cfg = parse_args(["--args.load", FLAGSHIP_YAML, "--torch_ckpt", str(weights)],
                              base_dir=REPO)
        back = load_gen_params(load_cfg, port.DAC_VRVQ(model_config(load_cfg)), DEVICE)
        clip = torch.from_numpy(port.synthetic_clip(1.0, 44100, SEED + 300)).to(DEVICE)
        with torch.inference_mode():
            want = ts.generator.eval()(clip, level=1.0)["audio"]
            got = back.eval()(clip, level=1.0)["audio"]
        assert torch.equal(got, want), float((got - want).abs().max())
        weights_mb = weights.stat().st_size / 2 ** 20
        del back, run, ts, disc, runs
    torch.cuda.empty_cache()
    row = snake_mode_row(io_census, "snake", gen, train_rows["census"])
    phase("trainer_io", readers=readers, range_coder=coder,
          train={"steps": IO_STEPS, "batch": TRAIN_BATCH, "duration_s": TRAIN_DURATION_S,
                 "rates": IO_RATES, "workers": IO_WORKERS, "val_idx": IO_VAL_IDX,
                 "corpus": f"{TRAIN_WAVS} seeded 1 s clips, LPC flac and 16-bit wav "
                           "of the same samples",
                 "data_ms": data_ms, "agreement_with_flac_prefetched": agree,
                 "native_io_calls": io_calls, "launches": io_launches,
                 "host_syncs": msd_syncs,
                 "snake_forward": row,
                 "event_tags": {tag: kinds[tag] for tag in sorted(kinds)}},
          export={"weights_mib": weights_mb, "cli_s": export_s,
                  "decode_bit_exact": True})
    return {"forward": row, "backward_launches": io_launches["snake_backward"]}


def params_of(ts):
    """Both networks' parameters by name (``generator.*``, ``discriminator.*``)."""
    return {f"{net}.{n}": p for net, m in (("generator", ts.generator),
                                            ("discriminator", ts.discriminator))
            for n, p in m.named_parameters()}


def digest(ts) -> str:
    """A hash of every parameter's bits."""
    h = hashlib.sha256()
    for p in params_of(ts).values():
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def rel_l2(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def snapshot(ts):
    """Both networks' parameters and the gradients their last update took
    (averaged over the ranks and clipped), on the host."""
    ps = params_of(ts)
    return {"params": {k: p.detach().to("cpu", copy=True) for k, p in ps.items()},
            "grads": {k: p.grad.to("cpu", copy=True) for k, p in ps.items()}}


def agreement(snap, ref, theta0) -> dict:
    """How far one step 1 (``snap``) is from another (``ref``), both from
    the parameters ``theta0``: the relative L2 of the gradients the update
    took (its direction), each network's as one vector, and of the
    parameters of both (what the bars hold), beside the latter's reading
    for a state the step left unchanged; and, to read beside the card's own
    spread between two runs of one step, the largest relative L2 of one
    tensor's gradient, the update's (new minus old) relative L2 and the
    elements whose update took the other sign. Adam's first update is about
    lr x sign(g): an element whose gradient is float noise (another order of
    a sum) may step the other way, which moves a small tensor far in
    relative terms."""
    names = list(ref["params"])

    def flat(tree, net=""):
        return torch.cat([tree[k].reshape(-1) for k in names if k.startswith(net)])

    new, old, base = flat(snap["params"]), flat(ref["params"]), flat(theta0)
    du, dr = new - base, old - base
    return {"grad_rel_l2": {net: rel_l2(flat(snap["grads"], net + "."),
                                        flat(ref["grads"], net + "."))
                            for net in ("generator", "discriminator")},
            "param_rel_l2": rel_l2(new, old),
            "param_rel_l2_unchanged": rel_l2(base, old),
            "max_tensor_grad_rel_l2": max(rel_l2(snap["grads"][k], g)
                                          for k, g in ref["grads"].items()),
            "update_rel_l2": rel_l2(du, dr),
            "update_sign_flips": int(((du > 0) != (dr > 0)).sum()),
            "elements": int(new.numel())}


def rank_steps(state, batch_size, rows, draws, device, steps: int):
    """Step 1 of the parallel phase's batch (this rank's ``rows`` of
    ``batch_size``) on the pinned ``draws``; then steps 2.. on the loader's
    batches and the step generator's draws, timed. Returns step 1's metrics,
    its launches and the later steps' ms."""
    ts = state.train_state

    def batch(step):
        return trainer.prepare_audio(state.train_data, trainer.load_batch(
            state.train_data, step, batch_size, rows), device)

    audio = batch(0)
    build.LAUNCHES.clear()
    metrics = state.train_step(ts, audio, levels=draws["levels"], depths=draws["depths"])
    trainer._sync(device)
    launches = dict(build.LAUNCHES)
    step1 = {k: v.item() for k, v in metrics.items()}
    ms = []
    for step in range(1, steps):
        audio = batch(step)
        trainer._sync(device)
        t0 = time.perf_counter()
        state.train_step(ts, audio, generator=trainer.step_generator(SEED, step, device))
        trainer._sync(device)
        ms.append(1e3 * (time.perf_counter() - t0))
    return step1, launches, ms


def parallel_rank(device, root: str, steps: int) -> None:
    """One rank of the parallel phase's groups: ``trainer.load`` with ZeRO,
    this rank's rows of the global batch, ``rank_steps`` (step 1 under the
    Snake census); rank 0 also keeps its ``snapshot`` after step 1
    (``snap0.pt``); every rank checks the optimizers' consolidated state
    dicts (the replicated layout on rank 0). Writes ``rank{r}.json``."""
    root = Path(root)
    case = torch.load(root / "case.pt", weights_only=False)
    rank, world, batch = pdist.rank(), pdist.world(), int(case["cfg"]["batch_size"])
    state = trainer.load(case["cfg"], trainer.Tracker(rank=rank), root / "ckpt",
                         device=device, zero=True)
    ts = state.train_state
    rows = pdist.local_rows(batch, rank, world)
    draws = {k: None if v is None else v.to(device) for k, v in case["draws"].items()}
    with kt.snake_census(ts.generator) as census:
        step1, launches, _ = rank_steps(state, batch, rows, draws, device, 1)
    out = {"rank": rank, "world": world, "backend": pdist.dist.get_backend(),
           "device": str(device), "rows": rows, "metrics": step1,
           "launches": launches, "digest": digest(ts),
           "snake_census": [[list(k), v] for k, v in sorted(census.items())]}
    if rank == 0:
        torch.save(snapshot(ts), root / "snap0.pt")
    layouts = [opt.state_dict() for opt in (ts.opt_g, ts.opt_d)]
    out["replicated_layout"] = (
        all(sd is None for sd in layouts) if rank else
        all(len(sd["adamw"]["state"]) == len(opt.params) and sd["count"] == 1
            for sd, opt in zip(layouts, (ts.opt_g, ts.opt_d))))
    out["step_ms"] = rank_steps(state, batch, rows, draws, device, steps)[2]
    (root / f"rank{rank}.json").write_text(json.dumps(out))


def loss_rel_err(metrics, ref) -> float:
    return max(abs(metrics[k] - v) / max(abs(v), 1e-30) for k, v in ref.items())


def group_against_one(root: Path, ref, theta0, n: int, steps: int, backend: str,
                      devices):
    """``parallel_rank`` in ``n`` processes against the one-rank step 1
    (``ref``: metrics and ``snapshot``): every loss and grad norm within
    ``PAR_LOSS_RTOL``, each gradient the update took and the parameters
    within ``PAR_UPDATE_REL_L2`` (``agreement``), the ranks' parameters
    bit-identical, each rank's K2 launches those of its Snake census."""
    pdist.spawn(parallel_rank, n, str(root), steps, backend=backend,
                devices=devices, timeout=PAR_TIMEOUT_S)
    ranks = [json.loads((root / f"rank{r}.json").read_text()) for r in range(n)]
    loss_err = max(loss_rel_err(r["metrics"], ref["metrics"]) for r in ranks)
    agree = agreement(torch.load(root / "snap0.pt", weights_only=True), ref, theta0)
    assert loss_err <= PAR_LOSS_RTOL, (loss_err, ranks[0]["metrics"], ref["metrics"])
    assert max(agree["grad_rel_l2"].values()) <= PAR_UPDATE_REL_L2, agree
    assert agree["param_rel_l2"] <= PAR_UPDATE_REL_L2, agree
    assert len({r["digest"] for r in ranks}) == 1, [r["digest"] for r in ranks]
    assert all(r["replicated_layout"] for r in ranks), ranks
    census = ranks[0]["snake_census"]
    for r in ranks:
        per_step = sum(n for _, n in r["snake_census"])
        assert r["snake_census"] == census, (r["snake_census"], census)
        assert r["launches"].get("snake") == r["launches"].get("snake_backward") == per_step
        assert r["metrics"]["other/batch_size"] == ref["metrics"]["other/batch_size"]
    (root / "snap0.pt").unlink()
    return {"backend": backend, "ranks": n, "devices": [str(d) for d in devices],
            "rows": [r["rows"] for r in ranks], "max_loss_rel_err": loss_err,
            **agree, "ranks_bit_identical": True,
            "zero_checkpoint_layout": "replicated",
            "step_ms": [r["step_ms"] for r in ranks],
            "launches_step1": [r["launches"] for r in ranks], "snake_census": census}


def one_rank(cfg, save, draws, steps: int, remat: bool = False):
    """The flagship's step 1 on the whole batch of 16 (one process, no
    group) and ``steps - 1`` timed steps: the parameters before step 1
    (``theta0``), metrics and ``snapshot`` of step 1, K2's launches in step
    1 and the peak memory of the steps."""
    state = trainer.load({**cfg, "remat": remat}, trainer.Tracker(), save,
                         device=torch.device(DEVICE))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    batch = int(cfg["batch_size"])
    rows, ts = list(range(batch)), state.train_state
    theta0 = {k: p.detach().to("cpu", copy=True) for k, p in params_of(ts).items()}
    step1, launches, _ = rank_steps(state, batch, rows, draws, torch.device(DEVICE), 1)
    snap = snapshot(ts)
    ms = rank_steps(state, batch, rows, draws, torch.device(DEVICE), steps)[2]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del state, ts
    torch.cuda.empty_cache()
    return {"metrics": step1, **snap, "launches": launches, "step_ms": ms,
            "peak_memory_gib": peak, "theta0": theta0}


def parallel_phase(gen, pool):
    """See the module docstring. Returns the kernel rows' launches of the
    path: the one-rank and remat steps (K2 forward and backward), the ranks'
    steps (K2 forward and backward, with the checks at a rank's census) and
    the pool over the cards (K1, K2)."""
    cards = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        wav_dir = write_wavs(tmp / "wavs")
        cfg = train_config(wav_dir)
        with torch.device("meta"):  # the draws need the quantizer's config only
            draws = port.DAC_VRVQ(model_config(trainer.as_config(cfg))).draws(
                TRAIN_BATCH, trainer.step_generator(SEED, 0, torch.device(DEVICE)),
                torch.device(DEVICE))

        # (c) and the reference: one rank on the 16 rows, twice without remat
        # (the same bits: the step is a function of its inputs), then with
        # remat
        plain = one_rank(cfg, tmp / "one", draws, PAR_STEPS)
        theta0 = plain.pop("theta0")
        again = one_rank(cfg, tmp / "again", draws, 1)
        remat = one_rank(cfg, tmp / "remat", draws, PAR_STEPS, remat=True)
        path_launches = collections.Counter(plain["launches"]) + collections.Counter(
            remat["launches"])
        spread = {"max_loss_rel_err": loss_rel_err(again["metrics"], plain["metrics"]),
                  **agreement(again, plain, theta0)}
        assert again["metrics"] == plain["metrics"], spread
        same_bits({k: again[k] for k in ("params", "grads")},
                  {k: plain[k] for k in ("params", "grads")}, "one rank twice")
        assert spread["update_sign_flips"] == 0 and max(
            spread["grad_rel_l2"].values()) == spread["param_rel_l2"] == spread[
            "max_tensor_grad_rel_l2"] == spread["update_rel_l2"] == 0.0, spread
        remat_agree = {"max_loss_rel_err": loss_rel_err(remat["metrics"], plain["metrics"]),
                       **agreement(remat, plain, theta0)}
        assert remat_agree["max_loss_rel_err"] <= REMAT_LOSS_RTOL, remat_agree
        assert max(remat_agree["grad_rel_l2"].values()) <= REMAT_UPDATE_REL_L2, remat_agree
        assert remat_agree["param_rel_l2"] <= REMAT_UPDATE_REL_L2, remat_agree
        assert remat["launches"]["snake"] > plain["launches"]["snake"] > 0, (remat, plain)
        assert remat["launches"]["snake_backward"] == plain["launches"]["snake_backward"] > 0

        case = {"cfg": cfg, "draws": {k: None if v is None else v.cpu()
                                      for k, v in draws.items()}}
        # (b) one NCCL rank through cli.train's torchrun path, beside (a)
        cli_save = tmp / "nccl1"
        env = {**os.environ, "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
               "MASTER_ADDR": "localhost", "MASTER_PORT": str(pdist.free_port())}
        over = cli_overrides(wav_dir, cli_save, 1, batch_size=TRAIN_BATCH)
        cli_run = subprocess.Popen(
            [sys.executable, "-m", "vrvq_tpu_torch.cli.train", "--args.load",
             FLAGSHIP_YAML, *argv(over)], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True), time.perf_counter()
        # (a) two gloo ranks on the one card, ZeRO on
        (tmp / "gloo").mkdir()
        torch.save(case, tmp / "gloo" / "case.pt")
        ref = {k: plain[k] for k in ("metrics", "params", "grads")}
        gloo = group_against_one(tmp / "gloo", ref, theta0, 2, 2, "gloo",
                                 [torch.device(DEVICE, 0)] * 2)
        line, cli_s = finish_cli(cli_run)
        nccl1 = json.loads(line)
        rank_census = {tuple(sh): n for sh, n in gloo["snake_census"]}
        rank_fwd = [snake_check(sh, gen) for sh in rank_census]
        rank_bwd = [snake_backward_check(sh, gen) for sh in rank_census]
        assert (nccl1["world"], nccl1["backend"], nccl1["steps"]) == (1, "nccl", 1), nccl1
        assert all(np.isfinite(v) for v in nccl1["metrics"][0].values())
        assert (cli_save / "latest" / "state.pt").exists()
        nccl2 = spawned = None
        if cards >= 2:  # (b) two NCCL ranks on two cards; cli.train's spawn
            (tmp / "nccl2").mkdir()
            torch.save(case, tmp / "nccl2" / "case.pt")
            nccl2 = group_against_one(tmp / "nccl2", ref, theta0, 2, PAR_STEPS, "nccl",
                                      [torch.device(DEVICE, i) for i in range(2)])
            assert nccl2["snake_census"] == gloo["snake_census"]
            line, spawn_s = finish_cli(start_cli("train", [
                "--args.load", FLAGSHIP_YAML,
                *argv(cli_overrides(wav_dir, tmp / "spawned", 2,
                                    batch_size=TRAIN_BATCH))]))
            spawned = json.loads(line)
            want = pdist.data_world_size(TRAIN_BATCH, cards)
            assert (spawned["world"], spawned["backend"]) == (want, "nccl"), spawned
            assert all(np.isfinite(v) for m in spawned["metrics"] for v in m.values())
            spawned = {k: spawned[k] for k in ("world", "backend", "steps", "step_ms",
                                               "peak_memory_gib")}
            spawned["cli_s"] = spawn_s
        del ref, theta0

    # (d) the pool of 8 streams over every card against the one-card pool
    devices = [torch.device(DEVICE, i) for i in range(cards)]
    model = port.build_model(port.FLAGSHIP, device=DEVICE, seed=SEED)
    proc = port.CodecProcessor(model, fused_quantizer=True, devices=devices)
    sr = model.sample_rate
    streams = {f"s{i}": port.synthetic_clip(POOL_CLIP_S, sr, SEED + 10 + i)[0, 0]
               for i in range(POOL_STREAMS)}
    build.LAUNCHES.clear()
    t0 = time.perf_counter()
    pooled = streaming.StreamPool(proc, win_duration=WINDOW_S, level=1.0,
                                  max_batch=POOL_STREAMS)
    chunks = []
    for sid in streams:
        pooled.add_stream(sid)
    for start in range(0, int(POOL_CLIP_S * sr), sr):
        for sid, x in streams.items():
            pooled.push(sid, x[start: start + sr])
        chunks += pooled.poll()
    for sid in streams:
        pooled.flush(sid)
    chunks += pooled.poll()
    decoder = streaming.DecoderPool(proc, win_duration=WINDOW_S, max_batch=POOL_STREAMS)
    decoded = []
    for i in range(0, len(pool["chunks"]), POOL_STREAMS):
        for sid, c, n in pool["chunks"][i: i + POOL_STREAMS]:
            decoder.push(sid, c, n)
        decoded += decoder.poll()
    for d in devices:
        torch.cuda.synchronize(d)
    pool_s = time.perf_counter() - t0
    devices_launches = dict(build.LAUNCHES)
    assert devices_launches.get("rvq", 0) > 0 and devices_launches.get("snake", 0) > 0
    # the one-card pool's chunks decoded over the cards, against its audio
    assert [sid for sid, _ in decoded] == [sid for sid, _ in pool["audio"]]
    if cards == 1:
        assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(decoded, pool["audio"]))
    decode_db = min(si_sdr(np.concatenate([a for s, a in decoded if s == sid])[None],
                           np.concatenate([a for s, a in pool["audio"] if s == sid])[None])
                    for sid in streams)
    assert decode_db >= MIN_POOL_DECODE_DB, decode_db
    codes = np.concatenate([c for sid in streams for s, c, _ in chunks if s == sid], -1)
    want = np.concatenate([c for sid in streams for s, c, _ in pool["chunks"]
                           if s == sid], -1)
    near = np.concatenate([m for sid in streams for m in pool["margins"][sid]]) <= TIE_MARGIN
    split = flips(codes[None], want[None], near[None])
    assert split["flipped_off_tie"] == 0, split
    if cards == 1:  # the one-card pool's very computation
        assert split["flipped_frames"] == 0, split
    last = last_card_checks(model, gen, devices[-1], cards) if cards >= 2 else None
    del model, proc
    torch.cuda.empty_cache()

    one_ms = float(np.median(plain["step_ms"]))
    remat_ms = float(np.median(remat["step_ms"]))
    out = {"cards": cards, "config": FLAGSHIP_YAML, "batch": TRAIN_BATCH,
           "duration_s": TRAIN_DURATION_S,
           "one_rank": {"step_ms": plain["step_ms"], "clips_per_s": TRAIN_BATCH / one_ms * 1e3,
                        "peak_memory_gib": plain["peak_memory_gib"],
                        "launches_step1": plain["launches"]},
           "a_gloo_one_card": {**gloo, "note": "two gloo ranks share one card: "
                               "not a scaling number"},
           "b_nccl_one_rank_cli": {"world": nccl1["world"], "backend": nccl1["backend"],
                                   "steps": nccl1["steps"], "step_ms": nccl1["step_ms"],
                                   "metrics": nccl1["metrics"], "cli_s": cli_s,
                                   "saved": True},
           "b_nccl_two_cards": (
               {**nccl2, "clips_per_s": {
                   "1_card": TRAIN_BATCH / one_ms * 1e3,
                   "2_cards": TRAIN_BATCH / float(np.median(nccl2["step_ms"][0])) * 1e3}}
               if nccl2 else "not run: one card"),
           "b_cli_spawn_every_card": spawned or "not run: one card",
           "one_rank_twice": spread,
           "c_remat": {**remat_agree,
                       "peak_memory_gib": {"plain": plain["peak_memory_gib"],
                                           "remat": remat["peak_memory_gib"]},
                       "step_ms": {"plain": plain["step_ms"], "remat": remat["step_ms"]},
                       "step_time_ratio": remat_ms / one_ms,
                       "k2_launches_step1": {"plain": plain["launches"],
                                             "remat": remat["launches"]}},
           "d_pool_over_cards": {"devices": [str(d) for d in devices],
                                 "streams": POOL_STREAMS, "clip_s": POOL_CLIP_S,
                                 "windows": len(chunks), **split,
                                 "decode_min_si_sdr_db": decode_db,
                                 "launches": devices_launches, "encode_decode_s": pool_s,
                                 "last_card": last or "not run: one card"}}
    rank_launches = collections.Counter()
    for group in (gloo, nccl2 or {"launches_step1": []}):
        for launches in group["launches_step1"]:
            rank_launches.update(launches)
    rank_fwd_row, rank_bwd_row = census_row(rank_fwd, rank_census), census_row(
        rank_bwd, rank_census)
    rank_bwd_row.update(dx_rel_err=max(c["dx_rel_err"] for c in rank_bwd),
                        dalpha_rel_err=max(c["dalpha_rel_err"] for c in rank_bwd))
    out["ranks_snake"] = {"forward": rank_fwd_row, "backward": rank_bwd_row,
                          "launches": dict(rank_launches)}
    phase("parallel", **out)
    return {"train": dict(path_launches), "pool": devices_launches,
            "ranks_forward": {**rank_fwd_row, "launches": rank_launches["snake"]},
            "ranks_backward": {**rank_bwd_row,
                               "launches": rank_launches["snake_backward"]},
            "ranks_shapes": len(rank_census)}


def last_card_checks(model, gen, last, cards: int):
    """K2 (each mode, and the exact backward) and K1 on tensors of the last
    card while the current card is the first, against their plain versions
    there, at the rows of a card's block of a pool batch."""
    torch.cuda.set_device(0)
    rows = POOL_STREAMS // cards if POOL_STREAMS % cards == 0 else POOL_STREAMS
    out = {"device": str(last), "rows": rows}
    shape = (rows, 96, 22050)
    with torch.inference_mode():
        for mode in SNAKE_MODES:
            dtype = torch.bfloat16 if mode.endswith("_bf16") else torch.float32
            x, alpha = (t.to(last) for t in kt.snake_inputs(shape, gen, dtype))
            c = kt.time_snake(snake_ops, x, alpha, approx="approx" in mode, timed=False)
            tol = SNAKE_BF16_TOL if dtype == torch.bfloat16 else SNAKE_TOL
            assert c["max_abs_err"] <= tol, (mode, c)
            out[mode] = c["max_abs_err"]
        x, alpha = (t.to(last) for t in kt.snake_inputs(shape, gen))
        g = torch.randn(shape, generator=gen).to(last)
        dx, dalpha = snake_ops.snake_backward(x, alpha, g)
        rdx, rdalpha = snake_ops.snake_backward_reference(x, alpha, g)
        out["snake_backward_dx_rel_err"] = float((dx - rdx).abs().max() / rdx.abs().max())
        out["snake_backward_dalpha_rel_err"] = float(
            (dalpha - rdalpha).abs().max() / rdalpha.abs().max())
        assert out["snake_backward_dx_rel_err"] <= SNAKE_BWD_DX_TOL, out
        assert out["snake_backward_dalpha_rel_err"] <= SNAKE_BWD_DALPHA_TOL, out
        weights = rvq_ops.RVQWeights(*(w.to(last) for w in
                                             rvq_ops.stack_quantizer_weights(model.quantizer)))
        z, mask = (t.to(last) for t in kt.rvq_inputs(rows * 72, 8, 1024, gen))
        c = kt.rvq_compare(rvq_ops, z, weights, rvq_ops.prepare_rvq(weights), mask)
        assert c["flipped_off_tie"] == 0 and c["max_abs_err"] <= ZQ_ATOL, c
        out["fused_rvq"] = c
    torch.cuda.synchronize(last)
    assert torch.cuda.current_device() == 0
    return out


def packed_snake_rows(runs, gen):
    """K2 against its plain version, timed, at every shape of each run's
    census, by (run, mode): ms, plain and bound summed over the run's
    census, the run's launches; every shape checked once. The polynomial
    and bfloat16 modes bit-identical, the exact one within ``SNAKE_TOL``."""
    checked, rows = {}, {}
    with torch.inference_mode():
        for run_name, run in runs.items():
            for mode in sorted({m for m, _ in run["census"]}):
                mode_census = of_mode(run["census"], mode)
                checks = []
                for shape in sorted(mode_census):
                    if (mode, shape) not in checked:
                        checked[mode, shape] = snake_check(shape, gen, mode)
                        if mode != "snake":
                            assert checked[mode, shape]["max_abs_err"] == 0.0, (
                                mode, shape, checked[mode, shape])
                    checks.append(checked[mode, shape])
                rows[run_name, mode] = {**census_row(checks, mode_census),
                                        "launches": run["launches"][mode]}
    return rows, len(checked)


def counted_memory(fn, *args):
    """``counted(fn, *args)`` and the GiB its run held on the card beyond
    what was allocated before it (its peak working memory)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = counted(fn, *args)
    return out, (torch.cuda.max_memory_allocated() - before) / 2 ** 30


def packed_phase(model, gen):
    """The time-packed layouts at flagship width on ``PACKED_BATCH`` seeded
    10 s clips, one shot (returns the kernel rows)."""
    sr = model.sample_rate
    audio = model.preprocess(torch.from_numpy(np.concatenate(
        [port.synthetic_clip(PACKED_CLIP_S, sr, SEED + 300 + i)
         for i in range(PACKED_BATCH)])).to(DEVICE))
    seconds = PACKED_BATCH * PACKED_CLIP_S
    encoders = {"turbo": fast.make_serving_model(model),
                "turbo_packed": fast.make_serving_model(model, encode_packed=True)}
    runs, rvq_log = {}, []
    # compress, the main path of each encoder profile: counts cleared just
    # before, read just after
    for name, m in encoders.items():
        with rvq_calls() as calls, torch.inference_mode():
            ((codes, mask), launches, census), gib = counted_memory(
                fast.encode_codes, m, audio, 1.0)
        assert launches["rvq"] == 1 and calls[0][0] == PACKED_BATCH * RVQ_FRAMES, calls
        rvq_log += calls
        runs[name] = {"codes": codes, "mask": mask, "launches": launches,
                      "census": census, "working_memory_gib": gib}
    turbo, packed = runs["turbo"], runs["turbo_packed"]
    for mode in {m for m, _ in turbo["census"]} | {m for m, _ in packed["census"]}:
        assert packed["launches"].get(mode, 0) <= turbo["launches"].get(mode, 0), mode
    with torch.inference_mode():
        weights = rvq_ops.stack_quantizer_weights(model.quantizer)
        near_tie, latents = None, {}
        for name, m in encoders.items():
            z = m.encoder(audio)
            latents[name] = z
            frames = z.transpose(1, 2).reshape(-1, z.shape[1])
            tie = (rvq_ops.reference_margins(frames, *weights) <= TIE_MARGIN).reshape(
                z.shape[0], z.shape[-1]).cpu().numpy()
            near_tie = tie if near_tie is None else near_tie | tie
        latent_rel = float((latents["turbo_packed"] - latents["turbo"]).abs().max()
                           / latents["turbo"].abs().max())
        decoder = encoders["turbo"]  # the fast decoder
        rec = {name: decoder.decode_from_codes(r["codes"].long(), r["mask"]).cpu().numpy()
               for name, r in runs.items()}
    split = flips(packed["codes"].cpu().numpy(), turbo["codes"].cpu().numpy(), near_tie)
    mask_agree = float((packed["mask"] == turbo["mask"]).float().mean())
    encode_sdr = si_sdr(rec["turbo_packed"], rec["turbo"])
    assert mask_agree >= 0.999 and encode_sdr >= MIN_FAST_DB, (mask_agree, encode_sdr)
    gate = fast.turbo_gate(model, clips=fast.synthetic_probe(sr, SEED), encode_packed=True)
    # JAX's test_packed.py asks finite numbers; a decode with no flip agrees
    # to inf dB
    assert np.isfinite(gate.mask_agreement) and 0.0 <= gate.code_flip_rate <= 1.0, gate
    assert not np.isnan(gate.agreement_db), gate

    # decompress: the fast decoder (bfloat16) and the folded float32 one,
    # unpacked and packed, on the turbo profile's codes
    codes, mask = turbo["codes"].long(), turbo["mask"]
    decoders = {"fast": fast.make_inference_model(model),
                "fast_f32": fast.make_inference_model(model, decode_dtype=None)}
    for name, kw in DECODE_PACKINGS.items():
        decoders[name] = fast.make_inference_model(model, **kw)
        decoders[f"{name}_f32"] = fast.make_inference_model(
            model, decode_dtype=None, **kw)
    decode = {}
    for name, m in decoders.items():
        with torch.inference_mode():
            (out, launches, census), gib = counted_memory(m.decode_from_codes, codes, mask)
        base = "fast_f32" if name.endswith("f32") else "fast"
        runs[name] = {"launches": launches, "census": census, "working_memory_gib": gib}
        decode[name] = {"audio": out.cpu().numpy(), "base": base}
    # float32: the packed decode against the unpacked one of the same dtype
    # at the card's bar, which isolates the layout. bfloat16 rounds every
    # conv's output, so another order of sums moves the decode by more: a
    # packed bfloat16 decode is held to the float32 decode, as close as the
    # unpacked bfloat16 decode is (within MAX_BF16_LOSS_DB), and reported
    # against the unpacked one
    decode_db, to_f32_db = {}, {}
    for name, d in decode.items():
        to_f32_db[name] = si_sdr(d["audio"], decode["fast_f32"]["audio"])
        if name in ("fast", "fast_f32"):
            continue
        base = runs[d["base"]]
        for mode in {m for m, _ in runs[name]["census"]}:
            assert runs[name]["launches"][mode] <= base["launches"].get(mode, 0), (name, mode)
        decode_db[name] = si_sdr(d["audio"], decode[d["base"]]["audio"])
    for name, db in decode_db.items():
        if decode[name]["base"] == "fast_f32":
            assert db >= MIN_SISDR_DB, (name, db)
        else:
            assert to_f32_db[name] >= to_f32_db["fast"] - MAX_BF16_LOSS_DB, (
                name, to_f32_db)
            assert db >= MIN_PACKED_BF16_DB, (name, db)

    # real-time factors and device ms by class (host clock, then one trace)
    timing = {}
    for name, m in encoders.items():
        t = profile_serve.one_shot(m, audio, parts=("compress",))
        timing[name] = t["compress"]
    for name, m in decoders.items():
        t = profile_serve.one_shot(m, audio, parts=("decompress",))
        timing[name] = t["decompress"]
    del encoders, decoders
    torch.cuda.empty_cache()

    snake_rows, n_shapes = packed_snake_rows(runs, gen)
    with torch.inference_mode():
        rvq_one_shot = rvq_stream_row(rvq_log, len(rvq_log), gen)
        rvq_b16 = rvq_check(weights, gen, PACKED_RVQ_FRAMES)
    phase("packed", batch=PACKED_BATCH, clip_s=PACKED_CLIP_S,
          encode_packed_against_turbo={**split, "mask_agreement": mask_agree,
                                       "decode_si_sdr_db": encode_sdr,
                                       "latent_max_rel_diff": latent_rel},
          turbo_gate_packed={k: v for k, v in gate.__dict__.items()},
          decode_si_sdr_db_against_unpacked=decode_db,
          decode_si_sdr_db_against_float32=to_f32_db,
          launches={name: r["launches"] for name, r in runs.items()},
          working_memory_gib={name: r["working_memory_gib"] for name, r in runs.items()},
          device_kernels={name: t["device_kernels"] for name, t in timing.items()},
          rtf={name: t["rtf"] for name, t in timing.items()},
          host_s={name: t["s"] for name, t in timing.items()},
          device_ms={name: t["device_ms"] for name, t in timing.items()},
          device_ms_by_class={name: t["device_ms_by_class"] for name, t in timing.items()},
          snake_shapes_checked=n_shapes,
          snake_by_run={f"{mode}:{run}": {k: row[k] for k in (
              "launches", "shapes", "ms", "plain_ms", "bound_ms", "max_abs_err")}
              for (run, mode), row in snake_rows.items()},
          rvq_one_shot=rvq_one_shot,
          rvq_b16={k: rvq_b16[k] for k in ("frames", "ms", "plain_ms", "bound_ms",
                                           "bound_by", "vbr_flipped_frames",
                                           "cbr_flipped_frames", "max_abs_err")},
          audio_s=seconds)
    return snake_rows, rvq_one_shot, rvq_b16


def kernel_row(name, mode_row, **fields):
    return {"name": name, "route": "cuda", "library_ms": None,
            "bound_by": "bytes", **fields,
            **{k: mode_row[k] for k in ("launches", "max_abs_err", "ms",
                                        "plain_ms", "bound_ms")}}


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
        # the frames of one serve window, as the chunked main path calls K1,
        # and of a pool batch of 8 windows
        window_frames = port.CodecProcessor(model).window_geometry(WINDOW_S)[2]
        rvq_window = rvq_check(weights, gen, window_frames)
        rvq_pool = rvq_check(weights, gen, POOL_STREAMS * window_frames)
    w28 = weights_24kbps(gen)
    with torch.inference_mode():
        rvq_28 = [rvq_check(w28, gen, f) for f in (window_frames, RVQ_FRAMES)]
        rvq_wide = [rvq_shape_check(gen, shape, window_frames)
                    for shape in RVQ_WIDE_SHAPES]
    phase("kernels", snake=snakes, rvq=rvq, rvq_window=rvq_window,
          rvq_pool=rvq_pool, rvq_24kbps=rvq_28, rvq_codebook_shapes=rvq_wide)

    launches, census, serve_dac = serve_phase(model)
    snake_clip = agree_phase(model, census, gen)
    snake_modes, mode_errors = fast_phase(model, serve_dac, census, gen)
    pool_launches, pool, pool_snake = pool_phase(model, gen)
    entropy_phase(model, serve_dac, pool["chunks"])
    reference_phase(model)
    packed_snake, packed_rvq, packed_rvq_b16 = packed_phase(model, gen)
    del model
    torch.cuda.empty_cache()
    eval_rows = eval_phase(gen, census)
    torch.cuda.empty_cache()
    rvq_24kbps = configs_phase(gen)
    bf16_encoder_row = models_phase(gen)
    train_rows = train_phase(gen)
    torch.cuda.empty_cache()
    cli_rows = cli_phase(gen)
    torch.cuda.empty_cache()
    trained_rows = trained_phase(gen, census, train_rows)
    torch.cuda.empty_cache()
    io_rows = trainer_io_phase(gen, serve_dac, pool["chunks"], train_rows)
    torch.cuda.empty_cache()
    par = parallel_phase(gen, pool)

    source = {"source": "vrvq_tpu_torch/kernels/csrc/snake.cu",
              "replaces": "vrvq_tpu/ops/snake.py:33"}
    snake_rows = [kernel_row(
        "snake", {**snake_clip, "launches": launches["snake"],
                  "max_abs_err": max(mode_errors["snake"], snake_clip["max_abs_err"],
                                     *(c["max_abs_err"] for c in snakes))},
        per=f"exact float32, 10 s clip: {launches['snake']} launches over "
            f"{len(census)} shapes", **source,
        one_shot=[{k: c[k] for k in ("shape", "ms", "plain_ms", "bound_ms")}
                  for c in snakes])]
    for mode, row in snake_modes.items():
        snake_rows.append(kernel_row(
            mode, {**row, "max_abs_err": max(row["max_abs_err"], mode_errors[mode])},
            per=f"{row['path']} profile, 10 s clip: {row['launches']} launches "
                f"over {row['shapes']} shapes", **source))
    snake_rows.append(kernel_row(
        "snake_bf16_encoder", bf16_encoder_row,
        per=f"bf16-encoder profile, 10 s clip: {bf16_encoder_row['launches']} "
            f"launches over {bf16_encoder_row['shapes']} encoder shapes", **source))
    for mode, row in pool_snake.items():
        snake_rows.append(kernel_row(
            f"{mode}_pool", row,
            per=f"pool, 8 streams x 10 s: {row['launches']} launches over "
                f"{row['shapes']} shapes", **source))
    rvq_source = {"source": "vrvq_tpu_torch/kernels/csrc/rvq.cu",
                  "replaces": "vrvq_tpu/ops/rvq_kernel.py:130"}
    rvq_err = max(c["max_abs_err"] for c in [rvq, rvq_window, rvq_pool, *rvq_28])
    kernels = [
        *snake_rows,
        {"name": "fused_rvq", "route": "cuda", **rvq_source,
         "launches": launches["rvq"], "max_abs_err": rvq_err,
         "ms": rvq_window["ms"], "plain_ms": rvq_window["plain_ms"],
         "bound_ms": rvq_window["bound_ms"], "bound_by": rvq_window["bound_by"],
         "library_ms": None, "per": f"launch at {rvq_window['frames']} frames",
         "one_shot": {k: rvq[k] for k in ("frames", "ms", "plain_ms", "bound_ms")}},
        {"name": "fused_rvq_pool", "route": "cuda", **rvq_source,
         "launches": pool_launches["rvq"], "max_abs_err": rvq_err,
         "ms": rvq_pool["ms"], "plain_ms": rvq_pool["plain_ms"],
         "bound_ms": rvq_pool["bound_ms"], "bound_by": rvq_pool["bound_by"],
         "library_ms": None,
         "per": f"launch at {rvq_pool['frames']} frames (a pool batch of 8)"},
        {"name": "fused_rvq_24kbps", "route": "cuda", **rvq_source,
         **{k: rvq_24kbps[k] for k in ("launches", "max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by")},
         "library_ms": None,
         "per": f"launch at {rvq_24kbps['frames']} frames, 28 stages "
                f"(vrvq_a2_24k.yml's serve path, 10 s clip)"},
    ]
    per_step = train_rows["per_step"]
    kernels += [
        kernel_row("snake_train", train_rows["snake_train"], **source,
                   per=f"exact float32 forward, train step at batch 16 x 0.38 s: "
                       f"{per_step} launches a step over "
                       f"{train_rows['snake_train']['shapes']} shapes"),
        kernel_row("snake_backward", train_rows["snake_backward"],
                   source="vrvq_tpu_torch/kernels/csrc/snake.cu",
                   replaces="vrvq_tpu/ops/snake.py:19 (no Pallas backward: "
                            "XLA's autodiff of snake_reference)",
                   per=f"train step at batch 16 x 0.38 s: {per_step} launches "
                       f"a step over {train_rows['snake_backward']['shapes']} "
                       f"shapes"),
    ]
    per = cli_rows["per_step"]
    kernels += [
        kernel_row("snake_approx_train", cli_rows["snake_approx_train"], **source,
                   per=f"polynomial float32 forward, {B64_YAML} step (4 x 16 x "
                       f"0.38 s): {per['forward']} launches a step over "
                       f"{cli_rows['snake_approx_train']['shapes']} shapes"),
        kernel_row("snake_approx_backward", cli_rows["snake_approx_backward"],
                   source="vrvq_tpu_torch/kernels/csrc/snake.cu",
                   replaces="vrvq_tpu/ops/snake.py:89 (no Pallas backward: "
                            "XLA's autodiff of snake_approx)",
                   per=f"{B64_YAML} step (4 x 16 x 0.38 s): {per['backward']} "
                       f"launches a step over "
                       f"{cli_rows['snake_approx_backward']['shapes']} shapes"),
    ]
    trained = (f"the trained phase ({SYNTH_DEMO_YAML} from a corpus of "
               f"cli.make_synth_dataset, {TRAINED_STEPS} steps)")
    fwd, bwd = (trained_rows[k] for k in ("snake_trained_train",
                                          "snake_backward_trained_train"))
    kernels += [
        kernel_row("snake_trained_train", fwd, **source,
                   per=f"exact float32 forward, cli.train in {trained}: its own "
                       f"census (train steps and validations at batch 16 x 33 hops, "
                       f"samples of 2 items): {fwd['launches']} launches over "
                       f"{fwd['shapes']} shapes ({fwd['new_shapes']} not in the "
                       f"train phase's census)"),
        kernel_row("snake_backward_trained_train", bwd,
                   source="vrvq_tpu_torch/kernels/csrc/snake.cu",
                   replaces="vrvq_tpu/ops/snake.py:19 (no Pallas backward: "
                            "XLA's autodiff of snake_reference)",
                   per=f"cli.train in {trained}: its own census of backward calls, "
                       f"{bwd['launches']} launches over {bwd['shapes']} shapes "
                       f"({bwd['new_shapes']} not in the train phase's census)"),
    ]
    for name, what in (
            ("snake_trained_measure", "exact float32, the exact encoders"),
            ("snake_approx_trained_measure", "polynomial float32, the turbo encoders"),
            ("snake_approx_bf16_trained_measure", "polynomial bfloat16, the decoders")):
        row = trained_rows[name]
        kernels.append(kernel_row(
            name, row, **source,
            per=f"{what} of cli.measure_trained in {trained}: gates on 8 x 2 s "
                f"probe clips, packed decoders of 4 x 2 s, profiles at "
                f"{TRAINED_MEASURE[0]} x {TRAINED_MEASURE[1]:g} s: "
                f"{row['launches']} launches over {row['shapes']} shapes "
                f"({row['new_shapes']} not in the serve census)"))
    for name, what in (("snake_trained_eval", "exact float32 (the batch-1 encoder)"),
                       ("snake_approx_bf16_trained_eval",
                        "polynomial bfloat16 (the batch-12 level decode)")):
        row = trained_rows[name]
        kernels.append(kernel_row(
            name, row, **source,
            per=f"{what}, cli.evaluate of {TRAINED_EVAL_CLIPS} x 2 s test clips "
                f"at the 12 default levels in {trained}: {row['launches']} "
                f"launches over {row['shapes']} shapes ({row['new_shapes']} new)"))
    k1 = trained_rows["fused_rvq_trained"]
    kernels.append(
        {"name": "fused_rvq_trained", "route": "cuda", **rvq_source,
         **{k: k1[k] for k in ("launches", "max_abs_err", "ms", "plain_ms",
                               "bound_ms", "bound_by")},
         "library_ms": None,
         "per": f"cli.measure_trained in {trained}, the trained weights: the "
                f"mean launch over its calls (frames: launches {k1['frames']})"})
    kernels += [
        kernel_row("snake_trainer_io", io_rows["forward"], **source,
                   per=f"exact float32 forward, the trainer_io phase's train() with MSD "
                       f"({IO_STEPS} steps at batch 16 x 0.38 s on flac, prefetched, "
                       f"samples of {len(IO_VAL_IDX)} items every step, two "
                       f"validations): {io_rows['forward']['launches']} launches over "
                       f"{io_rows['forward']['shapes']} shapes"),
        kernel_row("snake_backward_trainer_io",
                   {**train_rows["snake_backward"],
                    "launches": io_rows["backward_launches"]},
                   source="vrvq_tpu_torch/kernels/csrc/snake.cu",
                   replaces="vrvq_tpu/ops/snake.py:19 (no Pallas backward: "
                            "XLA's autodiff of snake_reference)",
                   per=f"the trainer_io phase's {IO_STEPS} steps (the train step's "
                       f"census)"),
        kernel_row("snake_parallel", {**train_rows["snake_train"],
                                      "launches": par["train"]["snake"]}, **source,
                   per="exact float32 forward, the parallel phase's one-rank and "
                       "remat steps at batch 16 x 0.38 s (the train step's census, "
                       "the same shapes; remat recomputes the generator's forward)"),
        kernel_row("snake_backward_parallel", {**train_rows["snake_backward"],
                                               "launches": par["train"]["snake_backward"]},
                   source="vrvq_tpu_torch/kernels/csrc/snake.cu",
                   replaces="vrvq_tpu/ops/snake.py:19 (no Pallas backward: "
                            "XLA's autodiff of snake_reference)",
                   per="the parallel phase's one-rank and remat steps (the train "
                       "step's census)"),
        kernel_row("snake_ranks", par["ranks_forward"], **source,
                   per=f"exact float32 forward, the parallel phase's ranks' step 1 "
                       f"at 8 rows of the batch of 16 x 0.38 s, over a rank's census "
                       f"of {par['ranks_shapes']} shapes"),
        kernel_row("snake_backward_ranks", par["ranks_backward"],
                   source="vrvq_tpu_torch/kernels/csrc/snake.cu",
                   replaces="vrvq_tpu/ops/snake.py:19 (no Pallas backward: "
                            "XLA's autodiff of snake_reference)",
                   per=f"the parallel phase's ranks' step 1 at 8 rows, over a "
                       f"rank's census of {par['ranks_shapes']} shapes"),
        kernel_row("snake_pool_cards", {**pool_snake["snake"],
                                        "launches": par["pool"]["snake"]}, **source,
                   per="8 streams x 10 s through StreamPool and DecoderPool over "
                       "every card (times: the pool's census on one card, the "
                       "same computation; with several cards each card's block "
                       "is checked on the last card)"),
        {"name": "fused_rvq_pool_cards", "route": "cuda", **rvq_source,
         "launches": par["pool"]["rvq"], "max_abs_err": rvq_err,
         "ms": rvq_pool["ms"], "plain_ms": rvq_pool["plain_ms"],
         "bound_ms": rvq_pool["bound_ms"], "bound_by": rvq_pool["bound_by"],
         "library_ms": None,
         "per": "8 streams x 10 s through StreamPool over every card (times: a "
                "pool batch of 576 frames on one card; with several cards each "
                "card's block is checked on the last card)"},
    ]
    eval_fast, stream_rvq = eval_rows["eval_fast"], eval_rows["stream_rvq"]
    clips = (f"{eval_rows['clips']} x {EVAL_CLIP_S:g} s clips "
             f"({', '.join(eval_rows['formats'])})")
    kernels += [
        kernel_row("snake_eval", eval_rows["eval"], **source,
                   per=f"exact float32, cli.evaluate --fast 0 of {clips} at levels "
                       f"1 and 2: {eval_rows['eval']['launches']} launches over "
                       f"{eval_rows['eval']['shapes']} shapes "
                       f"({eval_rows['eval']['new_shapes']} not in the serve census)"),
        kernel_row("snake_approx_bf16_eval", eval_fast, **source,
                   per=f"polynomial bfloat16 (the fast decoder), cli.evaluate --fast 1 "
                       f"of the same {clips}: {eval_fast['launches']} launches over "
                       f"{eval_fast['shapes']} shapes; its {eval_fast['exact_launches']} exact "
                       f"float32 encoder launches are snake_eval's mode, "
                       f"{eval_fast['exact_shapes_outside_eval']} of their shapes outside "
                       f"snake_eval's census (checked untimed)"),
        kernel_row("snake_stream", eval_rows["stream"], **source,
                   per=f"exact float32, cli.stream_demo of the {EVAL_CLIP_S:g} s flac "
                       f"in 1 s windows: {eval_rows['stream']['launches']} launches "
                       f"over {eval_rows['stream']['shapes']} shapes"),
        {"name": "fused_rvq_stream", "route": "cuda", **rvq_source,
         **{k: stream_rvq[k] for k in ("launches", "max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by")},
         "library_ms": None,
         "per": f"cli.stream_demo --fused_quantizer 1, with its own weights: the "
                f"mean launch over its calls (frames: launches "
                f"{stream_rvq['frames']})"},
    ]
    for (run, mode), row in packed_snake.items():
        kernels.append(kernel_row(
            f"{mode}_{run}", row, **source,
            per=f"packed phase, {run}, one shot of {PACKED_BATCH} x "
                f"{PACKED_CLIP_S:g} s: {row['launches']} launches over "
                f"{row['shapes']} shapes"))
    kernels.append(
        {"name": "fused_rvq_one_shot", "route": "cuda", **rvq_source,
         **{k: packed_rvq[k] for k in ("launches", "max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by")},
         "library_ms": None,
         "per": f"packed phase: one launch a compress at {PACKED_BATCH} x "
                f"{RVQ_FRAMES} frames (turbo and turbo_packed)",
         "b16_one_shot": {k: packed_rvq_b16[k] for k in (
             "frames", "ms", "plain_ms", "bound_ms", "max_abs_err")}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
