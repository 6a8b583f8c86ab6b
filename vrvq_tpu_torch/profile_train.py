"""Where a training step's time goes on the card.

``python -m vrvq_tpu_torch.profile_train [--args.load CONF] [--steps N]
[--trace PATH]`` builds the generator and discriminator of the
config (``conf/vrvq/vrvq_a2.yml`` by default; random seeded weights) as
``train()`` does, on 32 seeded synthetic 1 s wavs written to a temporary
directory, in micro-batches of 16 x 0.38 s: a batch of 16 times the config's
``grad_accum_steps``, so ``vrvq_a2_b64_1chip.yml`` runs its batch of 64 as
4 x 16. Then:

  * runs 2 untimed steps, then ``--steps`` steps each timed on the host
    clock after ``torch.cuda.synchronize`` (the batch's load and transforms
    apart from the step);
  * traces one more step (its batch's device transforms included) with
    ``torch.profiler`` and sums the device time of every kernel by class:
    convolutions (forward, data and weight gradients), the Snake kernels
    (K2 forward, K2 backward and its dalpha reduction), FFTs, matmuls, the
    optimizers' multi-tensor kernels, elementwise and reductions, copies;
    with the device's busy share of the traced wall time (the union of the
    kernels' intervals), its idle time by the innermost program span open
    (``idle_ms_by_span``, ``utils.idle_by_span``: the step's phases, the
    clips' waits for the gradients' norm), and the device time of the
    convolutions' backward by the shapes of their input and weight (which
    convs the backward algorithms cost).

Prints one JSON line. Needs an NVIDIA card.
"""

from __future__ import annotations

import argparse
import collections
import json
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import vrvq_tpu_torch as port
from vrvq_tpu_torch.config import FLAGSHIP_YAML, REPO, Config
from vrvq_tpu_torch.profile_serve import device_summary
from vrvq_tpu_torch.train import trainer

MICRO_BATCH = 16
DURATION_S = 0.38
WAVS = 32

CLASSES = [
    ("snake_backward", "snake backward (K2 bwd)"),
    ("snake_alpha_reduce", "snake backward (K2 bwd)"),
    ("snake_kernel", "snake forward (K2)"),
    ("rvq_kernel", "fused_rvq (K1)"),
    ("wgrad", "conv weight grad"), ("dgrad", "conv data grad"),
    ("fprop", "conv forward"), ("conv", "conv forward"), ("xmma", "conv forward"),
    ("cudnn", "conv forward"), ("implicit", "conv forward"),
    ("fft", "fft"),
    ("multi_tensor", "optimizer"), ("foreach", "optimizer"),
    ("gemm", "matmul"), ("cutlass", "matmul"),
    ("Memcpy", "copy"), ("Memset", "copy"),
    ("reduce", "reduction"),
    ("elementwise", "elementwise"),
]


def kernel_class(name: str) -> str:
    for key, cls in CLASSES:
        if key.lower() in name.lower():
            return cls
    return "other"


def config(path: str, wav_dir: Path, seed: int = 0) -> Config:
    """The config at ``path`` (from the repo root) on ``wav_dir``, in
    micro-batches of 16 x 0.38 s."""
    cfg = Config.load(path, base_dir=REPO)
    accum = int(cfg.get("grad_accum_steps", 1))
    cfg.update({"train/build_dataset.folders": {"music": [str(wav_dir)]},
                "val/build_dataset.folders": {"music": [str(wav_dir)]},
                "train/AudioDataset.duration": DURATION_S,
                "batch_size": MICRO_BATCH * accum, "seed": seed})
    return cfg


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--args.load", dest="load", default=FLAGSHIP_YAML)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--trace", default=None, help="write a Chrome trace here")
    args = ap.parse_args()
    device = port.resolve_device("cuda")
    port.disable_tf32()

    with tempfile.TemporaryDirectory() as tmp:
        wav_dir = Path(tmp)
        for i in range(WAVS):
            port.Signal(port.synthetic_clip(1.0, 44100, 100 + i), 44100).write(
                wav_dir / f"clip_{i:02d}.wav")
        cfg = config(args.load, wav_dir)
        batch_size = int(cfg["batch_size"])
        state = trainer.load(cfg, trainer.Tracker(), tmp, device=device)

        def batch(step):
            return trainer.prepare_audio(
                state.train_data, trainer.load_batch(state.train_data, step, batch_size),
                device)

        def step(i, audio):
            return state.train_step(state.train_state, audio,
                                    generator=trainer.step_generator(0, i, device))

        for i in range(2):
            step(i, batch(i))
        step_ms, data_ms = [], []
        for i in range(2, 2 + args.steps):
            t0 = time.perf_counter()
            audio = batch(i)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            step(i, audio)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            data_ms.append(1e3 * (t1 - t0))
            step_ms.append(1e3 * (t2 - t1))

        i = 2 + args.steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            t0 = time.perf_counter()
            step(i, batch(i))
            torch.cuda.synchronize()
            traced_s = time.perf_counter() - t0
    if args.trace:
        prof.export_chrome_trace(args.trace)

    conv_bwd = collections.Counter()
    for avg in prof.key_averages(group_by_input_shape=True):
        if avg.key == "aten::convolution_backward":  # (grad, input, weight, ...)
            shapes = avg.input_shapes
            conv_bwd[f"input {shapes[1]} weight {shapes[2]} x{avg.count}"] += (
                avg.device_time_total / 1e3)
    median_ms = float(np.median(step_ms))
    print(json.dumps({
        "card": torch.cuda.get_device_name(0), "config": args.load,
        "batch": batch_size,
        "grad_accum_steps": int(cfg.get("grad_accum_steps", 1)),
        "duration_s": DURATION_S, "step_ms": step_ms, "data_ms": data_ms,
        "median_step_ms": median_ms, "clips_per_s": batch_size / (median_ms / 1e3),
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        **device_summary(prof, traced_s, kernel_class, top=15),
        "conv_backward_ms_by_shape": dict(conv_bwd.most_common(15)),
    }))


if __name__ == "__main__":
    main()
