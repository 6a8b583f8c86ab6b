"""Where the serving path's time goes on the card.

``python -m vrvq_tpu_torch.profile_serve [--trace PATH]`` compresses (VBR,
level 1, 1 s windows, fused quantizer) and decompresses a seeded synthetic
10 s clip with the flagship codec (random seeded weights), as
``chip_smoke.py``'s serve phase does, then:

  * times compress and decompress on the host clock, each ending in a copy
    to the host (mean of 3 runs after a warm-up run);
  * traces one more compress and decompress with ``torch.profiler`` and sums
    the device time of every kernel by class (conv, Snake kernel, fused-RVQ
    kernel, matmul, elementwise, copies), with the device's busy share of the
    traced wall time (one stream, so kernels do not overlap).

Prints one JSON line. Needs an NVIDIA card.
"""

from __future__ import annotations

import argparse
import collections
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

import vrvq_tpu_torch as port

CLIP_S = 10.0
WINDOW_S = 1.0

CLASSES = [
    ("snake_kernel", "snake (K2)"),
    ("rvq_kernel", "fused_rvq (K1)"),
    ("conv", "conv"), ("xmma", "conv"), ("cudnn", "conv"), ("fprop", "conv"),
    ("dgrad", "conv"), ("implicit", "conv"),
    ("gemm", "matmul"),
    ("Memcpy", "copy"), ("Memset", "copy"),
    ("elementwise", "elementwise"), ("reduce", "elementwise"),
]


def kernel_class(name: str) -> str:
    for key, cls in CLASSES:
        if key.lower() in name.lower():
            return cls
    return "other"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", default=None, help="write a Chrome trace here")
    args = ap.parse_args()

    model = port.build_model(port.FLAGSHIP, device="cuda", seed=0)
    proc = port.CodecProcessor(model, fused_quantizer=True)
    signal = port.Signal(port.synthetic_clip(CLIP_S, model.sample_rate, 0),
                         model.sample_rate)

    def compress():
        return proc.compress(signal, win_duration=WINDOW_S, level=1.0)

    dac = compress()
    proc.decompress(dac)
    enc, dec = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        dac = compress()
        t1 = time.perf_counter()
        proc.decompress(dac)
        t2 = time.perf_counter()
        enc.append(t1 - t0)
        dec.append(t2 - t1)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        proc.decompress(compress())
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    if args.trace:
        prof.export_chrome_trace(args.trace)

    by_class = collections.Counter()
    by_name = collections.Counter()
    n_kernels = 0
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.time_range.elapsed_us()
        by_class[kernel_class(evt.name)] += us / 1e3
        by_name[evt.name[:80]] += us / 1e3
        n_kernels += 1
    device_ms = sum(by_class.values())
    print(json.dumps({
        "card": torch.cuda.get_device_name(0), "clip_s": CLIP_S,
        "windows": int(dac.codes.shape[-1] // dac.chunk_length),
        "compress_s": enc, "decompress_s": dec,
        "traced_wall_ms": traced_s * 1e3, "device_ms": device_ms,
        "device_busy_share": device_ms / (traced_s * 1e3),
        "device_kernels": n_kernels,
        "device_ms_by_class": dict(by_class.most_common()),
        "top_kernels_ms": dict(by_name.most_common(12)),
    }))


if __name__ == "__main__":
    main()
