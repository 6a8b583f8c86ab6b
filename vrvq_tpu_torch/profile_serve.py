"""Where the serving path's time goes on the card.

``python -m vrvq_tpu_torch.profile_serve [--profile
exact|fast|turbo|turbo_packed] [--pool N | --batch B] [--trace PATH]``
compresses (VBR, level 1, 1 s windows, fused quantizer) and decompresses a
seeded synthetic 10 s clip with the flagship codec (random seeded weights),
as ``chip_smoke.py``'s serve phase does, in the given profile
(``infer/fast.py``; ``exact`` is the live model, ``turbo_packed`` the turbo
profile with the time-packed encoder). With ``--pool N`` it serves N such
clips (other seeds) at once instead, through ``StreamPool`` and
``DecoderPool`` with ``max_batch=N``, every stream pushed 1 s at a time, a
poll after each push. With ``--batch B`` it runs the padded one-shot codec
on B such clips at once (``one_shot``: compress is the encoder with the
fused-RVQ codes, ``fast.encode_codes``; decompress is
``decode_from_codes``), the JAX package's serving shape at B = 16, and the
only way ``turbo_packed`` serves (a packed profile has no padding-free
codec). Then:

  * times compress and decompress on the host clock, each ending in a copy
    to the host (3 runs after a warm-up run);
  * traces one more compress and decompress with ``torch.profiler`` and sums
    the device time of every kernel by class (conv, Snake kernel, fused-RVQ
    kernel, matmul, elementwise, copies), with the device's busy share of the
    traced wall time (the union of the kernels' intervals) and its idle
    time by the innermost program span open (``idle_ms_by_span``,
    ``utils.idle_by_span``: the pools' polls and their parts, packets).

Prints one JSON line. Needs an NVIDIA card.
"""

from __future__ import annotations

import argparse
import collections
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import vrvq_tpu_torch as port
from vrvq_tpu_torch import utils
from vrvq_tpu_torch.infer import fast, streaming

CLIP_S = 10.0
WINDOW_S = 1.0
RUNS = 3  # timed runs after the warm-up
PROFILES = {"exact": lambda m: m, "fast": fast.make_inference_model,
            "turbo": fast.make_serving_model,
            "turbo_packed": lambda m: fast.make_serving_model(m, encode_packed=True)}

CLASSES = [
    ("snake_kernel", "snake (K2)"), ("snake_cl_kernel", "snake (K2)"),
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
    ap.add_argument("--profile", default="exact", choices=sorted(PROFILES))
    ap.add_argument("--pool", type=int, default=0,
                    help="serve this many streams through StreamPool")
    ap.add_argument("--batch", type=int, default=0,
                    help="run the padded one-shot codec on this many clips")
    ap.add_argument("--trace", default=None, help="write a Chrome trace here")
    args = ap.parse_args()

    model = PROFILES[args.profile](
        port.build_model(port.FLAGSHIP, device="cuda", seed=0))
    if args.batch:
        audio = torch.from_numpy(np.concatenate(
            [port.synthetic_clip(CLIP_S, model.sample_rate, 10 + i)
             for i in range(args.batch)])).cuda()
        res = one_shot(model, audio, trace=args.trace)
        del res["codes"], res["mask"]
        print(json.dumps({"card": torch.cuda.get_device_name(0),
                          "profile": args.profile, "batch": args.batch,
                          "clip_s": CLIP_S, **res}))
        return
    proc = port.CodecProcessor(model, fused_quantizer=True)
    sr = model.sample_rate
    if args.pool:
        compress, decompress = pool_codec(proc, args.pool)
    else:
        signal = port.Signal(port.synthetic_clip(CLIP_S, sr, 0), sr)

        def compress():
            return proc.compress(signal, win_duration=WINDOW_S, level=1.0)

        decompress = proc.decompress

    dac = compress()
    decompress(dac)
    enc, dec = [], []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        dac = compress()
        t1 = time.perf_counter()
        decompress(dac)
        t2 = time.perf_counter()
        enc.append(t1 - t0)
        dec.append(t2 - t1)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        decompress(compress())
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    if args.trace:
        prof.export_chrome_trace(args.trace)

    windows = (len(dac) if args.pool
               else int(dac.codes.shape[-1] // dac.chunk_length))
    print(json.dumps({
        "card": torch.cuda.get_device_name(0), "profile": args.profile,
        "streams": args.pool or 1, "clip_s": CLIP_S, "windows": windows,
        "compress_s": enc, "decompress_s": dec,
        **device_summary(prof, traced_s),
    }))


def device_summary(prof, traced_s: float, classify=kernel_class, top: int = 12) -> dict:
    """The device time of a trace's operations, by class (``classify``) and
    by name; the busy share of ``traced_s`` of wall time (the union of the
    operations' intervals: operations on several streams overlap); the
    operation count; and the idle ms by the innermost program span open."""
    by_class = collections.Counter()
    by_name = collections.Counter()
    intervals = []
    for name, on_device, annotation, start, end in utils.profile_events(prof):
        if not utils.is_device_op(name, on_device, annotation):
            continue
        by_class[classify(name)] += (end - start) / 1e6
        by_name[name[:80]] += (end - start) / 1e6
        intervals.append((start, end))
    busy_ns, reach = 0, 0
    for start, end in sorted(intervals):
        busy_ns += max(0, end - max(start, reach))
        reach = max(reach, end)
    return {"traced_wall_ms": traced_s * 1e3, "device_ms": sum(by_class.values()),
            "device_busy_share": busy_ns / 1e6 / (traced_s * 1e3),
            "device_kernels": len(intervals),
            "device_ms_by_class": dict(by_class.most_common()),
            "top_kernels_ms": dict(by_name.most_common(top)),
            "idle_ms_by_span": {k: v * 1e3 for k, v in sorted(
                utils.idle_by_span(prof).items(), key=lambda kv: -kv[1])}}


def one_shot(model, audio: torch.Tensor, trace=None,
             parts=("compress", "decompress")) -> dict:
    """The padded one-shot codec of ``model`` on ``audio`` (B, 1, T) on the
    card, a hop multiple: compress at level 1 (the encoder, the importance
    map and the codes of the fused-RVQ kernel, ``fast.encode_codes``) and
    decompress (``decode_from_codes``), each timed on the host clock after a
    warm-up (``RUNS`` times, each ending in a synchronize), then traced once: the
    real-time factors (seconds of audio per second, the median run) and
    each part's device time by class. ``parts`` may leave one out; the
    decompress then decodes the codes of one compress. Returns the codes
    and mask too (``codes``, ``mask``; not JSON)."""
    seconds = audio.shape[0] * audio.shape[-1] / model.sample_rate
    fns = {"compress": lambda: fast.encode_codes(model, audio, 1.0)}
    out = {}
    with torch.inference_mode():
        codes, mask = fns["compress"]()
        fns["decompress"] = lambda: model.decode_from_codes(codes.long(), mask)
        for part in parts:
            fns[part]()
            torch.cuda.synchronize()
            times = []
            for _ in range(RUNS):
                t0 = time.perf_counter()
                fns[part]()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fns[part]()
                torch.cuda.synchronize()
                traced_s = time.perf_counter() - t0
            if trace:
                prof.export_chrome_trace(f"{trace}.{part}.json")
            summary = device_summary(prof, traced_s)
            del summary["top_kernels_ms"]
            out[part] = {"s": times, "rtf": seconds / sorted(times)[len(times) // 2],
                         **summary}
    out["codes"], out["mask"] = codes, mask
    return out


def pool_codec(proc, n: int):
    """(compress, decompress) of ``n`` seeded 10 s streams through one
    ``StreamPool`` / ``DecoderPool`` of ``max_batch=n``: every stream pushed
    1 s at a time, a poll after each push; the chunks stand for the file."""
    sr = proc.model.sample_rate
    streams = {i: port.synthetic_clip(CLIP_S, sr, 10 + i)[0, 0] for i in range(n)}

    def compress():
        pool = streaming.StreamPool(proc, win_duration=WINDOW_S, level=1.0,
                                    max_batch=n)
        for sid in streams:
            pool.add_stream(sid)
        chunks = []
        for start in range(0, int(CLIP_S * sr), sr):
            for sid, x in streams.items():
                pool.push(sid, x[start: start + sr])
            chunks += pool.poll()
        for sid in streams:
            pool.flush(sid)
        return chunks + pool.poll()

    def decompress(chunks):
        dp = streaming.DecoderPool(proc, win_duration=WINDOW_S, max_batch=n)
        out = []
        for i in range(0, len(chunks), n):
            for sid, codes, counts in chunks[i: i + n]:
                dp.push(sid, codes, counts)
            out += dp.poll()
        return out

    return compress, decompress


if __name__ == "__main__":
    main()
