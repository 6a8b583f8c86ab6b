"""Live-streaming codec demo, the counterpart of ``scripts/stream_demo.py``:
an audio file -> push-style encode and decode -> a wav::

    python -m vrvq_tpu_torch.cli.stream_demo --args.load conf/vrvq/vrvq_a2.yml \
        --ckpt_dir ckpt --tag latest --input in.flac --output out.wav \
        --win_duration 1.0 --level 1.0 [--block_ms 20] [--fused_quantizer 1] \
        [--entropy 1]   # range-coded wire packets (PacketCodec)

The input is a mono wav, flac, mp3, mp4 or m4a file at the model's rate
(the samples of a file's channels are streamed one after the other, as the
JAX script streams them). Audio arrives in ``--block_ms`` blocks; each filled
window gives a chunk of codes at once (``StreamingEncoder``), optionally
through ``PacketCodec``'s wire packets, and each chunk decodes to a
hop-sized waveform segment (``StreamingDecoder``). Prints the first chunk's
algorithmic latency, the real-time factor, the kbps and the median
per-chunk time, and returns them with the decoded samples. Runs on the card unless ``--device cpu``
is given.
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional

import numpy as np

from .. import resolve_device
from ..config import REPO, parse_args
from ..data.audio_io import read_audio, write_wav
from ..infer.codec_api import CodecProcessor
from ..infer.streaming import PacketCodec, StreamingDecoder, StreamingEncoder
from .evaluate import load_model


def stream(cfg) -> dict:
    model = load_model(cfg, resolve_device(cfg.get("device", "cuda")), fast=False)
    proc = CodecProcessor(model, fused_quantizer=bool(cfg.get("fused_quantizer", False)))

    sr = model.sample_rate
    audio, in_sr = read_audio(cfg.get("input"))
    assert in_sr == sr, f"input must be {sr} Hz (got {in_sr})"
    x = np.asarray(audio, np.float32).reshape(-1)
    if len(x) == 0:
        raise ValueError(f"--input {cfg.get('input')} contains no audio")

    win = float(cfg.get("win_duration", 1.0))
    level = cfg.get("level", 1.0)
    n_q = cfg.get("n_quantizers")
    enc = StreamingEncoder(proc, win_duration=win, n_quantizers=n_q,
                           level=None if n_q is not None else level)
    dec = StreamingDecoder(proc, win_duration=win)
    entropy = bool(cfg.get("entropy", False))
    sender = receiver = None
    if entropy:
        sender = PacketCodec(model.n_codebooks, model.config.codebook_size)
        receiver = PacketCodec(model.n_codebooks, model.config.codebook_size)
    block = max(1, int(float(cfg.get("block_ms", 20)) / 1000 * sr))
    latency_ms = enc.samples_to_first_chunk / sr * 1000

    print(f"stream: {len(x) / sr:.2f}s in {block}-sample blocks; "
          f"window={enc.window} hop={enc.hop} "
          f"first-chunk latency={latency_ms:.0f} ms")

    out, chunk_ms, bits = [], [], 0
    bits_per_code = int(np.ceil(np.log2(model.config.codebook_size)))

    def consume(chunks):
        nonlocal bits
        for codes, counts in chunks:
            t0 = time.perf_counter()
            if entropy:  # through the range-coded wire format
                packet = sender.pack(codes, counts)
                bits += len(packet) * 8
                codes, counts = receiver.unpack(packet)
            else:
                kept = counts.sum() if counts is not None else codes.size
                bits += int(kept) * bits_per_code
            out.extend(dec.push(codes, counts))
            chunk_ms.append((time.perf_counter() - t0) * 1000)

    t_start = time.perf_counter()
    for i in range(0, len(x), block):
        consume(enc.push(x[i: i + block]))
    consume(enc.flush())
    out.extend(dec.flush())
    wall = time.perf_counter() - t_start

    y = np.concatenate(out)[: len(x)]
    output = cfg.get("output", "stream_out.wav")
    write_wav(output, y[None, :], sr)
    dur = len(x) / sr
    kbps = bits / dur / 1000
    wire = "wire " if entropy else ""
    print(f"done: {dur:.2f}s audio in {wall:.2f}s wall "
          f"({dur / wall:.1f}x realtime), {kbps:.1f} {wire}kbps, "
          f"{len(chunk_ms)} chunks, per-chunk decode "
          f"median {np.median(chunk_ms):.1f} ms (first includes warm-up)")
    return {"output": output, "audio": y, "samples": int(len(y)), "seconds": dur,
            "wall_s": wall, "realtime": dur / wall, "kbps": kbps,
            "chunks": len(chunk_ms), "chunk_ms_median": float(np.median(chunk_ms)),
            "first_chunk_latency_ms": latency_ms}


def main(argv: Optional[List[str]] = None) -> dict:
    return stream(parse_args(argv, base_dir=REPO))


if __name__ == "__main__":
    main(sys.argv[1:])
