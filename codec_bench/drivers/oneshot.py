"""A batch transcoder, closed loop: each pass takes ``rows`` clips of
``clip_s`` seconds from a seeded pool of ``pool`` clips (a seeded choice a
pass), copies them from the host, compresses them at VBR ``level``, copies
the codes and the per-frame counts back, copies them in again, decompresses
them and copies the audio back.

The program: ``infer/fast.make_inference_model`` of the live codec (the
exact-codes fast profile: the live float32 encoder, the fused codebook
kernel, the folded bfloat16 decoder with the polynomial Snake), through
``fast.encode_codes`` and ``decode_from_codes``.

``codec_rtf``: seconds of audio through the whole round trip in the window
over the window's seconds. Correct: on ``sample_passes`` passes drawn from
the seed after the window, the share of their codes and kept stages that
differ from the reference's (``code_mismatch``; a near tie that flips one
stage's code also moves the later stages of its frame, so one clip's share
swings from seed to seed and the worst clip's is kept as a counter), and the
error of the decoded audio of all
those clips together against the reference's float32 decode of the
program's codes, over the error of the reference's own bfloat16 decode of
them (``audio_err_ratio``: the decoder is the profile's bfloat16 one, and
how far bfloat16 rounding moves a random-weight decoder's output differs
from seed to seed by up to ten times).
With the mix's ``impl: control`` the reference at the next lower
precision (TF32 encoder, fp8 decoder) takes the program's place."""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch
import torch.nn.functional as F

from .. import clips, judge, weights, work
from ..tracing import Tracer


def _program(run, host, dev):
    from vrvq_tpu_torch.infer import fast

    from .. import program

    level = run.mix["level"]
    model = fast.make_inference_model(program.codec(run.keys, host, dev))
    nq = model.n_codebooks

    def compress(x):
        codes, mask = fast.encode_codes(model, model.preprocess(x), level)
        return codes, mask.sum(1).to(torch.uint8)

    def decompress(codes, counts):
        stage = torch.arange(nq, device=codes.device).reshape(1, -1, 1)
        mask = (stage < counts[:, None, :]).float()
        return model.decode_from_codes(codes.long(), mask)

    return model, compress, decompress


def _control(run, dev):
    level = run.mix["level"]
    ref = judge.reference_codec(run.keys, run.seed, dev)
    judge.emulate_fp8(ref.decoder, True)

    def compress(x):
        x = F.pad(x, (0, -x.shape[-1] % ref.hop))
        with judge.precision("tf32"):
            codes, counts = ref.encode(x, level)
        return codes, counts.to(torch.uint8)

    def decompress(codes, counts):
        with judge.precision("exact"):
            return ref.decode(codes.long(), counts.long())

    return ref, compress, decompress


def drive(run) -> None:
    dev = torch.device(run.device)
    keys, mix = run.keys, run.mix
    sr = keys["DAC_VRVQ.sample_rate"]
    samples = int(mix["clip_s"] * sr)
    rows, level = mix["rows"], mix["level"]

    with torch.inference_mode():
        ref = judge.reference_codec(keys, run.seed, dev)
        host = weights.host_state(ref)
        hop = ref.hop
        del ref
        pool = clips.clips(mix["pool"], samples, sr, weights.generator(run.seed, dev, 1), dev).cpu()
        if mix.get("impl", "program") == "control":
            model, compress, decompress = _control(run, dev)
        else:
            model, compress, decompress = _program(run, host, dev)
        del host
        choose = judge.rng(run.seed, 2)
        outputs = []

        def one_pass(k):
            idx = torch.from_numpy(choose.choice(mix["pool"], rows, replace=False))
            with run.span("pass", record=False):
                with run.span("compress"):
                    x = pool[idx].to(dev)[:, None]
                    codes, counts = compress(x)
                    codes, counts = codes.cpu(), counts.cpu()
                if run.fault == "alter_codes":
                    codes[0] = (codes[0] + 1) % keys["DAC_VRVQ.codebook_size"]
                with run.span("decompress"):
                    y = decompress(codes.to(dev), counts.to(dev))[..., :samples].cpu()
                if run.fault == "alter_audio":
                    y[0] = -y[0]
            outputs.append((idx, codes, counts, y))

        one_pass(-1)  # warm-up: every shape of the cell
        if dev.type == "cuda":
            torch.cuda.synchronize()
        outputs.clear()
        run.spans.clear()
        run.setup_s = time.perf_counter() - run.started

        tracer = Tracer() if run.trace else None
        if tracer:
            tracer.prime()
            tracer.start()
        t0 = time.perf_counter()
        k = 0
        while True:
            one_pass(k)
            k += 1
            elapsed = time.perf_counter() - t0
            if tracer and tracer.active and elapsed >= mix["trace_s"]:
                tracer.stop(units=k, run=run)
            if elapsed >= run.seconds:
                break
        end = time.perf_counter()
        run.window_s = end - t0
        if tracer and tracer.active:
            tracer.stop(units=k)
        run.traced = tracer.summary if tracer else None
        run.units = run.attempted = k
        run.counters["rest_s"], run.counters["rest_units"] = run.untraced(end)
        run.e2e["codec_rtf"] = k * rows * mix["clip_s"] / run.window_s
        run.work = work.oneshot(keys, rows, math.ceil(samples / hop) * hop)
        if dev.type == "cuda":
            run.memory_peak_bytes = torch.cuda.max_memory_allocated()
        del model, compress, decompress
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        judge_passes(run, outputs, pool, dev)


def judge_passes(run, outputs, pool, dev) -> None:
    keys, mix = run.keys, run.mix
    samples = int(mix["clip_s"] * keys["DAC_VRVQ.sample_rate"])
    picked = judge.rng(run.seed, 3).choice(len(outputs), min(mix["sample_passes"], len(outputs)),
                                           replace=False)
    ref = judge.reference_codec(keys, run.seed, dev)
    block = mix.get("reference_block", 4)
    mismatch, err = [], np.zeros(3)  # program's, bfloat16 reference's error; norm
    with judge.precision("exact"):
        for p in sorted(picked):
            idx, codes, counts, y = outputs[p]
            for b in range(0, len(idx), block):
                x = pool[idx[b:b + block]].to(dev)[:, None]
                x = F.pad(x, (0, -x.shape[-1] % ref.hop))
                rc, rn = ref.encode(x, mix["level"])
                mismatch.append(judge.code_mismatch(codes[b:b + block], counts[b:b + block],
                                                    rc.cpu(), rn.cpu()))
                ry = ref.decode(codes[b:b + block].to(dev).long(),
                                counts[b:b + block].to(dev).long())[..., :samples]
                rb = ref.decode(codes[b:b + block].to(dev).long(),
                                counts[b:b + block].to(dev).long(),
                                dtype=torch.bfloat16)[..., :samples].cpu().double()
                ry = ry.cpu().double()
                err += [float(torch.sum((y[b:b + block].double() - ry) ** 2)),
                        float(torch.sum((rb - ry) ** 2)), float(torch.sum(ry ** 2))]
    shares = np.concatenate(mismatch)  # by clip; every clip has the same entries
    run.counters["code_mismatch_worst_clip"] = float(np.max(shares))
    run.check("code_mismatch", float(np.mean(shares)))
    run.counters["audio_rel_err"] = float((err[0] / err[2]) ** 0.5)
    run.counters["bf16_reference_rel_err"] = float((err[1] / err[2]) ** 0.5)
    run.check("audio_err_ratio", float((err[0] / max(err[1], 1e-300)) ** 0.5))
