"""Live streams, open loop: ``streams`` streams, each sending blocks of
``block_s`` seconds in real time from its own seeded clip of ``clip_s``
seconds, looped, starting at phases spread evenly over ``[0, phase_s)``
and dealt to the streams in a seeded order;
``warmup_s`` seconds of that traffic run before the window.

The program: ``CodecProcessor(live codec, fused_quantizer=True)`` ->
``StreamPool`` (windows of ``window_s`` at VBR ``level``, batches of at most
``max_batch``) -> ``PacketCodec`` (each chunk range-coded into a packet by
the stream's sender and unpacked by its receiver) -> ``DecoderPool``. One
loop pushes every block as it falls due and, every ``poll_s`` seconds (a
fixed cadence, as a server that works in periods), polls the encoder pool,
packs and unpacks what it returned, queues it on the decoder pool and polls
that. A poll that runs late skips the ticks it missed.

A window's latency runs from when its last sample was due (the end of the
block that holds it) until its decoded hop segment left ``DecoderPool``.
``window_latency_p95_ms`` is over every window due in the window; one that
has not come ``grace_s`` after the window closed is a miss and fails
``correct``. Correct: on every window due in the window (or
``sample_windows`` of them drawn from the seed, where there are more), the
share of their codes and kept stages that differ
from the padding-free reference's, packets that did not give back
what was packed, and the worst window's relative error of the decoded
segment against the reference's decode of the unpacked codes. With the
mix's ``impl: control`` the reference in TF32 gives the answers of the same
windows (no loop: their codes, counts and decoded segments)."""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import clips, judge, weights
from ..tracing import Tracer


class Schedule:
    """The streams' clips, phases and the due times of blocks and windows,
    from the seed."""

    def __init__(self, run, sr: int, geometry):
        mix = run.mix
        self.n = mix["streams"]
        self.block = int(round(mix["block_s"] * sr))
        self.block_s = mix["block_s"]
        self.window, self.hop, self.frames, self.delay = geometry
        # the same start phases for every seed, evenly over [0, phase_s),
        # dealt to the streams in the seed's order: a seed changes which
        # clip arrives when, not when the arrivals come
        grid = (np.arange(self.n) + 0.5) / self.n * mix["phase_s"]
        self.phase = grid[judge.rng(run.seed, 4).permutation(self.n)]
        samples = int(mix["clip_s"] * sr)
        self.clips = clips.clips(self.n, samples, sr, weights.generator(
            run.seed, run.device, 1), run.device).cpu().numpy()
        self.length = samples

    def block_due(self, s: int, b: int, t0: float) -> float:
        return t0 + self.phase[s] + (b + 1) * self.block_s

    def samples(self, s: int, start: int, n: int) -> np.ndarray:
        idx = (start + np.arange(n)) % self.length
        return self.clips[s, idx]

    def window_due(self, s: int, w: int, t0: float) -> float:
        last = w * self.hop + self.window - self.delay - 1
        return self.block_due(s, last // self.block, t0)

    def window_input(self, s: int, w: int) -> np.ndarray:
        """The padded stream's samples of window ``w``: the delay's zeros,
        then the looped clip."""
        p = w * self.hop + np.arange(self.window) - self.delay
        x = self.clips[s, p % self.length]
        return np.where(p >= 0, x, 0.0).astype(np.float32)


def _program(run, host, dev):
    from vrvq_tpu_torch.infer.codec_api import CodecProcessor

    from .. import program

    return CodecProcessor(program.codec(run.keys, host, dev), fused_quantizer=True)


def drive(run) -> None:
    dev = torch.device(run.device)
    keys, mix = run.keys, run.mix
    sr = keys["DAC_VRVQ.sample_rate"]
    with torch.inference_mode():
        ref = judge.reference_codec(keys, run.seed, dev)
        host = weights.host_state(ref)
        del ref
        if mix.get("impl", "program") == "control":
            return control(run, host, dev)
        proc = _program(run, host, dev)
        del host
        sched = Schedule(run, sr, proc.window_geometry(mix["window_s"]))
        record = serve(run, proc, sched)
        if dev.type == "cuda":
            run.memory_peak_bytes = torch.cuda.max_memory_allocated()
        del proc
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        judge_windows(run, sched, record, dev)


def warm(proc, mix, window: int) -> None:
    """Every pool batch shape: each power of two up to ``max_batch``, encoded
    and decoded."""
    rvq = proc.prepared_rvq()
    b = 1
    while b <= mix["max_batch"]:
        x = proc.put_batch(np.zeros((b, 1, window), np.float32))
        codes, counts = proc.encode_rows(False, x, None, mix["level"], rvq)
        nq = codes.shape[1]
        mask = (torch.arange(nq, device=codes.device)[None, :, None]
                < counts[:, None, :]).float()
        proc.decode_rows(False, proc.put_batch(codes.long().cpu().numpy()),
                         proc.put_batch(mask.cpu().numpy()))
        b *= 2
    if proc.device.type == "cuda":
        torch.cuda.synchronize()


def serve(run, proc, sched) -> dict:
    """The open loop. Returns, by (stream, window), the window's due time,
    when it came back, its codes and counts as encoded and as unpacked, and
    its decoded segment."""
    from vrvq_tpu_torch.infer.streaming import DecoderPool, PacketCodec, StreamPool

    mix, keys = run.mix, run.keys
    nq, size = keys["DAC_VRVQ.n_codebooks"], keys["DAC_VRVQ.codebook_size"]
    warm(proc, mix, sched.window)
    pool = StreamPool(proc, mix["window_s"], level=mix["level"], max_batch=mix["max_batch"])
    dpool = DecoderPool(proc, mix["window_s"], max_batch=mix["max_batch"])
    tx = [PacketCodec(nq, size) for _ in range(sched.n)]
    rx = [PacketCodec(nq, size) for _ in range(sched.n)]
    for s in range(sched.n):
        pool.add_stream(s)
    encoded, decoded = [0] * sched.n, [0] * sched.n
    next_block = [0] * sched.n
    out: dict = {}
    rows: list = []
    tracer = Tracer() if run.trace else None
    if tracer:
        tracer.prime()
    run.setup_s = time.perf_counter() - run.started

    t0 = time.perf_counter() + 0.05
    w0 = t0 + mix["warmup_s"]
    w1 = w0 + run.seconds
    deadline = w1 + mix["grace_s"]
    # the traced part is the window's last ``trace_s``: the tracer slows
    # the host's loop and leaves a backlog, so the per-layer numbers are
    # read from the windows due, and the polls made, before it began
    trace_from = w1 - mix["trace_s"] if tracer else w1
    polls = traced_from = 0
    due = [sched.block_due(s, 0, t0) for s in range(sched.n)]
    pending_due: set = set()  # windows due in the window not yet back
    in_window = False
    next_poll = t0 + mix["poll_s"]
    while True:
        now = time.perf_counter()
        if not in_window and now >= w0:
            in_window, polls = True, 0
            run.spans.clear()
        if tracer and tracer.prof is None and now >= trace_from:
            tracer.start()
            traced_from = polls
        with run.span("push", record=False):
            for s in range(sched.n):
                while due[s] <= now:
                    b = next_block[s]
                    pool.push(s, sched.samples(s, b * sched.block, sched.block))
                    next_block[s] = b + 1
                    due[s] = sched.block_due(s, b + 1, t0)
        got = []
        if now >= next_poll:
            while next_poll <= now:  # a fixed cadence: a late poll skips ticks
                next_poll += mix["poll_s"]
            with run.span("poll.encode"):
                got = pool.poll()
        if got:
            with run.span("packets"):
                for s, codes, counts in got:
                    w = encoded[s]
                    encoded[s] += 1
                    if run.fault == "alter_codes":
                        codes = (codes + 1) % size
                    c2, n2 = rx[s].unpack(tx[s].pack(codes, counts))
                    dpool.push(s, c2, n2)
                    wd = sched.window_due(s, w, t0)
                    out[(s, w)] = [wd, None, codes, counts, c2, n2, None]
                    if w0 <= wd < w1:
                        pending_due.add((s, w))
            with run.span("poll.decode"):
                back = dpool.poll()
            t_back = time.perf_counter()
            for s, audio in back:
                w = decoded[s]
                decoded[s] += 1
                if run.fault == "alter_audio":
                    audio = -audio
                rec = out[(s, w)]
                rec[1], rec[6] = t_back, audio
                pending_due.discard((s, w))
            if in_window and now < w1:
                polls += 1
                rows.append((now, len(got)))
        if now >= w1 and (not pending_due or now >= deadline):
            break
        if not got:
            with run.span("idle", record=False):
                wake = min(min(due), next_poll)
                time.sleep(max(0.0, min(wake - time.perf_counter(), 0.002)))
    if tracer and tracer.active:
        tracer.stop(units=polls - traced_from)
    run.traced = tracer.summary if tracer else None
    if proc.device.type == "cuda":
        torch.cuda.synchronize()
    window = {k: v for k, v in out.items() if w0 <= v[0] < w1}
    lat = np.array([(v[1] - v[0]) if v[1] is not None else np.inf for v in window.values()])
    run.window_s = run.seconds
    run.units = run.attempted = len(lat)
    run.failed = int(np.sum(~np.isfinite(lat)))
    finite = np.where(np.isfinite(lat), lat, time.perf_counter() - w0)
    run.e2e["window_latency_p95_ms"] = float(np.percentile(finite, 95) * 1e3) if len(lat) else float("inf")
    # the per-layer numbers: the windows due a second before the traced part
    dues = np.array([v[0] for v in window.values()])
    early = finite[dues < trace_from - 1.0]
    run.counters["latency_p50_ms"] = float(np.percentile(early, 50) * 1e3) if len(early) else None
    kept = [n for t, n in rows if t < trace_from]
    run.counters["pool_rows"] = float(np.mean(kept)) if kept else None
    order = np.argsort(dues)
    third = max(1, len(order) // 3)
    if len(order) >= 3:
        run.counters["latency_growth_ms"] = float(
            (np.median(finite[order[-third:]]) - np.median(finite[order[:third]])) * 1e3)
    run.counters["polls"] = float(len(rows))
    run.check("windows_missing", run.failed)
    return window


def judge_windows(run, sched, record: dict, dev) -> None:
    mix = run.mix
    keys = sorted(k for k, v in record.items() if v[1] is not None)
    n = min(mix["sample_windows"], len(keys))
    picked = [keys[i] for i in sorted(judge.rng(run.seed, 5).choice(len(keys), n, replace=False))]
    ref = judge.reference_codec(run.keys, run.seed, dev, padding=False)
    block = mix.get("reference_block", 16)
    mismatch, err, bad_packets = [], [], 0
    with judge.precision("exact"):
        for i in range(0, n, block):
            part = picked[i:i + block]
            x = torch.from_numpy(np.stack([sched.window_input(s, w) for s, w in part]))
            rc, rn = ref.encode(x[:, None].to(dev), mix["level"])
            codes = np.stack([record[k][2] for k in part])
            counts = np.stack([record[k][3] for k in part])
            mismatch.append(judge.code_mismatch(codes, counts, rc.cpu(), rn.cpu()))  # by window
            c2 = np.stack([record[k][4] for k in part])
            n2 = np.stack([record[k][5] for k in part])
            bad_packets += int(np.sum(judge.code_mismatch(c2, n2, codes, counts) > 0))
            ry = ref.decode(torch.from_numpy(c2).to(dev).long(),
                            torch.from_numpy(n2.astype(np.int64)).to(dev))
            audio = np.stack([record[k][6] for k in part])
            err.append(judge.rel_err(audio, ry[:, 0].cpu()))
    run.check("code_mismatch", float(np.mean(np.concatenate(mismatch))) if mismatch else float("nan"))
    run.check("packet_mismatch", bad_packets)
    run.check("audio_rel_err", float(np.max(np.concatenate(err))) if err else float("nan"))


def control(run, host, dev) -> None:
    """The reference in TF32 in the program's place, on the windows due in
    a window of the cell's length after the warm-up traffic."""
    from vrvq_tpu_torch.infer.codec_api import CodecProcessor

    from .. import program

    mix = run.mix
    sr = run.keys["DAC_VRVQ.sample_rate"]
    geometry = CodecProcessor(program.codec(run.keys, host, "cpu")).window_geometry(mix["window_s"])
    sched = Schedule(run, sr, geometry)
    w0, w1 = mix["warmup_s"], mix["warmup_s"] + run.seconds
    wins = [(s, w) for s in range(sched.n) for w in range(int((w1 + 2) * sr / sched.hop))
            if w0 <= sched.window_due(s, w, 0.0) < w1]
    ref = judge.reference_codec(run.keys, run.seed, dev, padding=False)
    record = {}
    with judge.precision("tf32"):
        for i in range(0, len(wins), 64):
            part = wins[i:i + 64]
            x = torch.from_numpy(np.stack([sched.window_input(s, w) for s, w in part]))
            codes, counts = ref.encode(x[:, None].to(dev), mix["level"])
            audio = ref.decode(codes, counts)[:, 0].cpu().numpy()
            codes = codes.cpu().numpy().astype(np.int32)
            counts = counts.cpu().numpy().astype(np.uint8)
            for j, k in enumerate(part):
                record[k] = [0.0, 0.0, codes[j], counts[j], codes[j], counts[j], audio[j]]
    run.attempted = run.units = len(wins)
    run.check("windows_missing", 0)
    judge_windows(run, sched, record, dev)
