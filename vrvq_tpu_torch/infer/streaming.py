"""Push-style streaming codec: unbounded audio in, codes out, in constant
memory; many streams through batched windows; entropy-coded packets.

Counterpart of ``vrvq_tpu/infer/streaming.py``. The classes keep the window
arithmetic of ``CodecProcessor.compress`` (``window_geometry``: padding-free
codec, delay-padded stream ends, stride of one window's padding-free decode
length) as state:

  * ``StreamingEncoder.push(samples)`` takes blocks of any size and returns
    ``(codes, vbr_counts)`` chunks as windows fill; for audio in [-1, 1] and
    a stream longer than the window, the concatenated codes equal
    ``compress(..., normalize_db=None)``'s (loudness and peak normalization
    are global gains a live stream cannot know; gain-stage upstream);
  * ``StreamingDecoder.push(codes)`` returns hop-sized waveforms that
    concatenate to ``decompress``'s output before normalization;
  * ``StreamPool`` / ``DecoderPool`` stack the ready windows of many streams
    into batches of at most ``max_batch``, padded to a power of two, and
    queue every batch on the device before fetching any (one copy in, one
    copy out per poll);
  * ``PacketCodec`` range-codes each chunk into one self-delimiting packet
    with adaptive models that persist across packets.

Spans (``utils.annotate``): each pool's ``poll`` that took windows is
``stream_pool.poll`` / ``decoder_pool.poll`` (payload: the windows) with the
children ``.stack`` (host arrays), ``.put`` (the copy in; payload: the rows
sent, padding included), ``.launch`` (the host issuing the batches) and
``.fetch`` (the wait for the device and the copy out); each window's wait
in ``StreamPool``'s queue, from the ``push`` that completed it to the start
of the poll that took it, is a ``stream_pool.wait`` record keyed by
``stream`` and ``window`` (its index in the stream); ``packet.pack`` and
``packet.unpack`` carry the packet's bytes.

A ``DAC_MOE`` streams in CBR only: its VBR mask is no prefix of the stages
(``infer/codec_api.py``). Over a processor of several cards the pools pad
each batch up to a multiple of the card count, so that every card takes an
equal row block of it. Algorithmic latency: the first chunk appears after
``window - delay`` real samples; each chunk covers ``hop`` samples.
"""

from __future__ import annotations

import math
import struct
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..ops.rangecoder import AdaptiveCoder
from ..utils import add_span, annotate
from .codec_api import CodecProcessor, check_counts_hold_mask


def _padded_batch(b: int, n_devices: int = 1) -> int:
    """A pool batch padded to the next power of two (at most log2(max_batch)
    + 1 batch shapes ever reach the convs), then up to a multiple of the
    card count, so the batch splits evenly over the cards."""
    bp = max(1 << (b - 1).bit_length(), n_devices)
    return bp + (-bp) % n_devices


def _stage_mask(counts: Optional[np.ndarray], n_q: int, frames: int) -> np.ndarray:
    """(Nq, frames) float32 mask of the stages kept (all without counts)."""
    if counts is None:
        return np.ones((n_q, frames), np.float32)
    return (np.arange(n_q)[:, None] < np.asarray(counts)[None, :]).astype(np.float32)


class _WindowBuffer:
    """Per-stream host state: an incremental sample stream into the fixed
    windows of the windowed codec (left delay pad, stride ``hop``, right
    delay pad and zero tail at flush). Buffering only, so one stream
    (``StreamingEncoder``) and many (``StreamPool``) share the arithmetic."""

    def __init__(self, window: int, hop: int, delay: int):
        self.window, self.hop, self.delay = window, hop, delay
        # samples of the padded stream from absolute index `_start`; window
        # w covers padded[w * hop: w * hop + window]
        self._buf = np.zeros((delay,), np.float32)  # left delay pad
        self._start = 0
        self._windows_out = 0
        self._real_len = 0
        self.flushed = False

    def push(self, samples: np.ndarray) -> List[np.ndarray]:
        """Buffer a block; return the windows it completed."""
        if self.flushed:
            raise RuntimeError("push() after flush()")
        samples = np.asarray(samples, np.float32).reshape(-1)
        self._buf = np.concatenate([self._buf, samples])
        self._real_len += len(samples)
        out = []
        while True:
            begin = self._windows_out * self.hop
            end = begin + self.window
            if end > self._start + len(self._buf):
                return out
            out.append(self._buf[begin - self._start: end - self._start])
            self._windows_out += 1
            # nothing before the next window's start is needed again
            keep_from = self._windows_out * self.hop
            if keep_from > self._start:
                self._buf = self._buf[keep_from - self._start:]
                self._start = keep_from

    def flush(self) -> List[np.ndarray]:
        """End of stream: the remaining windows (right delay pad and zero
        tail), as ``compress``'s last windows."""
        if self.flushed:
            return []
        self.flushed = True
        self._buf = np.concatenate([self._buf, np.zeros((self.delay,), np.float32)])
        total_windows = math.ceil(self._real_len / self.hop)
        out = []
        while self._windows_out < total_windows:
            begin = self._windows_out * self.hop
            x = self._buf[begin - self._start: begin - self._start + self.window]
            if len(x) < self.window:
                x = np.pad(x, (0, self.window - len(x)))
            self._windows_out += 1
            out.append(x)
        return out


class StreamingEncoder:
    """Incremental windowed encoder over a ``CodecProcessor``: one mono
    stream at the model's rate, gain-staged to [-1, 1] upstream. Parameters
    as ``CodecProcessor.compress``'s; the fused quantizer's weights are
    prepared once, here."""

    def __init__(self, proc: CodecProcessor, win_duration: float = 1.0,
                 n_quantizers: Optional[int] = None,
                 level: Optional[float] = None):
        self.proc = proc
        self.n_quantizers = n_quantizers
        self.level = level if level is not None else 1.0
        self.vbr = n_quantizers is None and level is not None
        check_counts_hold_mask(proc.model, self.vbr)
        self.window, self.hop, self.chunk_frames, self.delay = (
            proc.window_geometry(win_duration))
        self._rvq = proc.prepared_rvq()
        self._wb = _WindowBuffer(self.window, self.hop, self.delay)

    @property
    def samples_to_first_chunk(self) -> int:
        """Real samples needed before the first chunk appears."""
        return self.window - self.delay

    def _encode_window(self, x: np.ndarray):
        with torch.inference_mode():
            codes, counts = self.proc.encode_rows(
                False, self.proc.put_batch(x[None, None, :]),
                self.n_quantizers, self.level, self._rvq)
            codes = codes[0].cpu().numpy()
            counts = counts[0].cpu().numpy() if self.vbr else None
        if codes.shape[-1] != self.chunk_frames:
            raise RuntimeError(
                f"window geometry drift: expected {self.chunk_frames} frames, "
                f"the model produced {codes.shape[-1]}")
        return codes, counts

    def push(self, samples: np.ndarray) -> List[Tuple[np.ndarray, Optional[np.ndarray]]]:
        """Feed a block of samples (any length); returns the ``(codes (Nq,
        F), vbr_counts (F,) | None)`` chunks whose windows completed."""
        return [self._encode_window(x) for x in self._wb.push(samples)]

    def flush(self) -> List[Tuple[np.ndarray, Optional[np.ndarray]]]:
        """End of stream: the chunks of the remaining windows."""
        return [self._encode_window(x) for x in self._wb.flush()]


class StreamPool:
    """Many live streams through batched encodes: ``push`` only buffers;
    ``poll`` stacks every ready window of every stream into batches of at
    most ``max_batch`` (the last padded to a power of two), queues them all
    on the device, then fetches. Codes equal the single-stream encoder's on
    the CPU (the batch is a parallel axis of every op there); on the card
    another batch size may take another conv algorithm, so a near tie may
    flip."""

    def __init__(self, proc: CodecProcessor, win_duration: float = 1.0,
                 n_quantizers: Optional[int] = None,
                 level: Optional[float] = None, max_batch: int = 8):
        self.proc = proc
        self.n_quantizers = n_quantizers
        self.level = level if level is not None else 1.0
        self.vbr = n_quantizers is None and level is not None
        check_counts_hold_mask(proc.model, self.vbr)
        self.max_batch = int(max_batch)
        self.window, self.hop, self.chunk_frames, self.delay = (
            proc.window_geometry(win_duration))
        self._rvq = proc.prepared_rvq()
        self._streams: dict = {}
        # (sid, window, when it became ready (perf_counter_ns), its index)
        self._pending: List[Tuple[Any, np.ndarray, int, int]] = []

    def add_stream(self, sid) -> None:
        if sid in self._streams:
            raise ValueError(f"stream {sid!r} already exists")
        self._streams[sid] = _WindowBuffer(self.window, self.hop, self.delay)

    def _queue(self, sid, buf: _WindowBuffer, windows: List[np.ndarray]) -> None:
        ready = time.perf_counter_ns()
        first = buf._windows_out - len(windows)
        self._pending += [(sid, w, ready, first + j) for j, w in enumerate(windows)]

    def push(self, sid, samples: np.ndarray) -> None:
        """Buffer a block for one stream; encoding happens in ``poll``."""
        buf = self._streams[sid]
        self._queue(sid, buf, buf.push(samples))

    def flush(self, sid) -> None:
        """Queue the stream's tail windows and remove it."""
        buf = self._streams.pop(sid)
        self._queue(sid, buf, buf.flush())

    def poll(self) -> List[Tuple[Any, np.ndarray, Optional[np.ndarray]]]:
        """Encode every pending window, batched; returns ``[(sid, codes
        (Nq, F), counts (F,) | None), ...]`` in per-stream FIFO order."""
        pending, self._pending = self._pending, []
        if not pending:
            return []
        with annotate("stream_pool.poll", payload=len(pending)) as span:
            with annotate("stream_pool.poll.stack"):
                batches = [pending[i: i + self.max_batch]
                           for i in range(0, len(pending), self.max_batch)]
                sizes = [_padded_batch(len(take), self.proc.n_devices) for take in batches]
                xs = np.zeros((sum(sizes), 1, self.window), np.float32)
                rows = []  # the row of each pending window in xs
                for take, r0 in zip(batches, np.cumsum([0] + sizes[:-1])):
                    for j, (_, w, _, _) in enumerate(take):
                        xs[r0 + j, 0] = w
                        rows.append(r0 + j)
            codes, counts = [], []
            with torch.inference_mode():
                with annotate("stream_pool.poll.put", payload=len(xs)):
                    on_device = self.proc.put_batches(xs, sizes)
                with annotate("stream_pool.poll.launch"):
                    for x in on_device:
                        c, n = self.proc.encode_rows(False, x, self.n_quantizers,
                                                     self.level, self._rvq)
                        codes.append(c)
                        counts.append(n)
                with annotate("stream_pool.poll.fetch"):
                    codes = torch.cat(codes).cpu().numpy()
                    counts = torch.cat(counts).cpu().numpy() if self.vbr else None
        for sid, _, ready, index in pending:
            add_span("stream_pool.wait", ready, span.start_ns, stream=sid, window=index)
        return [(sid, codes[r], counts[r] if self.vbr else None)
                for (sid, _, _, _), r in zip(pending, rows)]


class DecoderPool:
    """Decode side of ``StreamPool``: whole chunks of many streams decode in
    batches (power-of-two padded), all queued before any is fetched. Audio
    equals per-stream ``StreamingDecoder`` pushes to float rounding (the
    convs may sum in another order at another batch size)."""

    def __init__(self, proc: CodecProcessor, win_duration: float = 1.0,
                 max_batch: int = 8):
        self.proc = proc
        self.max_batch = int(max_batch)
        _, self.hop, self.chunk_frames, _ = proc.window_geometry(win_duration)
        self._pending: List[Tuple[Any, np.ndarray, Optional[np.ndarray]]] = []

    def push(self, sid, codes: np.ndarray,
             counts: Optional[np.ndarray] = None) -> None:
        """Queue one whole encoder chunk (Nq, chunk_frames) of a stream."""
        codes = np.asarray(codes)
        if codes.shape[-1] != self.chunk_frames:
            raise ValueError(f"expected whole chunks of {self.chunk_frames} "
                             f"frames, got {codes.shape[-1]}")
        self._pending.append((sid, codes, counts))

    def poll(self) -> List[Tuple[Any, np.ndarray]]:
        """Decode every pending chunk, batched; returns ``[(sid, audio
        (hop,)), ...]`` in push order."""
        pending, self._pending = self._pending, []
        if not pending:
            return []
        with annotate("decoder_pool.poll", payload=len(pending)):
            with annotate("decoder_pool.poll.stack"):
                batches = [pending[i: i + self.max_batch]
                           for i in range(0, len(pending), self.max_batch)]
                sizes = [_padded_batch(len(take), self.proc.n_devices) for take in batches]
                nq, cf = pending[0][1].shape[0], self.chunk_frames
                codes = np.zeros((sum(sizes), nq, cf), np.int32)
                mask = np.zeros((sum(sizes), nq, cf), np.float32)
                rows = []
                for take, r0 in zip(batches, np.cumsum([0] + sizes[:-1])):
                    for j, (_, c, cnt) in enumerate(take):
                        codes[r0 + j] = c
                        mask[r0 + j] = _stage_mask(cnt, nq, cf)
                        rows.append(r0 + j)
            with torch.inference_mode():
                with annotate("decoder_pool.poll.put", payload=len(codes)):
                    codes = self.proc.put_batches(codes, sizes)
                    mask = self.proc.put_batches(mask, sizes)
                with annotate("decoder_pool.poll.launch"):
                    parts = [self.proc.decode_rows(False, c.map(torch.Tensor.long), m)
                             for c, m in zip(codes, mask)]
                with annotate("decoder_pool.poll.fetch"):
                    audio = torch.cat(parts).cpu().numpy()
        return [(sid, audio[r, 0]) for (sid, _, _), r in zip(pending, rows)]


class StreamingDecoder:
    """Incremental decoder: frame blocks in, hop-sized waveforms out.
    ``win_duration`` must match the encoder's (the chunk size follows from
    it); ``chunk_frames`` overrides that derivation."""

    def __init__(self, proc: CodecProcessor, *, win_duration: float = 1.0,
                 chunk_frames: Optional[int] = None):
        self.proc = proc
        if chunk_frames is None:
            _, _, chunk_frames, _ = proc.window_geometry(win_duration)
        self.chunk_frames = chunk_frames
        self._codes: Optional[np.ndarray] = None   # (Nq, F) pending
        self._counts: Optional[np.ndarray] = None  # (F,) pending (VBR)
        self._flushed = False

    def _decode_chunk(self, c: np.ndarray, counts: Optional[np.ndarray]) -> np.ndarray:
        mask = _stage_mask(counts, c.shape[0], c.shape[-1])
        with torch.inference_mode():
            r = self.proc.decode_rows(
                False, self.proc.put_batch(c[None].astype(np.int32)).map(
                    torch.Tensor.long), self.proc.put_batch(mask[None]))
            return r[0, 0].cpu().numpy()

    def push(self, codes: np.ndarray,
             counts: Optional[np.ndarray] = None) -> List[np.ndarray]:
        """Feed a block of code frames (Nq, F). Each encoder chunk decodes on
        its own (the windows overlap on the encoder side), so every whole
        chunk decodes at once; a partial chunk waits."""
        if self._flushed:
            raise RuntimeError("push() after flush()")
        codes = np.asarray(codes)
        if self._codes is None:
            self._codes, self._counts = codes, counts
        else:
            self._codes = np.concatenate([self._codes, codes], axis=-1)
            if counts is not None:
                self._counts = (counts if self._counts is None
                                else np.concatenate([self._counts, counts], axis=-1))
        cf = self.chunk_frames
        out = []
        while self._codes.shape[-1] >= cf:
            c, self._codes = self._codes[..., :cf], self._codes[..., cf:]
            cnt = None
            if self._counts is not None:
                cnt, self._counts = self._counts[..., :cf], self._counts[..., cf:]
            out.append(self._decode_chunk(c, cnt))
        return out

    def flush(self) -> List[np.ndarray]:
        """Decode a trailing partial chunk, zero-padded to a whole one as
        ``decompress`` does (the whole hop-length segment comes back: trim
        the concatenation to the stream's length)."""
        if self._flushed:
            return []
        self._flushed = True
        if self._codes is None or self._codes.shape[-1] == 0:
            return []
        cf = self.chunk_frames
        frames = self._codes.shape[-1]
        c = np.pad(self._codes, ((0, 0), (0, cf - frames)))
        cnt = None
        if self._counts is not None:
            cnt = np.pad(self._counts, (0, cf - self._counts.shape[-1]))
        self._codes = self._counts = None
        return [self._decode_chunk(c, cnt)]


class PacketCodec:
    """Entropy-coded wire format of a code stream, the same bytes as the JAX
    package's: each ``(codes (Nq, F), vbr_counts (F,) | None)`` chunk becomes
    one self-delimiting packet, range-coded with adaptive per-stage models
    that persist across packets (``ops/rangecoder.AdaptiveCoder``).

    Sender and receiver each hold an instance; they stay in sync iff packets
    are unpacked whole and in the order they were packed (``unpack`` rejects
    a truncated or over-long packet: decoding garbage would poison the
    models for the rest of the stream). Layout, little-endian: u16 frames F,
    u8 vbr flag, u8 stages, then (VBR) u16 counts-payload length and the
    payload, then u32 codes-payload length and the payload."""

    def __init__(self, n_codebooks: int, codebook_size: int):
        self.n_codebooks = n_codebooks
        self._codes_coder = AdaptiveCoder(codebook_size, n_codebooks)
        self._counts_coder = AdaptiveCoder(n_codebooks + 1)

    @staticmethod
    def _contexts(counts: Optional[np.ndarray], frames: int, nq: int):
        if counts is None:  # CBR: the chunk's nq stages, (t, stage) order
            return np.tile(np.arange(nq), frames)
        stage = np.broadcast_to(np.arange(nq), (frames, nq))
        return stage[stage < np.asarray(counts)[:, None]]

    def pack(self, codes: np.ndarray, counts: Optional[np.ndarray] = None) -> bytes:
        with annotate("packet.pack") as span:
            packet = self._pack(codes, counts)
            span.payload = len(packet)
        return packet

    def _pack(self, codes: np.ndarray, counts: Optional[np.ndarray]) -> bytes:
        codes = np.asarray(codes)
        nq, frames = codes.shape
        if nq > self.n_codebooks:
            raise ValueError(f"chunk has {nq} codebooks, codec built for "
                             f"{self.n_codebooks}")
        header = struct.pack("<HBB", frames, 1 if counts is not None else 0, nq)
        body = b""
        if counts is not None:
            counts = np.asarray(counts)
            cp = self._counts_coder.encode(counts)
            body += struct.pack("<H", len(cp)) + cp
            kept = codes.T[np.arange(nq)[None, :] < counts[:, None]]
        else:
            kept = codes.T.reshape(-1)  # (t, stage) order
        payload = self._codes_coder.encode(kept, self._contexts(counts, frames, nq))
        return header + body + struct.pack("<I", len(payload)) + payload

    def unpack(self, packet: bytes) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        with annotate("packet.unpack", payload=len(packet)):
            return self._unpack(packet)

    def _unpack(self, packet: bytes) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        frames, vbr, nq = struct.unpack_from("<HBB", packet, 0)
        off = 4
        counts = None
        if vbr:
            (clen,) = struct.unpack_from("<H", packet, off)
            off += 2
            if off + clen > len(packet):
                raise ValueError("truncated packet (counts payload)")
            counts = self._counts_coder.decode(
                packet[off: off + clen], frames).astype(np.uint8)
            off += clen
        (plen,) = struct.unpack_from("<I", packet, off)
        off += 4
        if off + plen != len(packet):
            raise ValueError(f"corrupt packet: {len(packet) - off} payload "
                             f"bytes, header says {plen}")
        ctx = self._contexts(counts, frames, nq)
        kept = self._codes_coder.decode(packet[off: off + plen], ctx.size, ctx)
        codes = np.zeros((frames, nq), np.int32)
        if counts is not None:
            codes[np.arange(nq)[None, :] < counts[:, None]] = kept.astype(np.int32)
        else:
            codes = kept.astype(np.int32).reshape(frames, nq)
        return codes.T, counts
