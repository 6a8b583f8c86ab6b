"""Adaptive range coder for the entropy-coded ``.dac`` and the stream's
packets (host-side, lossless).

The port's own copy of the pure-Python coder of ``vrvq_tpu/ops/rangecoder.py``,
so that the same symbols give the same bytes in both packages: the
carry-counting byte-wise range coder (Subbotin / LZMA ``ShiftLow``): 32-bit
range, 2^24 renormalization, 5-byte flush. One adaptive model per context:
a Fenwick tree of symbol counts, +32 per hit, halved when the total reaches
2^16. Encoder and decoder update alike, so no table is stored.

``AdaptiveCoder`` codes through the native library's C++ coder
(``native/io.py``, the port's copy of the JAX package's ``rangecoder.cc``:
byte-identical output) by default, and through the Python coder here, its
plain version, with ``backend="python"`` or where the library is
unavailable (it then warns once with the reason).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from ..native import io as native_io

_TOP = 1 << 24
_MASK32 = 0xFFFFFFFF
_INC = 32
_LIMIT = 1 << 16


class _Fenwick:
    """Counts with O(log n) prefix-sum / update / find-by-cumulative."""

    def __init__(self, n: int):
        self.n = n
        # round up to a power of two for the descend in find()
        self.size = 1
        while self.size < n:
            self.size *= 2
        self.tree = [0] * (self.size + 1)
        self.total = 0
        for i in range(n):
            self._add(i, 1)

    def _add(self, i: int, delta: int) -> None:
        self.total += delta
        i += 1
        while i <= self.size:
            self.tree[i] += delta
            i += i & (-i)

    def prefix(self, i: int) -> int:
        """Sum of counts of symbols < i."""
        s = 0
        while i > 0:
            s += self.tree[i]
            i -= i & (-i)
        return s

    def find(self, cum: int):
        """(symbol, prefix(symbol)) with prefix(symbol) <= cum <
        prefix(symbol)+count(symbol)."""
        idx = 0
        bit = self.size
        rest = cum
        while bit:
            nxt = idx + bit
            if nxt <= self.size and self.tree[nxt] <= rest:
                rest -= self.tree[nxt]
                idx = nxt
            bit >>= 1
        return idx, cum - rest

    def update(self, sym: int) -> None:
        self._add(sym, _INC)
        if self.total >= _LIMIT:
            # halve all counts (keeping >= 1): rebuild
            counts = [
                max(1, (self.prefix(i + 1) - self.prefix(i)) // 2)
                for i in range(self.n)
            ]
            self.tree = [0] * (self.size + 1)
            self.total = 0
            for i, c in enumerate(counts):
                self._add(i, c)


class _Encoder:
    def __init__(self):
        self.low = 0  # up to 33 bits before shift
        self.range = _MASK32
        self.cache = 0
        self.cache_size = 1
        self.out = bytearray()

    def _shift_low(self):
        if self.low < 0xFF000000 or self.low > _MASK32:
            carry = self.low >> 32
            self.out.append((self.cache + carry) & 0xFF)
            while self.cache_size > 1:
                self.out.append((0xFF + carry) & 0xFF)
                self.cache_size -= 1
            self.cache = (self.low >> 24) & 0xFF
        else:
            self.cache_size += 1
        self.low = (self.low << 8) & _MASK32

    def encode(self, start: int, size: int, total: int):
        self.range //= total
        self.low += start * self.range
        self.range *= size
        while self.range < _TOP:
            self.range = (self.range << 8) & _MASK32
            self._shift_low()

    def flush(self) -> bytes:
        for _ in range(5):
            self._shift_low()
        return bytes(self.out)


class _Decoder:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.range = _MASK32
        self.code = 0
        for _ in range(5):
            self.code = ((self.code << 8) | self._byte()) & ((1 << 40) - 1)
        self.code &= _MASK32

    def _byte(self) -> int:
        b = self.data[self.pos] if self.pos < len(self.data) else 0
        self.pos += 1
        return b

    def get_cum(self, total: int) -> int:
        self.range //= total
        return min(self.code // self.range, total - 1)

    def decode(self, start: int, size: int):
        self.code -= start * self.range
        self.range *= size
        while self.range < _TOP:
            self.code = ((self.code << 8) | self._byte()) & _MASK32
            self.range = (self.range << 8) & _MASK32


class AdaptiveCoder:
    """Stateful adaptive coder: the frequency models persist across
    ``encode`` / ``decode`` calls (each call is one independently flushed
    packet), so a sender and a receiver stay in sync as long as packets are
    coded and decoded in order (``infer/streaming.PacketCodec``).

    ``backend``: ``"native"`` (the C++ coder; raises where the library is
    unavailable), ``"python"`` (the plain coder) or ``"auto"`` (native where
    the library loads). Both give the same bytes."""

    def __init__(self, n_symbols: int, n_contexts: int = 1,
                 backend: str = "auto"):
        if backend not in ("auto", "native", "python"):
            raise ValueError(f"backend must be auto, native or python, got {backend!r}")
        self.n_symbols = n_symbols
        self.n_contexts = n_contexts
        self._lib = native_io.library() if backend != "python" else None
        if backend == "native" and self._lib is None:
            raise RuntimeError(f"the native range coder is unavailable: "
                               f"{native_io.reason()}")
        self._handle = None
        if self._lib is not None:
            # the C++ model takes n_symbols >= 2 (None otherwise, as in JAX:
            # the Python coder then serves)
            self._handle = self._lib.vrvq_rc_model_new(n_symbols, n_contexts)
            if not self._handle:
                self._lib = None
        if self._lib is None:
            self.models = [_Fenwick(n_symbols) for _ in range(n_contexts)]

    @property
    def backend(self) -> str:
        return "python" if self._lib is None else "native"

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.vrvq_rc_model_free(self._handle)

    def _ctx(self, contexts, size):
        ctx = (np.zeros(size, np.int64) if contexts is None
               else np.asarray(contexts).reshape(-1))
        if ctx.size != size:
            raise ValueError("contexts length must match symbols")
        if ctx.size and (ctx.min() < 0 or ctx.max() >= self.n_contexts):
            raise ValueError("context out of range")
        return ctx

    def encode(self, symbols: np.ndarray,
               contexts: Optional[np.ndarray] = None) -> bytes:
        symbols = np.asarray(symbols).reshape(-1)
        if symbols.size and (
            symbols.min() < 0 or symbols.max() >= self.n_symbols
        ):
            raise ValueError("symbol out of range")
        ctx = self._ctx(contexts, symbols.size)
        if self._lib is not None:
            syms = np.ascontiguousarray(symbols, np.int32)
            cx = np.ascontiguousarray(ctx, np.int32)
            cap = symbols.size * 4 + 64  # at most ~17 bits a symbol + the flush
            out = np.empty(cap, np.uint8)
            n = self._lib.vrvq_rc_encode(
                self._handle, syms.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                cx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), symbols.size,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
            if n < 0:
                raise RuntimeError("range coder output overflow")
            native_io.count("rc_encode_native")
            return out[:n].tobytes()
        enc = _Encoder()
        for s, c in zip(symbols.tolist(), ctx.tolist()):
            m = self.models[c]
            start = m.prefix(s)
            size = m.prefix(s + 1) - start
            enc.encode(start, size, m.total)
            m.update(s)
        return enc.flush()

    def decode(self, data: bytes, count: int,
               contexts: Optional[np.ndarray] = None) -> np.ndarray:
        ctx = self._ctx(contexts, count)
        if self._lib is not None:
            buf = np.frombuffer(bytes(data), np.uint8)
            cx = np.ascontiguousarray(ctx, np.int32)
            out = np.empty(max(count, 1), np.uint32)
            self._lib.vrvq_rc_decode(
                self._handle, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                buf.size, cx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), count,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
            native_io.count("rc_decode_native")
            return out[:count]
        dec = _Decoder(data)
        out = np.empty(count, np.uint32)
        for i in range(count):
            m = self.models[ctx[i]]
            cum = dec.get_cum(m.total)
            sym, start = m.find(cum)
            size = m.prefix(sym + 1) - start
            dec.decode(start, size)
            m.update(sym)
            out[i] = sym
        return out


def encode_adaptive(
    symbols: np.ndarray,
    n_symbols: int,
    contexts: Optional[np.ndarray] = None,
    n_contexts: int = 1,
    backend: str = "auto",
) -> bytes:
    """Range-code ``symbols`` (flat ints in [0, n_symbols)) with one adaptive
    model per context (flat ints in [0, n_contexts); None: one shared
    model). One-shot: fresh models per call."""
    return AdaptiveCoder(n_symbols, n_contexts, backend).encode(symbols, contexts)


def decode_adaptive(
    data: bytes,
    count: int,
    n_symbols: int,
    contexts: Optional[np.ndarray] = None,
    n_contexts: int = 1,
    backend: str = "auto",
) -> np.ndarray:
    """Inverse of ``encode_adaptive``; ``contexts`` must replay the
    encoder's context sequence."""
    return AdaptiveCoder(n_symbols, n_contexts, backend).decode(data, count, contexts)
