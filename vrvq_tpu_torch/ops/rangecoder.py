"""Adaptive range coder for the entropy-coded ``.dac`` and the stream's
packets (host-side, lossless).

The port's own copy of the pure-Python coder of ``vrvq_tpu/ops/rangecoder.py``,
so that the same symbols give the same bytes in both packages: the
carry-counting byte-wise range coder (Subbotin / LZMA ``ShiftLow``): 32-bit
range, 2^24 renormalization, 5-byte flush. One adaptive model per context:
a Fenwick tree of symbol counts, +32 per hit, halved when the total reaches
2^16. Encoder and decoder update alike, so no table is stored. The JAX
package's C++ backend (byte-identical, faster) is not ported.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

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
    coded and decoded in order (``infer/streaming.PacketCodec``)."""

    def __init__(self, n_symbols: int, n_contexts: int = 1):
        self.n_symbols = n_symbols
        self.n_contexts = n_contexts
        self.models = [_Fenwick(n_symbols) for _ in range(n_contexts)]

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
) -> bytes:
    """Range-code ``symbols`` (flat ints in [0, n_symbols)) with one adaptive
    model per context (flat ints in [0, n_contexts); None: one shared
    model). One-shot: fresh models per call."""
    return AdaptiveCoder(n_symbols, n_contexts).encode(symbols, contexts)


def decode_adaptive(
    data: bytes,
    count: int,
    n_symbols: int,
    contexts: Optional[np.ndarray] = None,
    n_contexts: int = 1,
) -> np.ndarray:
    """Inverse of ``encode_adaptive``; ``contexts`` must replay the
    encoder's context sequence."""
    return AdaptiveCoder(n_symbols, n_contexts).decode(data, count, contexts)
