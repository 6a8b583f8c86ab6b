"""Pure-Python FLAC decoder, numpy only.

Counterpart of ``vrvq_tpu/data/flac_py.py``, line for line, so both packages
decode a stream to the same samples. The format is implemented from the spec
(https://xiph.org/flac/format.html): STREAMINFO parsing, frame headers with
UTF-8 coded numbers and their CRC-8, constant / verbatim / fixed / LPC
subframes, Rice/Rice2 partitioned residuals, wasted bits, and the four
channel assignments (independent, left/side, right/side, mid/side).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class FlacInfo:
    sample_rate: int
    num_channels: int
    num_frames: int  # total samples per channel (0 = unknown)
    bit_depth: int
    block_size: int  # max block size from STREAMINFO

    @property
    def duration(self) -> float:
        return self.num_frames / self.sample_rate


class _Bits:
    """MSB-first bit reader over a byte buffer.

    Fixed-width reads assemble bytes directly; unary runs use a
    precomputed sorted index of set bits (searchsorted), so Rice decoding
    is O(log n) per quotient instead of a per-bit scan.
    """

    def __init__(self, data: bytes):
        self._bytes = np.frombuffer(data, dtype=np.uint8)
        self._bits = np.unpackbits(self._bytes)
        self._ones = np.flatnonzero(self._bits)
        self.pos = 0

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos
        self.pos = p + n
        bits = self._bits[p : p + n]
        if bits.size < n:
            raise EOFError("flac: truncated stream")
        out = 0
        for b in bits:
            out = (out << 1) | int(b)
        return out

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        if v >= 1 << (n - 1):
            v -= 1 << n
        return v

    def unary(self) -> int:
        """Count zero bits until the next 1 (consuming it)."""
        i = np.searchsorted(self._ones, self.pos)
        if i >= self._ones.size:
            raise EOFError("flac: truncated unary code")
        one = int(self._ones[i])
        q = one - self.pos
        self.pos = one + 1
        return q

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def byte_pos(self) -> int:
        return self.pos >> 3

    def eof(self) -> bool:
        return self.pos >= self._bits.size


_CRC8_TABLE = None


def _crc8(data: bytes) -> int:
    global _CRC8_TABLE
    if _CRC8_TABLE is None:
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = ((c << 1) ^ 0x07) & 0xFF if c & 0x80 else (c << 1) & 0xFF
            table.append(c)
        _CRC8_TABLE = table
    crc = 0
    for b in data:
        crc = _CRC8_TABLE[crc ^ b]
    return crc


def _parse_streaminfo(data: bytes) -> FlacInfo:
    br = _Bits(data)
    br.read(16)  # min block size
    max_block = br.read(16)
    br.read(24)  # min frame size
    br.read(24)  # max frame size
    sr = br.read(20)
    ch = br.read(3) + 1
    bps = br.read(5) + 1
    total = br.read(36)
    return FlacInfo(sr, ch, total, bps, max_block)


def _read_header(path) -> Tuple[FlacInfo, int]:
    """Parse metadata blocks; return (info, offset of first frame)."""
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != b"fLaC":
            raise ValueError("not a FLAC file")
        info = None
        while True:
            hdr = f.read(4)
            if len(hdr) < 4:
                raise ValueError("flac: truncated metadata")
            last = bool(hdr[0] & 0x80)
            btype = hdr[0] & 0x7F
            size = int.from_bytes(hdr[1:4], "big")
            payload = f.read(size)
            if btype == 0:
                info = _parse_streaminfo(payload)
            if last:
                break
        if info is None:
            raise ValueError("flac: missing STREAMINFO")
        return info, f.tell()


def flac_info(path) -> FlacInfo:
    info, _ = _read_header(path)
    return info


_BLOCK_SIZES = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
                8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
                13: 8192, 14: 16384, 15: 32768}
_SAMPLE_RATES = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000,
                 6: 22050, 7: 24000, 8: 32000, 9: 44100, 10: 48000,
                 11: 96000}
_FIXED_COEFS = {
    0: (),
    1: (1,),
    2: (2, -1),
    3: (3, -3, 1),
    4: (4, -6, 4, -1),
}


def _read_utf8_number(br: _Bits) -> int:
    """FLAC's extended UTF-8 coded frame/sample number (up to 36 bits)."""
    b0 = br.read(8)
    if b0 < 0x80:
        return b0
    n = 0
    mask = 0x40
    while b0 & mask:
        n += 1
        mask >>= 1
    val = b0 & (mask - 1)
    for _ in range(n):
        c = br.read(8)
        val = (val << 6) | (c & 0x3F)
    return val


def _decode_residual(br: _Bits, block_size: int, order: int) -> np.ndarray:
    method = br.read(2)
    if method > 1:
        raise ValueError("flac: reserved residual method")
    plen = 4 if method == 0 else 5
    escape = (1 << plen) - 1
    po = br.read(4)
    nparts = 1 << po
    if block_size % nparts:
        raise ValueError("flac: bad partition order")
    out = np.empty(block_size - order, dtype=np.int64)
    idx = 0
    for p in range(nparts):
        n = (block_size >> po) - (order if p == 0 else 0)
        param = br.read(plen)
        if param == escape:
            raw = br.read(5)
            for i in range(n):
                out[idx] = br.read_signed(raw) if raw else 0
                idx += 1
        else:
            for i in range(n):
                q = br.unary()
                r = br.read(param) if param else 0
                v = (q << param) | r
                out[idx] = (v >> 1) ^ -(v & 1)
                idx += 1
    return out


def _decode_subframe(br: _Bits, block_size: int, bps: int) -> np.ndarray:
    if br.read(1):
        raise ValueError("flac: bad subframe padding bit")
    stype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = br.unary() + 1
        bps -= wasted

    if stype == 0:  # constant
        v = br.read_signed(bps)
        out = np.full(block_size, v, dtype=np.int64)
    elif stype == 1:  # verbatim
        out = np.empty(block_size, dtype=np.int64)
        for i in range(block_size):
            out[i] = br.read_signed(bps)
    elif 8 <= stype <= 12:  # fixed, order = stype - 8
        order = stype - 8
        out = np.empty(block_size, dtype=np.int64)
        for i in range(order):
            out[i] = br.read_signed(bps)
        res = _decode_residual(br, block_size, order)
        coefs = _FIXED_COEFS[order]
        for i in range(order, block_size):
            pred = 0
            for j, c in enumerate(coefs):
                pred += c * out[i - 1 - j]
            out[i] = res[i - order] + pred
    elif stype >= 32:  # LPC, order = (stype & 31) + 1
        order = (stype & 31) + 1
        out = np.empty(block_size, dtype=np.int64)
        for i in range(order):
            out[i] = br.read_signed(bps)
        prec = br.read(4)
        if prec == 15:
            raise ValueError("flac: invalid LPC precision")
        prec += 1
        shift = br.read_signed(5)
        coefs = [br.read_signed(prec) for _ in range(order)]
        res = _decode_residual(br, block_size, order)
        for i in range(order, block_size):
            pred = 0
            for j in range(order):
                pred += coefs[j] * out[i - 1 - j]
            out[i] = res[i - order] + (pred >> shift)
    else:
        raise ValueError(f"flac: reserved subframe type {stype}")

    if wasted:
        out <<= wasted
    return out


def _decode_frame(br: _Bits, info: FlacInfo) -> np.ndarray:
    """Decode one frame -> (channels, block_size) int64 PCM."""
    start_byte = br.byte_pos()
    sync = br.read(14)
    if sync != 0b11111111111110:
        raise ValueError("flac: lost frame sync")
    br.read(1)  # reserved
    br.read(1)  # blocking strategy
    bs_code = br.read(4)
    sr_code = br.read(4)
    ch_code = br.read(4)
    ss_code = br.read(3)
    br.read(1)  # reserved
    _read_utf8_number(br)

    if bs_code == 0:
        raise ValueError("flac: reserved block size code")
    elif bs_code == 6:
        block_size = br.read(8) + 1
    elif bs_code == 7:
        block_size = br.read(16) + 1
    else:
        block_size = _BLOCK_SIZES[bs_code]

    if sr_code == 12:
        br.read(8)
    elif sr_code in (13, 14):
        br.read(16)
    elif sr_code == 15:
        raise ValueError("flac: invalid sample rate code")

    if ss_code == 0:
        bps = info.bit_depth
    else:
        bps = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}[ss_code]

    # CRC-8 covers the header bytes up to (not incl.) the CRC byte
    crc_end = br.byte_pos()
    stored_crc = br.read(8)
    header_bytes = br._bytes[start_byte:crc_end].tobytes()
    if _crc8(header_bytes) != stored_crc:
        raise ValueError("flac: frame header CRC mismatch")

    if ch_code < 8:
        nch = ch_code + 1
        chans = [
            _decode_subframe(br, block_size, bps) for _ in range(nch)
        ]
    elif ch_code == 8:  # left/side
        left = _decode_subframe(br, block_size, bps)
        side = _decode_subframe(br, block_size, bps + 1)
        chans = [left, left - side]
    elif ch_code == 9:  # right/side
        side = _decode_subframe(br, block_size, bps + 1)
        right = _decode_subframe(br, block_size, bps)
        chans = [side + right, right]
    elif ch_code == 10:  # mid/side
        mid = _decode_subframe(br, block_size, bps)
        side = _decode_subframe(br, block_size, bps + 1)
        mid = (mid << 1) | (side & 1)
        chans = [(mid + side) >> 1, (mid - side) >> 1]
    else:
        raise ValueError("flac: reserved channel assignment")

    br.align()
    br.read(16)  # frame CRC-16 (not verified)
    return np.stack(chans)


def read_flac(
    path,
    offset: float = 0.0,
    duration: Optional[float] = None,
) -> Tuple[np.ndarray, int]:
    """Decode a FLAC file -> ((C, T) float32 in [-1, 1], sample_rate).

    Frames before ``offset`` are decoded (FLAC has no general seek without
    a seektable) but not kept; decoding stops early once ``duration`` is
    satisfied.
    """
    info, data_start = _read_header(path)
    with open(path, "rb") as f:
        f.seek(data_start)
        payload = f.read()
    br = _Bits(payload)

    start = int(round(offset * info.sample_rate))
    want = None if duration is None else int(round(duration * info.sample_rate))

    pieces = []
    got = 0
    seen = 0
    while not br.eof():
        if br._bits.size - br.pos < 32:
            break
        frame = _decode_frame(br, info)
        n = frame.shape[1]
        lo = max(start - seen, 0)
        seen += n
        if lo >= n:
            continue
        piece = frame[:, lo:]
        if want is not None:
            take = want - got
            if take <= 0:
                break
            piece = piece[:, :take]
        pieces.append(piece)
        got += piece.shape[1]
        if want is not None and got >= want:
            break

    if pieces:
        pcm = np.concatenate(pieces, axis=1)
    else:
        pcm = np.zeros((info.num_channels, 0), dtype=np.int64)
    scale = float(1 << (info.bit_depth - 1))
    return (pcm.astype(np.float32) / scale), info.sample_rate
