"""MP3 (MPEG-1/2 Layer III) decoding through the system ``libmpg123``.

Counterpart of ``vrvq_tpu/data/mpeg.py``: the same ctypes binding (no compile
step), float32 output at the stream's own rate, mpg123's gapless handling
(the LAME info tag), so a LAME-encoded file comes back at its original
length, and the same samples as the JAX package's reader. libmpg123 keeps
process-wide state, so loading it is guarded by a lock. Without the library,
``read_mp3`` and ``mp3_info`` raise ``UnsupportedFormatError`` and the loaders
warn once and substitute silence.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import threading
from typing import Optional, Tuple

import numpy as np

# mpg123.h enum mpg123_enc_enum
_MPG123_ENC_FLOAT_32 = 0x200
# mpg123.h error codes
_MPG123_OK = 0
_MPG123_DONE = -12
_SEEK_SET = 0

_LOCK = threading.Lock()
_LIB = None
_LIB_TRIED = False


class Mp3DecodeError(ValueError):
    """The bitstream could not be decoded by libmpg123."""


def _load():
    """Locate and initialise libmpg123 once per process (thread-safe)."""
    global _LIB, _LIB_TRIED
    with _LOCK:
        if _LIB_TRIED:
            return _LIB
        _LIB_TRIED = True
        name = ctypes.util.find_library("mpg123")
        candidates = [name] if name else []
        candidates += ["libmpg123.so.0", "libmpg123.so"]
        lib = None
        for cand in candidates:
            if not cand:
                continue
            try:
                lib = ctypes.CDLL(cand)
                break
            except OSError:
                continue
        if lib is None:
            return None
        try:
            _declare(lib)
            # Required before any handle on mpg123 < 1.27; harmless no-op
            # on newer versions.
            if hasattr(lib, "mpg123_init"):
                lib.mpg123_init()
        except Exception:
            return None
        _LIB = lib
        return _LIB


def _declare(lib):
    c = ctypes
    lib.mpg123_new.restype = c.c_void_p
    lib.mpg123_new.argtypes = [c.c_char_p, c.POINTER(c.c_int)]
    lib.mpg123_delete.restype = None
    lib.mpg123_delete.argtypes = [c.c_void_p]
    lib.mpg123_open.restype = c.c_int
    lib.mpg123_open.argtypes = [c.c_void_p, c.c_char_p]
    lib.mpg123_close.restype = c.c_int
    lib.mpg123_close.argtypes = [c.c_void_p]
    lib.mpg123_getformat.restype = c.c_int
    lib.mpg123_getformat.argtypes = [
        c.c_void_p, c.POINTER(c.c_long), c.POINTER(c.c_int),
        c.POINTER(c.c_int),
    ]
    lib.mpg123_format_none.restype = c.c_int
    lib.mpg123_format_none.argtypes = [c.c_void_p]
    lib.mpg123_format.restype = c.c_int
    lib.mpg123_format.argtypes = [c.c_void_p, c.c_long, c.c_int, c.c_int]
    lib.mpg123_rates.restype = None
    lib.mpg123_rates.argtypes = [
        c.POINTER(c.POINTER(c.c_long)), c.POINTER(c.c_size_t),
    ]
    lib.mpg123_scan.restype = c.c_int
    lib.mpg123_scan.argtypes = [c.c_void_p]
    # off_t: glibc x86-64 is LP64, off_t == long
    lib.mpg123_length.restype = c.c_long
    lib.mpg123_length.argtypes = [c.c_void_p]
    lib.mpg123_seek.restype = c.c_long
    lib.mpg123_seek.argtypes = [c.c_void_p, c.c_long, c.c_int]
    lib.mpg123_read.restype = c.c_int
    lib.mpg123_read.argtypes = [
        c.c_void_p, c.c_void_p, c.c_size_t, c.POINTER(c.c_size_t),
    ]
    lib.mpg123_strerror.restype = c.c_char_p
    lib.mpg123_strerror.argtypes = [c.c_void_p]
    lib.mpg123_param.restype = c.c_int
    lib.mpg123_param.argtypes = [c.c_void_p, c.c_int, c.c_long, c.c_double]


def available() -> bool:
    """True when libmpg123 loaded and MP3 decode will work."""
    return _load() is not None


@dataclasses.dataclass
class Mp3Info:
    sample_rate: int
    num_channels: int
    num_frames: int

    @property
    def duration(self) -> float:
        return self.num_frames / self.sample_rate


class _Handle:
    """RAII mpg123 handle opened on a file, float32 output locked in."""

    def __init__(self, lib, path):
        self.lib = lib
        err = ctypes.c_int(0)
        self.h = lib.mpg123_new(None, ctypes.byref(err))
        if not self.h:
            raise Mp3DecodeError(f"mpg123_new failed (err={err.value})")
        self.opened = False
        # MPG123_ADD_FLAGS(2) += MPG123_QUIET(0x20): keep libmpg123's
        # parse warnings for corrupt files off the process stderr (the
        # loaders report those through their own warn-once path).
        lib.mpg123_param(self.h, 2, 0x20, 0.0)
        # Restrict the output format table to float32 (any rate, mono or
        # stereo) BEFORE open: restrictions only apply at stream format
        # negotiation — changing them after getformat leaves the default
        # s16 output in place and the reads return garbage-as-f32.
        lib.mpg123_format_none(self.h)
        rates = ctypes.POINTER(ctypes.c_long)()
        n_rates = ctypes.c_size_t(0)
        lib.mpg123_rates(ctypes.byref(rates), ctypes.byref(n_rates))
        for i in range(n_rates.value):
            # 3 = MPG123_MONO|MPG123_STEREO (a channel bitmask, not count)
            if lib.mpg123_format(
                self.h, rates[i], 3, _MPG123_ENC_FLOAT_32
            ) != _MPG123_OK:
                lib.mpg123_delete(self.h)
                self.h = None
                raise Mp3DecodeError("libmpg123 refused float32 output")
        if lib.mpg123_open(self.h, str(path).encode()) != _MPG123_OK:
            msg = lib.mpg123_strerror(self.h)
            lib.mpg123_delete(self.h)
            self.h = None
            raise Mp3DecodeError(
                f"mpg123_open({path}): {msg.decode() if msg else 'error'}"
            )
        self.opened = True
        rate = ctypes.c_long(0)
        ch = ctypes.c_int(0)
        enc = ctypes.c_int(0)
        if lib.mpg123_getformat(
            self.h, ctypes.byref(rate), ctypes.byref(ch), ctypes.byref(enc)
        ) != _MPG123_OK:
            self.close()
            raise Mp3DecodeError(f"mpg123_getformat({path}) failed")
        if enc.value != _MPG123_ENC_FLOAT_32:
            self.close()
            raise Mp3DecodeError(
                f"negotiated encoding 0x{enc.value:x} != float32"
            )
        self.rate = int(rate.value)
        self.channels = int(ch.value)

    def length(self) -> int:
        # Accurate per-channel sample count needs a full header scan
        # (VBR streams without Xing headers lie otherwise).
        self.lib.mpg123_scan(self.h)
        n = int(self.lib.mpg123_length(self.h))
        return max(n, 0)

    def close(self):
        if self.h is not None:
            if self.opened:
                self.lib.mpg123_close(self.h)
            self.lib.mpg123_delete(self.h)
            self.h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _require_lib():
    lib = _load()
    if lib is None:
        from .audio_io import UnsupportedFormatError

        raise UnsupportedFormatError(
            "MP3 decode needs libmpg123 (not found on this system); "
            "convert the corpus to wav/flac or install libmpg123"
        )
    return lib


def mp3_info(path) -> Mp3Info:
    """Stream info (rate/channels/frames); scans headers, decodes nothing."""
    lib = _require_lib()
    with _Handle(lib, path) as h:
        return Mp3Info(h.rate, h.channels, h.length())


def read_mp3(
    path,
    offset: float = 0.0,
    duration: Optional[float] = None,
) -> Tuple[np.ndarray, int]:
    """Decode an MP3 -> ((C, T) float32 in [-1, 1], sample_rate).

    ``offset``/``duration`` are seconds, sample-accurate via mpg123_seek
    (which decodes-and-discards within the nearest frame).
    """
    lib = _require_lib()
    with _Handle(lib, path) as h:
        start = int(round(offset * h.rate))
        want = None
        if duration is not None:
            want = int(round(duration * h.rate))
        if start > 0:
            if lib.mpg123_seek(h.h, start, _SEEK_SET) < 0:
                raise Mp3DecodeError(f"mpg123_seek({path}, {start}) failed")
        chunks = []
        got = 0
        # 64k frames per read keeps buffers modest while amortising the
        # ctypes call overhead.
        buf_frames = 65536
        buf = (ctypes.c_float * (buf_frames * h.channels))()
        done = ctypes.c_size_t(0)
        while want is None or got < want:
            rc = lib.mpg123_read(
                h.h, buf, ctypes.sizeof(buf), ctypes.byref(done)
            )
            n = done.value // (4 * h.channels)
            if n:
                arr = np.frombuffer(
                    buf, dtype=np.float32, count=n * h.channels
                ).copy()
                chunks.append(arr)
                got += n
            if rc == _MPG123_DONE or (rc != _MPG123_OK and n == 0):
                break
        if not chunks:
            data = np.zeros((h.channels, 0), np.float32)
        else:
            flat = np.concatenate(chunks)
            data = flat.reshape(-1, h.channels).T  # interleaved -> (C, T)
        if want is not None:
            data = data[:, :want]
        return np.ascontiguousarray(data), h.rate
