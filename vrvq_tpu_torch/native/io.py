"""ctypes bindings of ``libvrvqio``: the native wav and flac readers, the
BS.1770 loudness meter and the adaptive range coder.

Counterpart of ``vrvq_tpu/native/io/wavio.py``. The library is the port's
own copy of the JAX package's three sources (``wavio.cc``, ``flacio.cc``,
``rangecoder.cc`` beside this file, with the same ``extern "C"`` API), built
with ``g++ -O3 -fPIC -std=c++17 -shared`` at first use (``native.build``).
Where it cannot be built or loaded (no compiler, a failed build), ``library``
returns None and warns once with the reason; the callers then take their
plain versions (the numpy wav parser, ``data/flac_py.py``, the numpy meter of
``ops/loudness.py``, the Python range coder), which are also what the tests
hold the native path to.

``IO_CALLS`` counts the native calls by name (``wav_native``,
``flac_native``, ``loudness_native``, ``rc_encode_native``,
``rc_decode_native``), so a run can show that it went through the library.
The calls release the interpreter lock (ctypes does), so loader threads
decode in parallel.
"""

from __future__ import annotations

import collections
import ctypes
import threading
import warnings
from typing import Optional, Tuple

import numpy as np

from . import SOURCE_DIR, build

SOURCES = tuple(SOURCE_DIR / f"{name}.cc" for name in ("wavio", "flacio", "rangecoder"))

IO_CALLS: collections.Counter = collections.Counter()

_LOCK = threading.Lock()
_LIB = None
_REASON: Optional[str] = None

_c = ctypes
_F32P, _I32P, _U8P = _c.POINTER(_c.c_float), _c.POINTER(_c.c_int32), _c.POINTER(_c.c_uint8)
_READ = ([_c.c_char_p, _c.c_double, _c.c_double, _F32P, _c.c_long,
          _c.POINTER(_c.c_int), _c.POINTER(_c.c_int), _c.POINTER(_c.c_long)], _c.c_int)
_INFO = ([_c.c_char_p, _c.POINTER(_c.c_int), _c.POINTER(_c.c_int),
          _c.POINTER(_c.c_long)], _c.c_int)
_SIGNATURES = {
    "vrvqio_read_wav": _READ,
    "vrvqio_wav_info": _INFO,
    "vrvqio_read_flac": _READ,
    "vrvqio_flac_info": _INFO,
    "vrvqio_loudness": ([_F32P, _c.c_long, _c.c_int, _c.c_int, _c.c_double],
                        _c.c_double),
    "vrvq_rc_model_new": ([_c.c_int, _c.c_int], _c.c_void_p),
    "vrvq_rc_model_free": ([_c.c_void_p], None),
    "vrvq_rc_encode": ([_c.c_void_p, _I32P, _I32P, _c.c_long, _U8P, _c.c_long],
                       _c.c_long),
    "vrvq_rc_decode": ([_c.c_void_p, _U8P, _c.c_long, _I32P, _c.c_long,
                        _c.POINTER(_c.c_uint32)], _c.c_long),
}


def library():
    """The loaded library, built on first call; None (after one warning
    naming the reason) where it cannot be built or loaded."""
    global _LIB, _REASON
    with _LOCK:
        if _LIB is not None or _REASON is not None:
            return _LIB
        try:
            lib = ctypes.CDLL(str(build("libvrvqio", SOURCES)))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
        except (OSError, RuntimeError, AttributeError) as exc:
            _REASON = str(exc)
            warnings.warn(
                f"the native I/O library (vrvq_tpu_torch/native/*.cc) is "
                f"unavailable, so wav and flac are read by the numpy and Python "
                f"decoders, loudness by the numpy meter and range coding in "
                f"Python: {_REASON}", RuntimeWarning, stacklevel=3)
            return None
        _LIB = lib
        return _LIB


def reason() -> Optional[str]:
    """Why the library is unavailable (None while it loads or is untried)."""
    return _REASON


def count(name: str) -> None:
    with _LOCK:
        IO_CALLS[name] += 1


def _info(fn, path) -> Optional[Tuple[int, int, int]]:
    sr, ch, frames = ctypes.c_int(), ctypes.c_int(), ctypes.c_long()
    if fn(str(path).encode(), ctypes.byref(sr), ctypes.byref(ch),
          ctypes.byref(frames)) != 0:
        return None
    return sr.value, ch.value, frames.value


def _read(lib, kind: str, path, offset: float,
          duration: Optional[float]) -> Optional[Tuple[np.ndarray, int]]:
    """((C, T) float32, sample rate) of a wav or flac excerpt, or None where
    the library rejects the file (the caller's plain reader then decides)."""
    info = _info(getattr(lib, f"vrvqio_{kind}_info"), path)
    if info is None:
        return None
    sr, ch, frames = info
    want = frames if duration is None else int(round(duration * sr))
    cap = max(want * ch, 1)
    buf = np.empty(cap, dtype=np.float32)
    out_sr, out_ch, got = ctypes.c_int(), ctypes.c_int(), ctypes.c_long()
    rc = getattr(lib, f"vrvqio_read_{kind}")(
        str(path).encode(), float(offset),
        -1.0 if duration is None else float(duration),
        buf.ctypes.data_as(_F32P), cap,
        ctypes.byref(out_sr), ctypes.byref(out_ch), ctypes.byref(got))
    if rc != 0:
        return None
    count(f"{kind}_native")
    n, c = got.value, out_ch.value
    return buf[: n * c].reshape(n, c).T.copy(), out_sr.value


def read_wav(path, offset: float = 0.0, duration: Optional[float] = None):
    lib = library()
    return None if lib is None else _read(lib, "wav", path, offset, duration)


def read_flac(path, offset: float = 0.0, duration: Optional[float] = None):
    lib = library()
    return None if lib is None else _read(lib, "flac", path, offset, duration)


def loudness(audio, sample_rate: int, block_size: float = 0.4) -> Optional[float]:
    """BS.1770 integrated loudness (LUFS, -inf where every block is gated
    out) of one ``(C, T)`` item; None without the library."""
    lib = library()
    if lib is None:
        return None
    a = np.ascontiguousarray(np.asarray(audio, np.float32).T)  # (T, C)
    val = lib.vrvqio_loudness(a.ctypes.data_as(_F32P), a.shape[0], a.shape[1],
                              int(sample_rate), float(block_size))
    count("loudness_native")
    return float("-inf") if val <= -1e8 else float(val)
