"""MP4/M4A (AAC, and anything else FFmpeg demuxes) decoding through a small
C++ shim over the system libavformat/libavcodec/libswresample.

Counterpart of ``vrvq_tpu/data/ffdecode.py``. The shim is
``vrvq_tpu_torch/native/ffdecode.cc`` (a copy of the JAX package's, with its
``extern "C"`` API): it is built with ``g++`` at first use, with the flags
of the JAX package's Makefile, into ``kernels/_build/`` (git-ignored), by
``native.build``; nothing is compiled at import. Where the FFmpeg
headers are absent, or the build or the load fails, ``read_ffmpeg`` and
``ffmpeg_info`` raise ``UnsupportedFormatError`` with the reason (the
compiler's last lines), and the loaders warn once and substitute silence.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..native import SOURCE_DIR, build
from .audio_io import UnsupportedFormatError

SOURCE = SOURCE_DIR / "ffdecode.cc"
LIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswresample")
HEADER_DIRS = ("/usr/include/x86_64-linux-gnu", "/usr/include")

_LOCK = threading.Lock()
_LIB = None
_REASON: Optional[str] = None


class FfmpegDecodeError(ValueError):
    """The shim could not open or decode the bitstream."""


def _declare(lib) -> None:
    c = ctypes
    lib.vrvqff_audio_info.restype = c.c_int
    lib.vrvqff_audio_info.argtypes = [
        c.c_char_p, c.POINTER(c.c_int), c.POINTER(c.c_int), c.POINTER(c.c_long)]
    lib.vrvqff_read_audio.restype = c.c_long
    lib.vrvqff_read_audio.argtypes = [
        c.c_char_p, c.c_double, c.c_double, c.POINTER(c.c_float), c.c_long,
        c.POINTER(c.c_int), c.POINTER(c.c_int)]
    lib.vrvqff_encode_aac.restype = c.c_int
    lib.vrvqff_encode_aac.argtypes = [
        c.c_char_p, c.POINTER(c.c_float), c.c_long, c.c_int, c.c_int, c.c_int]


def _load():
    """The shim, built and loaded once per process; None (and the reason in
    ``_REASON``) where it cannot be."""
    global _LIB, _REASON
    with _LOCK:
        if _LIB is not None or _REASON is not None:
            return _LIB
        try:
            if not any((Path(d) / "libavformat" / "avformat.h").is_file()
                       for d in HEADER_DIRS):
                raise RuntimeError(
                    "libavformat/avformat.h not found in "
                    f"{' or '.join(HEADER_DIRS)} (FFmpeg dev headers)")
            lib = ctypes.CDLL(str(build("libvrvqff", [SOURCE], LIBS)))
            _declare(lib)
        except (OSError, RuntimeError) as exc:
            _REASON = str(exc)
            return None
        _LIB = lib
        return _LIB


def available() -> bool:
    """True when the shim is built and its FFmpeg runtime loads."""
    return _load() is not None


def _require_lib():
    lib = _load()
    if lib is None:
        raise UnsupportedFormatError(
            "mp4/AAC decode needs the FFmpeg shim (vrvq_tpu_torch/native/"
            "ffdecode.cc, which needs the libavformat/libavcodec/libswresample "
            f"headers and libraries), or convert the corpus to wav/flac/mp3: "
            f"{_REASON}")
    return lib


@dataclasses.dataclass
class FfmpegInfo:
    sample_rate: int
    num_channels: int
    num_frames: int  # container metadata; -1 when the container omits it

    @property
    def duration(self) -> float:
        return max(self.num_frames, 0) / self.sample_rate


def ffmpeg_info(path) -> FfmpegInfo:
    """Container-level stream info; demuxes headers, decodes nothing."""
    lib = _require_lib()
    sr, ch, frames = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_long(0)
    if lib.vrvqff_audio_info(str(path).encode(), ctypes.byref(sr),
                             ctypes.byref(ch), ctypes.byref(frames)) != 0:
        raise FfmpegDecodeError(f"cannot open audio stream: {path}")
    return FfmpegInfo(sr.value, ch.value, int(frames.value))


def read_ffmpeg(path, offset: float = 0.0,
                duration: Optional[float] = None) -> Tuple[np.ndarray, int]:
    """Decode any FFmpeg-supported file -> ((C, T) float32, sample rate).
    ``offset``/``duration`` are seconds; the shim decodes from the start and
    discards to the exact sample, so a windowed read equals the same slice of
    a full decode."""
    lib = _require_lib()
    info = ffmpeg_info(path)
    if duration is not None:
        cap_frames = int(round(duration * info.sample_rate)) + 1
    elif info.num_frames >= 0:
        # container metadata can undercount (priming, edit lists): pad
        cap_frames = info.num_frames + info.sample_rate
    else:
        cap_frames = 3600 * info.sample_rate  # unknown length: 1 h cap
    buf = np.empty(cap_frames * info.num_channels, np.float32)
    sr, ch = ctypes.c_int(0), ctypes.c_int(0)
    got = lib.vrvqff_read_audio(
        str(path).encode(), float(offset),
        -1.0 if duration is None else float(duration),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), buf.size,
        ctypes.byref(sr), ctypes.byref(ch))
    if got < 0:
        raise FfmpegDecodeError(f"decode failed (rc={got}): {path}")
    data = buf[: got * ch.value].reshape(-1, ch.value).T
    return np.ascontiguousarray(data), sr.value


def encode_aac(path, audio: np.ndarray, sample_rate: int,
               bitrate: int = 192000) -> None:
    """Test-fixture encoder: (C, T) float32 -> AAC in .mp4/.m4a."""
    lib = _require_lib()
    audio = np.asarray(audio, np.float32)
    if audio.ndim == 1:
        audio = audio[None]
    inter = np.ascontiguousarray(audio.T).reshape(-1)
    rc = lib.vrvqff_encode_aac(
        str(path).encode(), inter.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        audio.shape[1], audio.shape[0], sample_rate, bitrate)
    if rc != 0:
        raise FfmpegDecodeError(f"AAC encode failed (rc={rc}): {path}")
