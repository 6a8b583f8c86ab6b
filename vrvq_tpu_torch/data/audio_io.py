"""Audio files: wav, flac, mp3 and mp4/m4a read, wav written, sources scanned.

Counterpart of ``vrvq_tpu/data/audio_io.py``, numpy only, with the same five
``AUDIO_EXTENSIONS`` in the same order, so both packages list the same files
of a folder and decode them to the same samples. Wav and flac are read by the
native library (``native/io.py``, built with ``g++`` at first use) as the
JAX package reads them; the numpy wav parser here and the Python decoder of
``data/flac_py.py`` are their plain versions, taken where the library is
unavailable (it then warns once with the reason) or rejects a file.
Header-only info (``wav_info``, ``audio_info``) is parsed in Python, as in
the JAX package. mp3 goes through the system ``libmpg123``
(``data/mpeg.py``) and mp4/m4a through a small C++ shim over the system
FFmpeg libraries, built at first use (``data/ffdecode.py``). A file with no
decoder (an unknown suffix, or a library this machine lacks) raises
``UnsupportedFormatError``; the loaders turn that into one warning and
silence.
"""

from __future__ import annotations

import csv
import dataclasses
import os
import struct
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..native import io as native_io

AUDIO_EXTENSIONS = [".wav", ".flac", ".mp3", ".mp4", ".m4a"]


class UnsupportedFormatError(ValueError):
    """The file's suffix or bitstream has no decoder on this machine."""


@dataclasses.dataclass
class WavInfo:
    sample_rate: int
    num_channels: int
    num_frames: int
    bit_depth: int
    audio_format: int

    @property
    def duration(self) -> float:
        return self.num_frames / self.sample_rate


def _parse_wav_header(f) -> Tuple[WavInfo, int, int]:
    """RIFF/WAVE chunks -> (info, data offset, data size)."""
    riff = f.read(12)
    if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    fmt = data_offset = data_size = None
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            break
        cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
        if cid == b"fmt ":
            fmt = f.read(size)
            if size % 2:
                f.read(1)
        elif cid == b"data":
            data_offset, data_size = f.tell(), size
            f.seek(size + (size % 2), os.SEEK_CUR)
        else:
            f.seek(size + (size % 2), os.SEEK_CUR)
        if fmt is not None and data_offset is not None:
            break
    if fmt is None or data_offset is None:
        raise ValueError("missing fmt/data chunk")
    audio_format, channels, sample_rate = struct.unpack("<HHI", fmt[:8])
    bits = struct.unpack("<H", fmt[14:16])[0]
    if audio_format == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = struct.unpack("<H", fmt[24:26])[0]
    frame_bytes = channels * (bits // 8)
    frames = data_size // frame_bytes if frame_bytes else 0
    return (WavInfo(sample_rate, channels, frames, bits, audio_format),
            data_offset, data_size)


def wav_info(path) -> WavInfo:
    with open(path, "rb") as f:
        return _parse_wav_header(f)[0]


def read_wav(path, offset: float = 0.0,
             duration: Optional[float] = None) -> Tuple[np.ndarray, int]:
    """A wav file's excerpt -> ((C, T) float32 in [-1, 1], sample rate). PCM
    8/16/24/32-bit or float; seeks to ``offset`` seconds and reads
    ``duration`` seconds (to the end for None). Natively where the library
    is built, else by ``read_wav_np``."""
    out = native_io.read_wav(path, offset, duration)
    return read_wav_np(path, offset, duration) if out is None else out


def read_wav_np(path, offset: float = 0.0,
                duration: Optional[float] = None) -> Tuple[np.ndarray, int]:
    """``read_wav``'s plain version: the header and samples parsed in numpy."""
    with open(path, "rb") as f:
        info, data_offset, _ = _parse_wav_header(f)
        frame_bytes = (info.bit_depth // 8) * info.num_channels
        start = int(round(offset * info.sample_rate))
        n = (info.num_frames - start if duration is None
             else int(round(duration * info.sample_rate)))
        n = max(0, min(n, info.num_frames - start))
        f.seek(data_offset + start * frame_bytes)
        raw = f.read(n * frame_bytes)
    n_read = len(raw) // frame_bytes
    count = n_read * info.num_channels
    if info.audio_format == 1:
        if info.bit_depth == 16:
            data = np.frombuffer(raw, "<i2", count).astype(np.float32) / 32768.0
        elif info.bit_depth == 32:
            data = np.frombuffer(raw, "<i4", count).astype(np.float32) / 2147483648.0
        elif info.bit_depth == 24:
            b = np.frombuffer(raw, np.uint8, count * 3).reshape(-1, 3).astype(np.int32)
            vals = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            data = vals.astype(np.float32) / 8388608.0
        elif info.bit_depth == 8:
            data = (np.frombuffer(raw, np.uint8, count).astype(np.float32)
                    - 128.0) / 128.0
        else:
            raise ValueError(f"unsupported PCM bit depth {info.bit_depth}")
    elif info.audio_format == 3:
        dtype = "<f4" if info.bit_depth == 32 else "<f8"
        data = np.frombuffer(raw, dtype, count).astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV format {info.audio_format}")
    return data.reshape(n_read, info.num_channels).T.copy(), info.sample_rate


def write_wav(path, data: np.ndarray, sample_rate: int,
              bit_depth: int = 16) -> None:
    """Write (C, T) or (T,) float audio, clipped to [-1, 1], as PCM wav of
    16 or 32 bits."""
    data = np.asarray(data, dtype=np.float32)
    if data.ndim == 1:
        data = data[None]
    frames = np.clip(data, -1.0, 1.0).T  # (T, C)
    if bit_depth == 16:
        pcm = np.round(frames * 32767.0).astype("<i2")
    elif bit_depth == 32:
        pcm = np.round(frames * 2147483647.0).astype("<i4")
    else:
        raise ValueError("bit_depth must be 16 or 32")
    channels = pcm.shape[1]
    block_align = channels * (bit_depth // 8)
    payload = pcm.tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, channels, sample_rate,
                                      sample_rate * block_align, block_align,
                                      bit_depth))
        f.write(b"data" + struct.pack("<I", len(payload)))
        f.write(payload)


def read_flac(path, offset: float = 0.0,
              duration: Optional[float] = None) -> Tuple[np.ndarray, int]:
    """A flac file's excerpt -> ((C, T) float32 in [-1, 1], sample rate):
    natively where the library is built, else by ``data/flac_py.py``."""
    out = native_io.read_flac(path, offset, duration)
    if out is not None:
        return out
    from .flac_py import read_flac as _read_flac_py

    return _read_flac_py(path, offset=offset, duration=duration)


def _unsupported(path) -> UnsupportedFormatError:
    suffix = Path(path).suffix.lower()
    return UnsupportedFormatError(
        f"no decoder for '{suffix}' files (supported: {AUDIO_EXTENSIONS}): {path}")


def audio_info(path):
    """Header-only info (``sample_rate``, ``num_channels``, ``num_frames``,
    ``duration``) of any supported format."""
    suffix = Path(path).suffix.lower()
    if suffix == ".wav":
        return wav_info(path)
    if suffix == ".flac":
        from .flac_py import flac_info

        return flac_info(path)
    if suffix == ".mp3":
        from .mpeg import mp3_info

        return mp3_info(path)
    if suffix in (".mp4", ".m4a"):
        from .ffdecode import ffmpeg_info

        return ffmpeg_info(path)
    raise _unsupported(path)


def read_audio(path, offset: float = 0.0,
               duration: Optional[float] = None) -> Tuple[np.ndarray, int]:
    """Decode any supported format -> ((C, T) float32, sample rate); a file
    with no decoder raises ``UnsupportedFormatError``."""
    suffix = Path(path).suffix.lower()
    if suffix == ".wav":
        return read_wav(path, offset=offset, duration=duration)
    if suffix == ".flac":
        return read_flac(path, offset=offset, duration=duration)
    if suffix == ".mp3":
        from .mpeg import read_mp3

        return read_mp3(path, offset=offset, duration=duration)
    if suffix in (".mp4", ".m4a"):
        from .ffdecode import read_ffmpeg

        return read_ffmpeg(path, offset=offset, duration=duration)
    raise _unsupported(path)


def find_audio(folder, ext: Optional[List[str]] = None) -> List[Path]:
    """Audio files under ``folder`` (recursive), sorted."""
    ext = ext or AUDIO_EXTENSIONS
    folder = Path(folder)
    if folder.is_file() and folder.suffix.lower() in ext:
        return [folder]
    files = []
    for e in ext:
        files.extend(folder.rglob(f"*{e}"))
    return sorted(set(files))


def read_sources(sources: List[str], remove_empty: bool = True,
                 relative_path: str = "",
                 ext: Optional[List[str]] = None) -> List[List[Dict]]:
    """One sorted list of ``{"path": ...}`` per source: a folder (scanned
    recursively) or a csv with a ``path`` column."""
    files = []
    relative_path = Path(relative_path)
    for source in map(str, sources):
        found = []
        if source.endswith(".csv"):
            with open(source) as f:
                for row in csv.DictReader(f):
                    if remove_empty and row.get("path", "") == "":
                        continue
                    if row.get("path"):
                        row["path"] = str(relative_path / row["path"])
                    found.append(row)
        else:
            found = [{"path": str(relative_path / p)}
                     for p in find_audio(source, ext=ext)]
        files.append(sorted(found, key=lambda x: x["path"]))
    return files


def choose_from_list_of_lists(state, list_of_lists, p=None):
    source_idx = state.choice(len(list_of_lists), p=p)
    item_idx = state.randint(len(list_of_lists[source_idx]))
    return list_of_lists[source_idx][item_idx], source_idx, item_idx
