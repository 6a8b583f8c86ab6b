"""The port's audio readers, writer and source scan against the JAX
package's, and the loader's repair (every format of ``AUDIO_EXTENSIONS``).

Streams are short (0.1-0.3 s at 44.1 kHz) and seeded with numpy: flac from
``tests/flac_encoder.py`` (every subframe kind, each stereo mode, wasted
bits, and 8/24-bit verbatim streams written here), wav at 8/16/24/32-bit
PCM and 32-bit float, mp3 from ``tests/mp3_encoder.py`` (skipped where
libmp3lame or libmpg123 is absent, as ``tests/test_mp3.py`` skips) and
m4a/mp4 from the port's ``encode_aac`` (skipped where either package's
FFmpeg shim is unavailable). ``read_audio``, ``audio_info`` and
``offset``/``duration`` excerpts are held equal to the JAX package's bit for
bit, and ``write_wav``'s bytes to its bytes.

The loader: before this change the port scanned ``.wav`` only, so on a
mixed folder its index -> file mapping departed from JAX's and an all-flac
folder gave an empty dataset. Now ``read_sources`` lists what JAX's lists,
``AudioLoader`` gives the same excerpts, an mp4 with no decoder gives
silence and one warning, and the inference CLI reads a flac folder.
"""

import json
import struct
import warnings

import numpy as np
import pytest
import torch

from tests.flac_encoder import BitWriter, crc8, crc16, encode_flac
from tests.mp3_encoder import encode_mp3, lame_available
from vrvq_tpu.data import audio_io as jio
from vrvq_tpu.data import ffdecode as jff
from vrvq_tpu.data import loaders as jloaders
from vrvq_tpu.data import mpeg as jmpeg
from vrvq_tpu_torch.audio import Signal
from vrvq_tpu_torch.cli import inference as cli_inference
from vrvq_tpu_torch.data import audio_io as tio
from vrvq_tpu_torch.data import ffdecode as tff
from vrvq_tpu_torch.data import loaders as tloaders
from vrvq_tpu_torch.data import mpeg as tmpeg

torch.set_num_threads(1)
SR = 44100
EXCERPTS = [(0.0, None), (0.05, 0.1), (0.123, None), (0.2, 0.5)]


def _pcm(channels: int, seconds: float, bits: int = 16, seed: int = 0):
    rng = np.random.RandomState(seed)
    x = np.cumsum(rng.randn(channels, int(seconds * SR)), axis=1)
    x *= 0.1 * 2 ** (bits - 1) / max(np.abs(x).max(), 1e-9)
    return x.astype(np.int64)


def _same_info(a, b):
    for k in ("sample_rate", "num_channels", "num_frames", "duration"):
        assert getattr(a, k) == getattr(b, k), (k, a, b)


def _same_reads(path):
    """Every excerpt and the header info equal in both packages; returns the
    port's whole decode."""
    _same_info(tio.audio_info(path), jio.audio_info(path))
    full = tio.read_audio(path)[0]
    for offset, duration in EXCERPTS:
        got, sr = tio.read_audio(path, offset=offset, duration=duration)
        want, jsr = jio.read_audio(path, offset=offset, duration=duration)
        assert sr == jsr and got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    return full


FLAC_CASES = {
    "verbatim": dict(subframe_kind="verbatim"),
    **{f"fixed{o}": dict(subframe_kind="fixed", order=o, partition_order=po)
       for o, po in ((0, 0), (1, 1), (2, 2), (3, 0), (4, 3))},
    "lpc1": dict(subframe_kind="lpc", order=1),
    "lpc2": dict(subframe_kind="lpc", order=2, partition_order=1),
    "left_side": dict(stereo_mode="left_side"),
    "right_side": dict(stereo_mode="right_side"),
    "mid_side": dict(stereo_mode="mid_side", partition_order=2),
    "wasted": dict(wasted=3),
}


@pytest.mark.parametrize("case", sorted(FLAC_CASES))
def test_flac_reads_match_jax(tmp_path, case):
    kw = dict(FLAC_CASES[case])
    channels = 2 if "side" in case or case == "wasted" else 1
    pcm = _pcm(channels, 0.25, seed=len(case))[:, : 21 * 512]  # whole blocks
    if kw.get("wasted"):
        pcm = (pcm >> kw["wasted"]) << kw["wasted"]
    path = tmp_path / f"{case}.flac"
    path.write_bytes(encode_flac(pcm, SR, block_size=512, **kw))
    full = _same_reads(path)
    # and the decode is the written PCM, bit for bit
    np.testing.assert_array_equal(np.round(full * 32768.0).astype(np.int64), pcm)


def _verbatim_flac(pcm: np.ndarray, bits: int) -> bytes:
    """A one-frame-per-512-samples verbatim flac stream at ``bits`` (8 or 24)
    bits per sample, the sample size coded in each frame header."""
    nch, total = pcm.shape
    si = BitWriter()
    for value, n in ((512, 16), (512, 16), (0, 24), (0, 24), (SR, 20),
                     (nch - 1, 3), (bits - 1, 5), (total, 36)):
        si.write(value, n)
    streaminfo = si.tobytes() + b"\x00" * 16
    out = bytearray(b"fLaC" + bytes([0x80]) + len(streaminfo).to_bytes(3, "big")
                    + streaminfo)
    for frame, start in enumerate(range(0, total, 512)):
        chunk = pcm[:, start:start + 512]
        hdr = BitWriter()
        for value, n in ((0b11111111111110, 14), (0, 1), (0, 1), (7, 4), (0, 4),
                         (nch - 1, 4), ({8: 1, 24: 6}[bits], 3), (0, 1),
                         (frame, 8), (chunk.shape[1] - 1, 16)):
            hdr.write(value, n)
        header = hdr.tobytes()
        body = BitWriter()
        for b in header + bytes([crc8(header)]):
            body.write(b, 8)
        for c in range(nch):
            body.write(0, 1)
            body.write(1, 6)  # verbatim
            body.write(0, 1)
            for v in chunk[c]:
                body.write_signed(int(v), bits)
        body.align()
        data = body.tobytes()
        out += data + crc16(data).to_bytes(2, "big")
    return bytes(out)


@pytest.mark.parametrize("bits", [8, 24])
def test_flac_bit_depths_match_jax(tmp_path, bits):
    pcm = _pcm(2, 0.2, bits=bits, seed=bits)
    path = tmp_path / f"d{bits}.flac"
    path.write_bytes(_verbatim_flac(pcm, bits))
    assert tio.audio_info(path).bit_depth == bits
    full = _same_reads(path)
    np.testing.assert_array_equal(
        np.round(full * 2.0 ** (bits - 1)).astype(np.int64), pcm)


def _raw_wav(path, data: np.ndarray, bits: int, fmt: int = 1):
    """(C, T) samples (integers, or floats for ``fmt`` 3) as a wav."""
    c = data.shape[0]
    frames = data.T
    if fmt == 3:
        payload = frames.astype("<f4").tobytes()
    elif bits == 8:
        payload = (frames + 128).astype(np.uint8).tobytes()
    elif bits == 24:
        v = (frames.astype(np.int64) & 0xFFFFFF).reshape(-1)
        payload = np.stack([v & 0xFF, (v >> 8) & 0xFF, v >> 16], 1).astype(
            np.uint8).tobytes()
    else:
        payload = frames.astype(f"<i{bits // 8}").tobytes()
    block = c * bits // 8
    path.write_bytes(b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
                     + b"fmt " + struct.pack("<IHHIIHH", 16, fmt, c, SR,
                                             SR * block, block, bits)
                     + b"data" + struct.pack("<I", len(payload)) + payload)


@pytest.mark.parametrize("bits,fmt,channels", [
    (8, 1, 1), (16, 1, 2), (24, 1, 2), (32, 1, 1), (32, 3, 2)])
def test_wav_reads_match_jax(tmp_path, bits, fmt, channels):
    if fmt == 3:
        data = np.random.RandomState(1).uniform(-0.9, 0.9, (channels, int(0.2 * SR)))
    else:
        data = _pcm(channels, 0.2, bits=bits, seed=bits)
    path = tmp_path / f"w{bits}_{fmt}.wav"
    _raw_wav(path, data, bits, fmt)
    _same_reads(path)


def _require_mp3():
    if not (jmpeg.available() and tmpeg.available() and lame_available()):
        pytest.skip("libmpg123/libmp3lame not on this system")


def _require_aac():
    # decided in the test, not at import: the port's shim is compiled on
    # first use, and every worker of the suite imports this file
    if not (jff.available() and tff.available()):
        pytest.skip("an FFmpeg shim is unavailable (libav* headers or libraries)")


def _tone(channels: int, seconds: float) -> np.ndarray:
    t = np.arange(int(seconds * SR)) / SR
    return np.stack([0.4 * np.sin(2 * np.pi * f * t)
                     for f in (440.0, 554.37)[:channels]]).astype(np.float32)


@pytest.mark.parametrize("channels", [1, 2])
def test_mp3_reads_match_jax(tmp_path, channels):
    _require_mp3()
    path = tmp_path / "t.mp3"
    path.write_bytes(encode_mp3(_tone(channels, 0.3), SR))
    _same_reads(path)


@pytest.mark.parametrize("ext,channels", [(".m4a", 1), (".mp4", 2)])
def test_aac_reads_match_jax(tmp_path, ext, channels):
    _require_aac()
    path = tmp_path / f"t{ext}"
    tff.encode_aac(path, _tone(channels, 0.3), SR)
    _same_reads(path)
    # the port's encoder writes what the JAX package's writes
    jpath = tmp_path / f"j{ext}"
    jff.encode_aac(jpath, _tone(channels, 0.3), SR)
    np.testing.assert_array_equal(tio.read_audio(path)[0], jio.read_audio(jpath)[0])


@pytest.mark.parametrize("reader", ["read_audio", "audio_info"])
def test_unknown_suffix_raises(tmp_path, reader):
    path = tmp_path / "x.ogg"
    path.write_bytes(b"OggS" + b"\x00" * 60)
    with pytest.raises(tio.UnsupportedFormatError, match=r"'\.ogg'.*\.m4a"):
        getattr(tio, reader)(path)
    assert issubclass(tio.UnsupportedFormatError, ValueError)
    assert tio.AUDIO_EXTENSIONS == jio.AUDIO_EXTENSIONS


@pytest.mark.parametrize("bit_depth,channels", [(16, 1), (16, 2), (32, 2)])
def test_write_wav_bytes_match_jax(tmp_path, bit_depth, channels):
    # past full scale at 16 bits (clipped); inside it at 32, where a clipped
    # 1.0 would round to 2^31 in float32 and overflow the cast in both
    peak = 1.2 if bit_depth == 16 else 0.99
    x = np.random.RandomState(2).uniform(-peak, peak, (channels, 1000)).astype(np.float32)
    tio.write_wav(tmp_path / "t.wav", x, SR, bit_depth=bit_depth)
    jio.write_wav(tmp_path / "j.wav", x, SR, bit_depth=bit_depth)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    if channels == 1:  # Signal.write is the same writer
        Signal(x, SR).write(tmp_path / "s.wav")
        assert (tmp_path / "s.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """a.wav, b.flac (and c.mp3, d.m4a where their libraries exist), a
    quiet e.flac under the loudness cutoff, and a csv naming them."""
    root = tmp_path_factory.mktemp("mixed")
    folder = root / "corpus"
    (folder / "sub").mkdir(parents=True)
    tio.write_wav(folder / "a.wav", _tone(1, 0.3), SR)
    (folder / "b.flac").write_bytes(encode_flac(_pcm(1, 0.3, seed=3), SR, block_size=1024))
    (folder / "sub" / "e.flac").write_bytes(
        encode_flac(_pcm(1, 0.3, seed=4) // 3000, SR, block_size=1024))
    names = ["a.wav", "b.flac", "sub/e.flac"]
    if lame_available():
        (folder / "c.mp3").write_bytes(encode_mp3(_tone(1, 0.3), SR))
        names.append("c.mp3")
    if tff.available():
        tff.encode_aac(folder / "d.m4a", _tone(1, 0.3), SR)
        names.append("d.m4a")
    (folder / "notes.txt").write_text("not audio")
    csv_path = root / "list.csv"
    csv_path.write_text("path,label\n" + "".join(f"{n},x\n" for n in names) + ",empty\n")
    return folder, csv_path, names


def test_read_sources_lists_what_jax_lists(mixed):
    """The Queue C fault: the port listed only a.wav here."""
    folder, csv_path, names = mixed
    for sources, kw in (([folder], {}), ([csv_path], {"relative_path": str(folder)}),
                        ([folder, csv_path], {})):
        got = tloaders.read_sources(sources, **kw)
        assert got == jio.read_sources(sources, **kw)
    paths = [d["path"] for d in tloaders.read_sources([folder])[0]]
    assert sorted(p[len(str(folder)) + 1:] for p in paths) == sorted(names)
    assert tloaders.AUDIO_EXTENSIONS == jio.AUDIO_EXTENSIONS


@pytest.mark.parametrize("draw", ["global_idx", "salient", "offset"])
def test_audio_loader_excerpts_match_jax(mixed, draw):
    folder = mixed[0]
    ext = [".wav", ".flac"]
    tl = tloaders.AudioLoader(sources=[str(folder)], ext=ext)
    jl = jloaders.AudioLoader(sources=[str(folder)], ext=ext)
    assert tl.audio_lists == jl.audio_lists and tl.audio_indices == jl.audio_indices
    for idx in range(4):
        kw = dict(sample_rate=SR, duration=0.1, loudness_cutoff=-40, num_channels=1)
        if draw == "global_idx":
            kw["global_idx"] = idx
        elif draw == "offset":
            kw.update(offset=0.05, global_idx=idx)
        got = tl(np.random.RandomState(idx), **kw)
        want = jl(np.random.RandomState(idx), **kw)
        assert got["path"] == want["path"], (idx, got["path"], want["path"])
        assert (got["source_idx"], got["item_idx"]) == (want["source_idx"], want["item_idx"])
        np.testing.assert_array_equal(got["signal"].audio_data,
                                      np.asarray(want["signal"].audio_data))
        assert got["signal"].metadata["offset"] == want["signal"].metadata["offset"]


def test_mp4_without_its_decoder_gives_silence_and_one_warning(tmp_path, monkeypatch):
    folder = tmp_path / "corpus"
    folder.mkdir()
    (folder / "x.mp4").write_bytes(b"\x00\x00\x00\x18ftypmp42" + b"\x00" * 40)
    monkeypatch.setattr(tff, "_LIB", None)
    monkeypatch.setattr(tff, "_REASON", "libavformat/avformat.h not found")
    loader = tloaders.AudioLoader(sources=[str(folder)])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        items = [loader(np.random.RandomState(i), SR, duration=0.1, global_idx=0)
                 for i in range(3)]
    runtime = [w for w in caught if issubclass(w.category, RuntimeWarning)]
    assert len(runtime) == 1, [str(w.message) for w in caught]
    assert "UnsupportedFormatError" in str(runtime[0].message)
    assert "avformat.h" in str(runtime[0].message)
    for item in items:
        audio = item["signal"].audio_data
        assert audio.shape == (1, 1, int(0.1 * SR)) and not audio.any()


TINY_YML = """\
$include:
  - conf/vrvq/vrvq_a2.yml
DAC_VRVQ.encoder_dim: 8
DAC_VRVQ.decoder_dim: 128
DAC_VRVQ.n_codebooks: 4
DAC_VRVQ.codebook_size: 64
"""


def test_cli_inference_reads_a_flac_folder(tmp_path):
    folder = tmp_path / "flacs"
    folder.mkdir()
    for i in range(2):
        (folder / f"clip_{i}.flac").write_bytes(
            encode_flac(_pcm(1, 0.3, seed=10 + i), SR, block_size=1024,
                        subframe_kind="lpc", order=2))
    (tmp_path / "tiny.yml").write_text(TINY_YML)
    out = tmp_path / "results"
    n = cli_inference.main([
        "--args.load", str(tmp_path / "tiny.yml"), "--data_dir", str(folder),
        "--save_result_dir", str(out), "--device", "cpu", "--num_examples", "2",
        "--duration", "0.3", "--levels", "[1.0]", "--fast", "false"])
    assert n == 2
    for i in range(2):
        meta = json.loads((out / str(i) / "metadata.json").read_text())
        assert set(meta) == {"level_4.00"} and np.isfinite(meta["level_4.00"]["sisdr"])
        # the input written is the flac's excerpt, not silence
        inp, _ = tio.read_audio(out / str(i) / "input.wav")
        assert np.abs(inp).max() > 0.01
