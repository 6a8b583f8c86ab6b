"""The port's native I/O library (``vrvq_tpu_torch/native``: wav and flac
readers, the BS.1770 meter, the range coder) against its plain versions and
the JAX package's.

Readers: on every stream of ``tests/test_torch_audio_io.py`` (flac from
``tests/flac_encoder.py``: verbatim, fixed orders 0-4, LPC orders 1-2, the
three stereo decorrelations, wasted bits, and 8/24-bit verbatim streams;
wav at 8/16/24/32-bit PCM and 32-bit float), whole and at excerpts whose
offsets fall inside a frame, the native decode equals ``data/flac_py.py``,
the numpy wav parser and the JAX package's readers bit for bit (and JAX's
Python flac decoder on each whole stream), and the native counters rise.

Loudness: the native meter filters sample by sample and sums each block's
energy from float64 prefix sums, where the numpy meter filters with scipy
and takes float64 means of the frames; both read the float32 samples and
compute in float64, so they differ by float64 rounding only. The bar is
1e-9 LU (measured: at most 4.3e-14 LU on these clips), and on clips whose
0.38 s excerpts fall on both sides of the loader's -40 LUFS cutoff the two
meters decide every try alike.

Range coder: the C++ coder's bytes equal the Python coder's and the JAX
package's Python coder's, packet after packet (the models adapting across
packets), with contexts; its decode round-trips. The entropy ``.dac`` and
``PacketCodec`` take the native backend. Where the library cannot be built,
``library()`` warns once with the reason and the plain versions serve.
"""

import warnings

import numpy as np
import pytest
import torch

from tests.flac_encoder import encode_flac
from tests.test_torch_audio_io import (EXCERPTS, FLAC_CASES, SR, _pcm, _raw_wav,
                                       _verbatim_flac)
from vrvq_tpu.data import audio_io as jio
from vrvq_tpu.data import flac_py as jflac
from vrvq_tpu.ops.rangecoder import AdaptiveCoder as JaxCoder
import vrvq_tpu_torch as port
from vrvq_tpu_torch.data import audio_io as tio
from vrvq_tpu_torch.data import flac_py
from vrvq_tpu_torch.data.loaders import AudioLoader
from vrvq_tpu_torch.infer.streaming import PacketCodec
from vrvq_tpu_torch.native import io as native_io
from vrvq_tpu_torch.ops.loudness import integrated_loudness
from vrvq_tpu_torch.ops.rangecoder import AdaptiveCoder, decode_adaptive, encode_adaptive

torch.set_num_threads(1)
LOUDNESS_BAR_LU = 1e-9


@pytest.fixture(scope="module")
def lib():
    lib = native_io.library()
    assert lib is not None, native_io.reason()
    return lib


def _flac_streams(tmp_path):
    """Every flac stream of the audio-io tests, as written there."""
    paths = []
    for case, kw in sorted(FLAC_CASES.items()):
        kw = dict(kw)
        channels = 2 if "side" in case or case == "wasted" else 1
        pcm = _pcm(channels, 0.25, seed=len(case))[:, : 21 * 512]
        if kw.get("wasted"):
            pcm = (pcm >> kw["wasted"]) << kw["wasted"]
        path = tmp_path / f"{case}.flac"
        path.write_bytes(encode_flac(pcm, SR, block_size=512, **kw))
        paths.append(path)
    for bits in (8, 24):
        path = tmp_path / f"d{bits}.flac"
        path.write_bytes(_verbatim_flac(_pcm(2, 0.2, bits=bits, seed=bits), bits))
        paths.append(path)
    return paths


def test_native_flac_equals_the_python_decoders(lib, tmp_path):
    before = native_io.IO_CALLS["flac_native"]
    paths = _flac_streams(tmp_path)
    for path in paths:
        for offset, duration in [(0.0, None), *EXCERPTS]:
            got, sr = native_io.read_flac(path, offset, duration)
            plain, psr = flac_py.read_flac(path, offset=offset, duration=duration)
            jax_io, _ = jio.read_flac(path, offset=offset, duration=duration)
            assert sr == psr == SR and got.dtype == np.float32
            for want in (plain, jax_io):
                np.testing.assert_array_equal(got, want, err_msg=f"{path.name} {offset}")
            np.testing.assert_array_equal(tio.read_audio(path, offset, duration)[0], got)
        # and the JAX package's Python decoder, on the whole stream
        np.testing.assert_array_equal(native_io.read_flac(path)[0],
                                      jflac.read_flac(path)[0], err_msg=path.name)
    assert native_io.IO_CALLS["flac_native"] - before >= 2 * len(paths) * len(EXCERPTS)


@pytest.mark.parametrize("bits,fmt,channels", [
    (8, 1, 1), (16, 1, 2), (24, 1, 2), (32, 1, 1), (32, 3, 2)])
def test_native_wav_equals_the_numpy_parser(lib, tmp_path, bits, fmt, channels):
    if fmt == 3:
        data = np.random.RandomState(1).uniform(-0.9, 0.9, (channels, int(0.2 * SR)))
    else:
        data = _pcm(channels, 0.2, bits=bits, seed=bits)
    path = tmp_path / f"w{bits}_{fmt}.wav"
    _raw_wav(path, data, bits, fmt)
    before = native_io.IO_CALLS["wav_native"]
    for offset, duration in [(0.0, None), *EXCERPTS]:
        got, sr = native_io.read_wav(path, offset, duration)
        np.testing.assert_array_equal(got, tio.read_wav_np(path, offset, duration)[0])
        np.testing.assert_array_equal(got, jio.read_wav(path, offset, duration)[0])
        np.testing.assert_array_equal(tio.read_wav(path, offset, duration)[0], got)
        assert sr == SR
    assert native_io.IO_CALLS["wav_native"] - before == 2 * (len(EXCERPTS) + 1)


def _clips():
    """Seeded clips at several levels and lengths (one under a 0.4 s block,
    one quiet enough to be gated out), (C, T) float32."""
    rng = np.random.RandomState(7)
    clips = [port.synthetic_clip(s, SR, seed)[0] * g
             for s, seed, g in ((1.0, 1, 1.0), (0.38, 2, 0.3), (0.2, 3, 1.0),
                                (2.0, 4, 0.01), (0.5, 5, 1e-5))]
    clips.append((0.2 * rng.randn(2, SR // 2)).astype(np.float32))
    return clips


def test_native_loudness_within_its_bar_of_the_numpy_meter(lib):
    before = native_io.IO_CALLS["loudness_native"]
    spread = 0.0
    for x in _clips():
        got = native_io.loudness(x, SR)
        want = float(integrated_loudness(x[None].astype(np.float64), SR)[0])
        if np.isinf(want):
            assert got == want
            continue
        spread = max(spread, abs(got - want))
        # Signal.loudness goes native and floors at -70, as JAX's does
        assert port.Signal(x, SR).loudness()[0] == np.float32(max(got, -70.0))
    assert spread <= LOUDNESS_BAR_LU, spread
    assert native_io.IO_CALLS["loudness_native"] - before >= 2 * len(_clips()) - 2


def test_loader_cutoff_decides_alike(lib, tmp_path):
    """The salient-excerpt loop keeps an excerpt once it is louder than -40
    LUFS: on the loader's clips both meters decide every try alike."""
    decisions = set()
    for i, gain in enumerate((0.056, 0.063, 0.07)):  # about -40 LUFS
        port.Signal(port.synthetic_clip(1.0, SR, 30 + i) * gain, SR).write(
            tmp_path / f"c{i}.wav")
    loader = AudioLoader(sources=[str(tmp_path)])
    for idx in range(12):
        state = np.random.RandomState(idx)
        for _ in range(3):
            excerpt = port.Signal.excerpt(
                loader.audio_lists[0][idx % 3]["path"], duration=0.38, state=state)
            data = excerpt.audio_data[0]
            native = native_io.loudness(data, SR)
            plain = float(integrated_loudness(data[None].astype(np.float64), SR)[0])
            assert (native > -40) == (plain > -40), (idx, native, plain)
            decisions.add(native > -40)
    assert decisions == {True, False}


def _symbols(seed, n, n_symbols, n_contexts):
    rng = np.random.RandomState(seed)
    # skewed, so the models adapt and rescale (total reaches 2^16)
    syms = np.minimum(rng.geometric(0.05, n) - 1, n_symbols - 1)
    return syms, rng.randint(0, n_contexts, n)


@pytest.mark.parametrize("n_symbols,n_contexts", [(1024, 8), (9, 1), (2, 3)])
def test_native_range_coder_is_byte_identical(lib, n_symbols, n_contexts):
    coders = [AdaptiveCoder(n_symbols, n_contexts, "native"),
              AdaptiveCoder(n_symbols, n_contexts, "python"),
              JaxCoder(n_symbols, n_contexts, backend="python")]
    receiver = AdaptiveCoder(n_symbols, n_contexts, "native")
    assert [c.backend for c in coders[:2]] == ["native", "python"]
    before = dict(native_io.IO_CALLS)
    for packet in range(4):
        syms, ctx = _symbols(packet, 3000, n_symbols, n_contexts)
        data = [c.encode(syms, ctx) for c in coders]
        assert data[0] == data[1] == data[2], packet
        np.testing.assert_array_equal(receiver.decode(data[0], syms.size, ctx), syms)
    assert native_io.IO_CALLS["rc_encode_native"] - before.get("rc_encode_native", 0) == 4
    assert native_io.IO_CALLS["rc_decode_native"] - before.get("rc_decode_native", 0) == 4
    syms, ctx = _symbols(9, 500, n_symbols, n_contexts)
    one_shot = encode_adaptive(syms, n_symbols, ctx, n_contexts)
    assert one_shot == encode_adaptive(syms, n_symbols, ctx, n_contexts, backend="python")
    np.testing.assert_array_equal(
        decode_adaptive(one_shot, syms.size, n_symbols, ctx, n_contexts), syms)


def test_entropy_paths_take_the_native_backend(lib, tmp_path):
    codec = PacketCodec(4, 64)
    assert codec._codes_coder.backend == codec._counts_coder.backend == "native"
    rng = np.random.RandomState(0)
    codes = rng.randint(0, 64, (1, 4, 30)).astype(np.int64)
    counts = rng.randint(1, 5, (1, 30)).astype(np.int64)
    dac = port.DACFile(codes=codes, chunk_length=30, original_length=30 * 512,
                       input_db=np.float32(-20.0), channels=1, sample_rate=SR,
                       padding=True, vbr_counts=counts)
    before = native_io.IO_CALLS["rc_encode_native"]
    back = port.DACFile.load(dac.save(tmp_path / "a.dac", entropy=True,
                                      codebook_size=64))
    assert native_io.IO_CALLS["rc_encode_native"] > before
    np.testing.assert_array_equal(back.vbr_counts, counts)


def test_without_a_compiler_the_plain_versions_serve_after_one_warning(
        lib, tmp_path, monkeypatch):
    pcm = _pcm(1, 0.1)
    path = tmp_path / "a.flac"
    path.write_bytes(encode_flac(pcm, SR, block_size=512))
    monkeypatch.setattr(native_io, "_LIB", None)
    monkeypatch.setattr(native_io, "_REASON", None)
    monkeypatch.setenv("CXX", "no-such-compiler")
    with pytest.warns(RuntimeWarning, match="no C.. compiler"):
        assert native_io.library() is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # once only
        assert native_io.library() is None
        got, _ = tio.read_audio(path)
        assert AdaptiveCoder(16).backend == "python"
        with pytest.raises(RuntimeError, match="unavailable"):
            AdaptiveCoder(16, backend="native")
    np.testing.assert_array_equal(np.round(got * 32768.0).astype(np.int64), pcm)
