"""The port's chunked and streaming serving paths against its own file path
and against the JAX package's (``vrvq_tpu/infer/chunked.py``,
``vrvq_tpu/infer/streaming.py``), at the sizes of ``tests/test_streaming.py``
(encoder 8, decoder 128, 4 codebooks of 32 x 4) on jittered JAX parameters.

Tolerances: codes bit-identical everywhere (the CPU runs the same float32
arithmetic at every batch size and window); packets byte-identical; audio of
the port against itself within 1e-6 (StreamingDecoder against
``decompress``) or rtol 1e-4 / atol 1e-5 (DecoderPool: another batch size),
against JAX within rtol 1e-3 / atol 1e-4 (the port's decode tolerance); a
chunked decode within 1e-6 of the one-shot decode (the JAX bound).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vrvq_tpu.infer import chunked as jchunked
from vrvq_tpu.infer import streaming as jstreaming
from vrvq_tpu.infer.codec_api import CodecProcessor as JaxProcessor
import vrvq_tpu_torch as port
from vrvq_tpu_torch.convert import state_dict_from_jax
from vrvq_tpu_torch.infer import chunked, streaming
from tests.test_torch_support import jax_model_and_params, jnp_tree

SIZES = dict(encoder_dim=8, codebook_size=32)
WIN = 0.7


def _tone(seconds=2.5):
    t = np.arange(int(seconds * 44100)) / 44100
    x = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.1 * np.sin(2 * np.pi * 1313 * t)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def procs():
    jm, params = jax_model_and_params(0, **SIZES)
    jproc = JaxProcessor(jm, jnp_tree(params), fused_quantizer=True)
    tm = port.build_model(port.small_config(**SIZES), device="cpu",
                          state_dict=state_dict_from_jax(params))
    return jproc, port.CodecProcessor(tm, fused_quantizer=True)


def _blocks(x, seed, lo=1000, hi=30000):
    rng = np.random.RandomState(seed)
    i = 0
    while i < len(x):
        n = rng.randint(lo, hi)
        yield x[i: i + n]
        i += n


KWARGS = {"vbr": dict(level=1.0), "cbr": dict(n_quantizers=3)}


@pytest.mark.parametrize("mode", sorted(KWARGS))
def test_streaming_encoder_matches_compress_and_jax(procs, mode):
    jproc, tproc = procs
    kw = KWARGS[mode]
    x = _tone()
    f = tproc.compress(port.Signal(x, 44100), win_duration=WIN,
                       normalize_db=None, **kw)
    assert f.padding is False
    enc = streaming.StreamingEncoder(tproc, win_duration=WIN, **kw)
    chunks = []
    for block in _blocks(x, 0):
        chunks += enc.push(block)
    chunks += enc.flush()
    codes = np.concatenate([c for c, _ in chunks], axis=-1)
    np.testing.assert_array_equal(codes, f.codes[0])
    jenc = jstreaming.StreamingEncoder(jproc, win_duration=WIN, **kw)
    jchunks = jenc.push(x) + jenc.flush()
    assert len(jchunks) == len(chunks)
    for (c, n), (jc, jn) in zip(chunks, jchunks):
        np.testing.assert_array_equal(c, jc)
        if mode == "vbr":
            np.testing.assert_array_equal(n, jn)
        else:
            assert n is None and jn is None
    if mode == "vbr":
        counts = np.concatenate([n for _, n in chunks], axis=-1)
        np.testing.assert_array_equal(counts, f.vbr_counts[0])


def test_streaming_decoder_matches_decompress_and_jax(procs):
    jproc, tproc = procs
    x = _tone()
    f = tproc.compress(port.Signal(x, 44100), win_duration=WIN,
                       normalize_db=None, level=1.0)
    dec = streaming.StreamingDecoder(tproc, win_duration=WIN)
    jdec = jstreaming.StreamingDecoder(jproc, win_duration=WIN)
    codes, counts = f.codes[0], f.vbr_counts[0]
    out, jout = [], []
    rng = np.random.RandomState(1)
    i = 0
    while i < codes.shape[-1]:  # odd-sized frame blocks
        n = rng.randint(1, 2 * f.chunk_length)
        out += dec.push(codes[..., i: i + n], counts[i: i + n])
        jout += jdec.push(codes[..., i: i + n], counts[i: i + n])
        i += n
    out += dec.flush()
    jout += jdec.flush()
    got = np.concatenate(out)
    np.testing.assert_allclose(got, np.concatenate(jout), rtol=1e-3, atol=1e-4)
    # decompress: the same chunks, normalized, then trimmed
    sig = port.Signal(got[None, None], 44100).normalize(f.input_db)
    expected = tproc.decompress(f).audio_data
    np.testing.assert_allclose(sig.audio_data[..., :x.size], expected,
                               rtol=0, atol=1e-6)


def _pool_streams():
    x = _tone()
    return {f"s{i}": np.roll(x, 4000 * i)[: len(x) - 3000 * i] for i in range(3)}


def test_stream_pool_matches_single_stream_and_jax(procs):
    """Three streams of unequal length through a pool of batch 4, pushed in
    interleaved odd-sized blocks: each stream's chunks equal its own
    StreamingEncoder's (and the JAX pool's) bit for bit, in FIFO order."""
    jproc, tproc = procs
    streams = _pool_streams()
    expected = {}
    for sid, x in streams.items():
        enc = streaming.StreamingEncoder(tproc, win_duration=WIN, level=1.0)
        expected[sid] = enc.push(x) + enc.flush()

    def run(module, proc):
        pool = module.StreamPool(proc, win_duration=WIN, level=1.0, max_batch=4)
        got = {sid: [] for sid in streams}
        rngs = {sid: np.random.RandomState(i) for i, sid in enumerate(streams)}
        cursors = {sid: 0 for sid in streams}
        for sid in streams:
            pool.add_stream(sid)
        while any(cursors[s] < len(x) for s, x in streams.items()):
            for sid, x in streams.items():
                c = cursors[sid]
                if c < len(x):
                    n = rngs[sid].randint(2000, 25000)
                    pool.push(sid, x[c: c + n])
                    cursors[sid] = c + n
            for sid, codes, counts in pool.poll():
                got[sid].append((np.asarray(codes), np.asarray(counts)))
        for sid in streams:
            pool.flush(sid)
        for sid, codes, counts in pool.poll():
            got[sid].append((np.asarray(codes), np.asarray(counts)))
        return got

    for got in (run(streaming, tproc), run(jstreaming, jproc)):
        for sid in streams:
            assert len(got[sid]) == len(expected[sid]), sid
            for (gc, gn), (ec, en) in zip(got[sid], expected[sid]):
                np.testing.assert_array_equal(gc, ec)
                np.testing.assert_array_equal(gn, en)


def test_stream_pool_errors(procs):
    _, tproc = procs
    pool = streaming.StreamPool(tproc, win_duration=WIN, n_quantizers=2)
    pool.add_stream("a")
    with pytest.raises(ValueError):
        pool.add_stream("a")
    with pytest.raises(KeyError):
        pool.push("missing", np.zeros(10, np.float32))
    assert pool.poll() == []


def test_decoder_pool_matches_streaming_decoder(procs):
    _, tproc = procs
    pool = streaming.StreamPool(tproc, win_duration=WIN, level=1.0, max_batch=4)
    for sid in ("a", "b"):
        pool.add_stream(sid)
        pool.push(sid, np.roll(_tone(), 7000 if sid == "b" else 0))
        pool.flush(sid)
    chunks = pool.poll()
    decs = {sid: streaming.StreamingDecoder(tproc, win_duration=WIN)
            for sid in ("a", "b")}
    expected = {sid: [] for sid in decs}
    for sid, codes, counts in chunks:
        expected[sid] += decs[sid].push(codes, counts)
    dp = streaming.DecoderPool(tproc, win_duration=WIN, max_batch=4)
    for sid, codes, counts in chunks:
        dp.push(sid, codes, counts)
    got = {sid: [] for sid in decs}
    for sid, audio in dp.poll():
        got[sid].append(audio)
    for sid in decs:
        assert len(got[sid]) == len(expected[sid]) > 1
        for g, e in zip(got[sid], expected[sid]):
            np.testing.assert_allclose(g, e, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="whole chunks"):
        dp.push("a", chunks[0][1][..., :-1])


def test_packet_codec_bytes_match_jax(procs):
    """The same chunks give the same packets in both packages, chunk after
    chunk (the adaptive models carry over), VBR and CBR, and unpack to the
    chunks."""
    rng = np.random.RandomState(0)
    for vbr in (True, False):
        tpc = streaming.PacketCodec(4, 32)
        jpc = jstreaming.PacketCodec(4, 32)
        rx = streaming.PacketCodec(4, 32)
        for _ in range(5):
            nq = 4 if vbr else 3
            codes = rng.randint(0, 32, (nq, 43)).astype(np.int32)
            counts = rng.randint(0, 5, 43).astype(np.uint8) if vbr else None
            packet = tpc.pack(codes, counts)
            assert packet == jpc.pack(codes, counts)
            back, back_counts = rx.unpack(packet)
            if vbr:
                np.testing.assert_array_equal(back_counts, counts)
                kept = np.arange(nq)[:, None] < counts[None, :]
                np.testing.assert_array_equal(back[kept], codes[kept])
            else:
                assert back_counts is None
                np.testing.assert_array_equal(back, codes)
    with pytest.raises(ValueError, match="corrupt packet"):
        streaming.PacketCodec(4, 32).unpack(packet + b"\0")


def test_packet_codec_on_streamed_codes(procs):
    _, tproc = procs
    enc = streaming.StreamingEncoder(tproc, win_duration=WIN, level=1.0)
    chunks = enc.push(_tone()) + enc.flush()
    tx, rx = streaming.PacketCodec(4, 32), streaming.PacketCodec(4, 32)
    jtx = jstreaming.PacketCodec(4, 32)
    for codes, counts in chunks:
        packet = tx.pack(codes, counts)
        assert packet == jtx.pack(codes, counts)
        back, back_counts = rx.unpack(packet)
        np.testing.assert_array_equal(back_counts, counts)
        kept = np.arange(4)[:, None] < counts[None, :]
        np.testing.assert_array_equal(back[kept], codes[kept])


# ------------------------------------------------------------------ chunked

@pytest.fixture(scope="module")
def chunk_models():
    """The JAX chunked tests' decoder and encoder sizes: decoder 64 at the
    flagship's rates, 2 and 3 codebooks of 16 and 32 x 4."""
    out = {}
    for name, sizes in {
        "decode": dict(decoder_dim=64, n_codebooks=2, codebook_size=16),
        "encode": dict(decoder_dim=64, n_codebooks=3, codebook_size=32),
    }.items():
        sizes = dict(encoder_dim=8, **sizes)
        jm, params = jax_model_and_params(0, **sizes)
        tm = port.build_model(port.small_config(**sizes), device="cpu",
                              state_dict=state_dict_from_jax(params))
        out[name] = (jm, jnp_tree(params), tm)
    return out


@pytest.mark.parametrize("t_frames,chunk", [(100, 16), (97, 16), (33, 32),
                                            (64, 64)])
def test_decode_chunked_matches_one_shot_and_jax(chunk_models, t_frames, chunk):
    jm, jp, tm = chunk_models["decode"]
    rng = np.random.RandomState(0)
    z_q = rng.randn(2, tm.config.resolved_latent_dim, t_frames).astype(np.float32)
    with torch.inference_mode():
        z = torch.from_numpy(z_q)
        full = tm.decode(z).numpy()
        got = chunked.decode_chunked(tm, z, chunk_frames=chunk).numpy()
    assert got.shape == full.shape
    assert np.abs(got - full).max() < 1e-6
    ref = np.asarray(jchunked.decode_chunked(jm, jp, jnp.asarray(z_q),
                                             chunk_frames=chunk))
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("t_frames,chunk", [(100, 16), (97, 16)])
def test_encode_chunked_matches_one_shot_and_jax(chunk_models, t_frames, chunk):
    jm, jp, tm = chunk_models["encode"]
    hop = tm.hop_length
    rng = np.random.RandomState(3)
    audio = (rng.randn(2, 1, t_frames * hop) * 0.3).astype(np.float32)
    with torch.inference_mode():
        x = torch.from_numpy(audio)
        full = tm.encode(x, level=1.0)
        got = chunked.encode_chunked(tm, x, level=1.0, chunk_frames=chunk)
    np.testing.assert_array_equal(got["codes"].numpy(), full["codes"].numpy())
    np.testing.assert_allclose(got["imp_map"].numpy(), full["imp_map"].numpy(),
                               rtol=1e-5, atol=1e-6)
    ref = jchunked.encode_chunked(jm, jp, jnp.asarray(audio), level=1.0,
                                  chunk_frames=chunk)
    np.testing.assert_array_equal(got["codes"].numpy(), np.asarray(ref["codes"]))
    np.testing.assert_array_equal(got["mask_imp"].numpy(),
                                  np.asarray(ref["mask_imp"]))
    np.testing.assert_allclose(got["z_q"].numpy(), np.asarray(ref["z_q"]),
                               rtol=1e-3, atol=1e-4)


def test_forward_chunked_matches_forward_and_jax(chunk_models):
    jm, jp, tm = chunk_models["encode"]
    rng = np.random.RandomState(4)
    n = 70 * tm.hop_length + 123  # not a multiple of the hop
    audio = (rng.randn(1, 1, n) * 0.3).astype(np.float32)
    with torch.inference_mode():
        x = torch.from_numpy(audio)
        full = tm(x, level=1.0)
        got, codes = chunked.forward_chunked(tm, x, level=1.0, chunk_frames=16)
    assert got.shape == full["audio"].shape == (1, 1, n)
    np.testing.assert_array_equal(codes.numpy(), full["codes"].numpy())
    assert np.abs(got.numpy() - full["audio"].numpy()).max() < 1e-5
    jaudio, jcodes = jchunked.forward_chunked(jm, jp, jnp.asarray(audio),
                                              level=1.0, chunk_frames=16)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_allclose(got.numpy(), np.asarray(jaudio),
                               rtol=1e-3, atol=1e-4)


def test_encode_chunked_rejects_a_ragged_clip(chunk_models):
    _, _, tm = chunk_models["encode"]
    with pytest.raises(ValueError, match="multiple of the hop"):
        chunked.encode_chunked(tm, torch.zeros(1, 1, tm.hop_length * 3 + 1))
