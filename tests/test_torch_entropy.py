"""The port's range coder and entropy-coded ``.dac`` against the JAX
package's (``vrvq_tpu/ops/rangecoder.py``, ``vrvq_tpu/models/codec.py``).

The coder must give the same bytes for the same symbols over the fuzz cases
of ``tests/test_rangecoder.py`` (and decode them back); an entropy-coded
``.dac`` written by either package must load in the other with the same
codes and counts, and the two files must be byte-identical.
"""

import numpy as np
import pytest

from vrvq_tpu.models import codec as jcodec
from vrvq_tpu.ops import rangecoder as jrc
from vrvq_tpu_torch.models import codec as tcodec
from vrvq_tpu_torch.ops import rangecoder as trc


def _zipf(rng, n_symbols, n, power=1.3):
    base = rng.permutation(n_symbols)
    p = 1.0 / (np.arange(1, n_symbols + 1) ** power)
    return base[rng.choice(n_symbols, size=n, p=p / p.sum())]


def _burst(seed, n_symbols=300):
    rng = np.random.RandomState(seed)
    n = rng.randint(1, 4000)
    syms = rng.randint(0, n_symbols, size=n)
    syms[rng.rand(n) < 0.5] = rng.randint(0, n_symbols)
    return syms, n_symbols, None, 1


def _cases():
    """(id, symbols, n_symbols, contexts, n_contexts) of the JAX fuzz tests."""
    out = []
    for n_symbols in (2, 3, 17, 256, 1024):
        rng = np.random.RandomState(n_symbols)
        for n in (0, 1, 5, 1000):
            out.append((f"uniform-{n_symbols}-{n}",
                        rng.randint(0, n_symbols, size=n), n_symbols, None, 1))
    rng = np.random.RandomState(0)
    out.append(("zipf-contexts", _zipf(rng, 1024, 20000), 1024,
                rng.randint(0, 8, size=20000), 8))
    out.append(("constant", np.full(5000, 7), 1024, None, 1))
    for i, pattern in enumerate((np.zeros(300, np.int64), np.full(300, 63),
                                 np.tile([0, 63], 150), np.arange(300) % 64)):
        out.append((f"edge-{i}", pattern, 64, None, 1))
    for seed in range(20):
        out.append((f"burst-seed{seed}", *_burst(seed)))
    return out


CASES = _cases()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_range_coder_bytes_match_jax(case):
    _, syms, n_symbols, ctx, n_ctx = case
    data = trc.encode_adaptive(syms, n_symbols, ctx, n_ctx)
    assert data == jrc.encode_adaptive(syms, n_symbols, ctx, n_ctx)
    np.testing.assert_array_equal(
        trc.decode_adaptive(data, len(syms), n_symbols, ctx, n_ctx), syms)


def test_adaptive_coder_models_persist_across_packets():
    rng = np.random.RandomState(1)
    tx, jtx = trc.AdaptiveCoder(64, 3), jrc.AdaptiveCoder(64, 3)
    rx = trc.AdaptiveCoder(64, 3)
    for _ in range(4):
        syms = _zipf(rng, 64, 500)
        ctx = rng.randint(0, 3, size=500)
        packet = tx.encode(syms, ctx)
        assert packet == jtx.encode(syms, ctx)
        np.testing.assert_array_equal(rx.decode(packet, 500, ctx), syms)


def test_range_coder_errors():
    with pytest.raises(ValueError):
        trc.encode_adaptive(np.array([5]), 4)
    with pytest.raises(ValueError):
        trc.encode_adaptive(np.array([1, 2]), 4, np.array([0]), 2)
    with pytest.raises(ValueError, match="context out of range"):
        trc.encode_adaptive(np.array([1, 2]), 4, np.array([0, 2]), 2)


META = dict(chunk_length=15, original_length=15000, input_db=-17.25,
            channels=1, sample_rate=44100, padding=False)


@pytest.mark.parametrize("vbr", [True, False], ids=["vbr", "cbr"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_entropy_dac_loads_across_packages(tmp_path, vbr, writer):
    rng = np.random.RandomState(int(vbr))
    codes = _zipf(rng, 1024, 2 * 8 * 30).reshape(2, 8, 30).astype(np.int32)
    counts = rng.randint(0, 9, (2, 30)).astype(np.uint8) if vbr else None
    files = {}
    for name, package in (("jax", jcodec), ("port", tcodec)):
        f = package.DACFile(codes=codes, vbr_counts=counts, **META)
        files[name] = f.save(tmp_path / f"{name}.dac", entropy=True,
                             codebook_size=1024)
    assert files["jax"].read_bytes() == files["port"].read_bytes()
    reader = tcodec if writer == "jax" else jcodec
    back = reader.DACFile.load(files[writer])
    got = np.asarray(back.codes)
    if vbr:
        np.testing.assert_array_equal(np.asarray(back.vbr_counts), counts)
        kept = np.arange(8)[None, :, None] < counts[:, None, :]
        np.testing.assert_array_equal(got[kept], codes[kept])
        np.testing.assert_array_equal(got[~kept], 0)
    else:
        assert back.vbr_counts is None
        np.testing.assert_array_equal(got, codes)
    assert back.input_db == META["input_db"] and back.padding is False
    # smaller than the bit-packed file for a skewed stream
    packed = tcodec.DACFile(codes=codes, vbr_counts=counts, **META).save(
        tmp_path / "packed.dac", compact=True, codebook_size=1024)
    assert files["port"].stat().st_size < packed.stat().st_size
