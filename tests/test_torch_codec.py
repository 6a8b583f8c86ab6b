"""The port's serving path against the JAX package's: compress, .dac, decompress.

Both packages get the same jittered small model and the same seeded clip.
Each measures loudness with its own meter of the same kind
(``test_torch_support.own_loudness_meters``: JAX's C++ meter against the
port's, or, without a compiler, JAX's numpy meter against the port's).
``compress`` through the fused quantizer must give identical codes and
``vbr_counts``; the same codes must give byte-identical ``.dac`` files; the
decompressed audio must agree within rtol 1e-3 / atol 1e-4. Plus the import
guard (no JAX, flax, yaml or vrvq_tpu behind the port or chip_smoke.py) and
chip_smoke.py's refusal to run without CUDA.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from vrvq_tpu.audio import Signal as JaxSignal
from vrvq_tpu.infer.codec_api import CodecProcessor as JaxProcessor
from vrvq_tpu.models import codec as jcodec
import vrvq_tpu_torch as port
from vrvq_tpu_torch.models import codec as tcodec
from tests.test_torch_support import (jax_model_and_params, jnp_tree, own_loudness_meters,
                                       port_model)

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-3, 1e-4


@pytest.fixture(scope="module")
def processors():
    jm, params = jax_model_and_params(0)
    jproc = JaxProcessor(jm, jnp_tree(params), fused_quantizer=True)
    tproc = port.CodecProcessor(port_model(params), fused_quantizer=True)
    return jproc, tproc


@pytest.fixture(autouse=True)
def own_meters():
    own_loudness_meters()


def _clip(seconds=2.5, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * 44100)) / 44100
    x = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.randn(t.size)
    return x.astype(np.float32)


CASES = {
    "chunked-vbr": dict(win_duration=0.5, level=1.0),
    "chunked-vbr-low": dict(win_duration=0.5, level=0.4),
    "chunked-cbr": dict(win_duration=0.5, n_quantizers=3),
    "oneshot-vbr": dict(win_duration=None, level=1.5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_compress_matches_jax(processors, case, tmp_path):
    jproc, tproc = processors
    kwargs = CASES[case]
    x = _clip()
    jf = jproc.compress(JaxSignal(x, 44100), **kwargs)
    tf = tproc.compress(port.Signal(x, 44100), **kwargs)

    np.testing.assert_array_equal(tf.codes, np.asarray(jf.codes))
    if jf.vbr_counts is None:
        assert tf.vbr_counts is None
    else:
        np.testing.assert_array_equal(tf.vbr_counts, np.asarray(jf.vbr_counts))
    for field in ("chunk_length", "original_length", "channels",
                  "sample_rate", "padding"):
        assert getattr(tf, field) == getattr(jf, field), field
    assert tf.input_db == jf.input_db

    # the same file on disk from both packages
    jpath = jf.save(tmp_path / "jax.dac")
    tpath = tf.save(tmp_path / "port.dac")
    assert tpath.read_bytes() == jpath.read_bytes()

    jout = jproc.decompress(jcodec.DACFile.load(jpath))
    tout = tproc.decompress(port.DACFile.load(tpath))
    assert tout.audio_data.shape == (1, 1, x.size)
    assert tout.audio_data.dtype == np.asarray(jout.audio_data).dtype
    np.testing.assert_allclose(tout.audio_data, np.asarray(jout.audio_data),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("vbr", [False, True])
def test_dac_bytes_identical_for_same_codes(tmp_path, vbr, compact):
    rng = np.random.RandomState(int(vbr) * 2 + int(compact))
    codes = rng.randint(0, 1024, (2, 8, 30)).astype(np.int32)
    counts = rng.randint(1, 9, (2, 30)).astype(np.uint8) if vbr else None
    meta = dict(chunk_length=15, original_length=15000, input_db=-17.25,
                channels=1, sample_rate=44100, padding=False)
    jf = jcodec.DACFile(codes=codes, vbr_counts=counts, **meta)
    tf = tcodec.DACFile(codes=codes, vbr_counts=counts, **meta)
    jp = jf.save(tmp_path / "a.dac", compact=compact, codebook_size=1024)
    tp = tf.save(tmp_path / "b.dac", compact=compact, codebook_size=1024)
    assert tp.read_bytes() == jp.read_bytes()
    # each package reads the other's file
    back = tcodec.DACFile.load(jp)
    np.testing.assert_array_equal(
        back.codes, np.asarray(jcodec.DACFile.load(tp).codes))
    if vbr:
        np.testing.assert_array_equal(back.vbr_counts, counts)


def test_entropy_format_raises(tmp_path):
    """The range-coded format (ported now) refuses a code outside the
    alphabet it is given, as the JAX package's does."""
    codes = np.zeros((1, 2, 4), np.int32)
    codes[0, 1, 2] = 5
    meta = dict(chunk_length=4, original_length=2048, input_db=-20.0,
                channels=1, sample_rate=44100, padding=True)
    for package in (tcodec, jcodec):
        f = package.DACFile(codes=codes, **meta)
        with pytest.raises(ValueError, match="symbol out of range"):
            f.save(tmp_path / "x.dac", entropy=True, codebook_size=4)


@pytest.mark.parametrize("bits", [1, 4, 10, 13])
def test_pack_bits_matches_jax(bits):
    values = np.random.RandomState(bits).randint(0, 1 << bits, 257)
    packed = tcodec.pack_bits(values, bits)
    np.testing.assert_array_equal(packed, jcodec.pack_bits(values, bits))
    np.testing.assert_array_equal(tcodec.unpack_bits(packed, bits, 257), values)


def test_signal_loudness_and_wav_roundtrip(tmp_path):
    x = _clip(1.0, seed=3)
    jsig, tsig = JaxSignal(x, 44100), port.Signal(x, 44100)
    np.testing.assert_array_equal(tsig.loudness(), jsig.loudness())
    np.testing.assert_array_equal(tsig.clone().normalize(-16).audio_data,
                                  jsig.clone().normalize(-16).audio_data)
    path = tmp_path / "x.wav"
    tsig.write(path)
    back = port.Signal.load(path)
    assert back.audio_data.shape == (1, 1, x.size)
    np.testing.assert_allclose(back.audio_data[0, 0], x, atol=1.0 / 32767)
    np.testing.assert_array_equal(
        back.audio_data, JaxSignal.load(path).audio_data)
    # resampling (ported now) gives the JAX package's samples
    np.testing.assert_array_equal(tsig.clone().resample(16000).audio_data,
                                  np.asarray(jsig.clone().resample(16000).audio_data))


def test_fused_compress_follows_parameter_changes():
    """The fused processor prepares the quantizer's weights on every
    compress, so an in-place change to the model after construction shows
    in its codes, as it does on the module path."""
    model = port.build_model(port.small_config(), device="cpu", seed=1)
    fused = port.CodecProcessor(model, fused_quantizer=True)
    plain = port.CodecProcessor(model, fused_quantizer=False)
    sig = port.Signal(_clip(1.5, seed=3)[None, None], 44100)
    kw = dict(win_duration=0.5, level=1.0)
    before = fused.compress(sig, **kw).codes
    codebook = model.quantizer.quantizers[0].codebook
    with torch.no_grad():
        codebook.copy_(codebook.flip(0))
    after = fused.compress(sig, **kw).codes
    assert (after[:, 0] != before[:, 0]).any()
    np.testing.assert_array_equal(after, plain.compress(sig, **kw).codes)


def test_window_geometry_matches_jax(processors):
    jproc, tproc = processors
    for win in (0.5, 1.0, 2.0):
        assert tproc.window_geometry(win) == jproc.window_geometry(win)


BLOCKER = textwrap.dedent("""
    import importlib, pkgutil, sys
    BLOCKED = {"jax", "jaxlib", "flax", "optax", "orbax", "yaml", "vrvq_tpu"}
    for name in list(sys.modules):
        if name.split(".")[0] in BLOCKED:
            del sys.modules[name]

    class Block:
        @staticmethod
        def find_spec(name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block)
    import vrvq_tpu_torch
    walked = set()
    for mod in pkgutil.walk_packages(vrvq_tpu_torch.__path__, "vrvq_tpu_torch."):
        importlib.import_module(mod.name)
        walked.add(mod.name)
    serving = {"vrvq_tpu_torch." + m for m in (
        "nn.fold", "infer.fast", "infer.chunked", "infer.streaming",
        "infer.sweep", "ops.rangecoder", "ops.resample", "metrics")}
    assert serving <= walked, sorted(serving - walked)
    training = {"vrvq_tpu_torch." + m for m in (
        "ops.stft", "losses.recon", "losses.gan", "models.discriminator",
        "data.loaders", "data.collate", "data.transforms", "train.schedule",
        "train.state", "train.loop", "train.checkpoint", "train.tracker",
        "train.trainer", "profile_train")}
    assert training <= walked, sorted(training - walked)
    configured = {"vrvq_tpu_torch." + m for m in (
        "config", "cli", "cli.train", "cli.inference", "models.dac_moe")}
    assert configured <= walked, sorted(configured - walked)
    evaluation = {"vrvq_tpu_torch." + m for m in (
        "data.audio_io", "data.flac_py", "data.mpeg", "data.ffdecode", "visqol",
        "losses.framewise", "cli.evaluate", "cli.stream_demo")}
    assert evaluation <= walked, sorted(evaluation - walked)
    edge = {"vrvq_tpu_torch." + m for m in ("native", "native.io", "cli.export_torch")}
    assert edge <= walked, sorted(edge - walked)
    packed = {"vrvq_tpu_torch." + m for m in ("utils", "profile_stages", "profile_serve",
                                              "nn.layers", "audio")}
    assert packed <= walked, sorted(packed - walked)
    import chip_smoke
    leaked = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print("clean")
""")


def test_port_and_chip_smoke_import_without_jax():
    proc = subprocess.run([sys.executable, "-c", BLOCKER], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("clean")


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "script-alone"])
def test_chip_smoke_fails_without_cuda(tmp_path, alone):
    """Without CUDA (and, alone in a directory, without the port) the script
    exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    cwd = REPO
    if alone:
        (tmp_path / "chip_smoke.py").write_bytes((REPO / "chip_smoke.py").read_bytes())
        cwd = tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
