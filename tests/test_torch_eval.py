"""The port's evaluation tools against the JAX package's: the metrics, ViSQOL,
the framewise losses, and the evaluate and stream_demo CLIs.

Tolerances: the SDR family, L1, ``mean_std`` and every host metric of
``cal_metrics`` within 1e-9 absolute on float64 inputs (the same numpy
arithmetic); the mel and stft keys through the port's losses within the
losses' own bar (rtol 1e-5, as ``test_torch_train_losses.py``); ``visqol`` and
``nsim_to_mos`` within 1e-12 on 1 s pairs; the framewise losses within 1e-5
relative in float32 (atol 1e-5 of the map's largest element).

``cli.evaluate`` at a tiny config (encoder 8, decoder 128, 4 codebooks of 64
on top of ``conf/vrvq/vrvq_a2.yml``) on one 0.5 s wav and one 0.5 s flac,
against ``scripts/evaluate.py: evaluate`` (imported by path) on the same
jittered parameters (``export_torch_state_dict`` -> ``--torch_ckpt``). With
``--fast 0``: kbps, bits per frame and codebook usage equal, every other
number within 1e-3 relative. With ``--fast 1`` (a bfloat16 decoder with the
polynomial Snake in both, which round in another order): kbps, bits per
frame and usage equal (the codes are the live encoder's), and bars at about
twice the measured spread: SI-SDR and SI-SNR within 2 dB (measured 0.87 dB:
the random tiny decoder's output is nearly uncorrelated with its input, an
SI-SDR near -72 dB, where the ratio is ill-conditioned), SDR and SNR within
0.05 dB (0.0084), L1 within 0.1 % (0.015 %), mel and stft within 1 %
(0.42 %), ViSQOL and its MOS within 0.005 (0.0010).
"""

import importlib.util
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.flac_encoder import encode_flac
from tests.test_torch_support import jitter
from vrvq_tpu import losses as jlosses
from vrvq_tpu import metrics as jmetrics
from vrvq_tpu import visqol as jvisqol
from vrvq_tpu.config import parse_args as jax_parse_args
from vrvq_tpu.models import DAC_VRVQ as JaxDAC
from vrvq_tpu.train.checkpoint import export_torch_state_dict
from vrvq_tpu_torch import losses as tlosses
from vrvq_tpu_torch import metrics as tmetrics
from vrvq_tpu_torch import visqol as tvisqol
from vrvq_tpu_torch.cli import evaluate as cli_eval
from vrvq_tpu_torch.cli import stream_demo as cli_stream
from vrvq_tpu_torch.config import REPO
from vrvq_tpu_torch.data.audio_io import read_audio, write_wav

torch.set_num_threads(1)
SR = 44100


def _music(seconds: float, seed: int) -> np.ndarray:
    """Harmonics under an envelope, plus a little noise (float64)."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * SR)) / SR
    x = sum(a * np.sin(2 * np.pi * f * t + rng.uniform(0, 6))
            for f, a in ((220, 0.3), (660, 0.15), (1870, 0.08), (5100, 0.04)))
    return x * (0.6 + 0.4 * np.sin(2 * np.pi * 1.5 * t)) + 0.01 * rng.randn(t.size)


@pytest.fixture(scope="module")
def pair():
    """A (2, 1, 0.3 s) float64 reference and a filtered, noisy estimate."""
    ref = np.stack([_music(0.3, s) for s in (0, 1)])[:, None]
    est = 0.9 * ref + 0.05 * np.random.RandomState(2).randn(*ref.shape)
    est[..., 1:] += 0.3 * ref[..., :-1]
    return est, ref


def _loss_states(sr=SR):
    kw = dict(n_mels=[40, 20], window_lengths=[512, 256],
              mel_fmin=[0.0, 0.0], mel_fmax=[None, None])
    return (SimpleNamespace(mel_loss=tlosses.MelSpectrogramLoss(**kw, sample_rate=sr),
                            stft_loss=tlosses.MultiScaleSTFTLoss(window_lengths=[512, 256]),
                            waveform_loss=tlosses.L1Loss()),
            SimpleNamespace(mel_loss=jlosses.MelSpectrogramLoss(**kw, sample_rate=sr),
                            stft_loss=jlosses.MultiScaleSTFTLoss(window_lengths=[512, 256]),
                            waveform_loss=jlosses.L1Loss()))


@pytest.mark.parametrize("name", ["sdr", "sdr_zero_mean_loaded", "l1", "si_sdr",
                                  "snr", "snr_zero_mean", "si_snr"])
def test_host_metrics_match_jax(pair, name):
    est, ref = pair
    fn, kw = {"sdr_zero_mean_loaded": ("sdr", dict(zero_mean=True, load_diag=1e-3)),
              "snr_zero_mean": ("snr", dict(zero_mean=True))}.get(name, (name, {}))
    got = getattr(tmetrics, fn)(est, ref, **kw)
    want = getattr(jmetrics, fn)(est, ref, **kw)
    assert abs(got - want) <= 1e-9, (got, want)
    # torch tensors on the way in give the same number
    assert getattr(tmetrics, fn)(torch.from_numpy(est), torch.from_numpy(ref), **kw) == got


def test_sdr_of_silence_is_nan_in_both():
    z = np.zeros((1, 1, 1000))
    assert np.isnan(tmetrics.sdr(z, z)) and np.isnan(jmetrics.sdr(z, z))


@pytest.mark.parametrize("key", ["SDR", "SI-SDR", "SI-SNR", "SNR", "L1", "ViSQOL",
                                 "ViSQOL-speech", "ViSQOL-MOS", "mel", "stft",
                                 "waveform"])
def test_cal_metrics_matches_jax(pair, key):
    est, ref = pair
    tstate, jstate = _loss_states()
    if key in ("mel", "stft", "waveform"):
        got = tmetrics.cal_metrics(est.astype(np.float32), ref.astype(np.float32),
                                   tstate, key)
        want = jmetrics.cal_metrics(est.astype(np.float32), ref.astype(np.float32),
                                    jstate, key)
        np.testing.assert_allclose(got, want, rtol=1e-5)
    else:
        got = tmetrics.cal_metrics(est, ref, tstate, key)
        assert abs(got - jmetrics.cal_metrics(est, ref, jstate, key)) <= 1e-9
    with pytest.raises(ValueError, match="Unknown loss function"):
        tmetrics.cal_metrics(est, ref, tstate, "PESQ")


@pytest.mark.parametrize("data", [[1.0, 2.0, np.nan, 4.5], [np.nan, 3.0], [0.25]])
def test_mean_std_matches_jax(data):
    got, want = tmetrics.mean_std(data), jmetrics.mean_std(data)
    assert np.allclose(got, want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("degrade", ["noise", "lowpass", "silence"])
def test_visqol_matches_jax(degrade):
    ref = _music(1.0, 5)
    if degrade == "noise":
        deg = ref + 0.05 * np.random.RandomState(6).randn(ref.size)
    elif degrade == "lowpass":
        deg = np.convolve(ref, np.ones(9) / 9, mode="same")
    else:
        deg = np.zeros_like(ref)
    for speech in (False, True):
        got = tvisqol.visqol(deg, ref, SR, speech=speech)
        want = jvisqol.visqol(deg, ref, SR, speech=speech)
        assert np.allclose(got, want, rtol=0, atol=1e-12), (got, want)
    for v in (0.0, 0.3, 0.7, 0.95, 1.2):
        assert abs(tvisqol.nsim_to_mos(v) - jvisqol.nsim_to_mos(v)) <= 1e-12
    pairs = [(0.2, 1.1), (0.5, 2.4), (0.5, 2.0), (0.8, 3.9), (0.7, 4.2)]
    assert tvisqol.fit_nsim_mos(pairs) == jvisqol.fit_nsim_mos(pairs)


@pytest.mark.parametrize("loss", ["SISDRLossFramewise", "L1LossFramewise",
                                  "MelSpectrogramLossFramewise"])
def test_framewise_losses_match_jax(loss):
    rng = np.random.RandomState(7)
    y = np.stack([_music(2048 / SR, s) for s in (1, 2)])[:, None].astype(np.float32)
    x = (y + 0.1 * rng.randn(*y.shape)).astype(np.float32)
    got = getattr(tlosses, loss)()(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    want = np.asarray(getattr(jlosses, loss)()(jnp.asarray(x), jnp.asarray(y)))
    assert got.shape == want.shape == (2, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


TINY_YML = """\
$include:
  - conf/vrvq/vrvq_a2.yml
DAC_VRVQ.encoder_dim: 8
DAC_VRVQ.decoder_dim: 128
DAC_VRVQ.n_codebooks: 4
DAC_VRVQ.codebook_size: 64
MelSpectrogramLoss.n_mels: [40, 20]
MelSpectrogramLoss.window_lengths: [512, 256]
MelSpectrogramLoss.mel_fmin: [0, 0]
MelSpectrogramLoss.mel_fmax: [null, null]
MultiScaleSTFTLoss.window_lengths: [512, 256]
"""


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny yml, jittered JAX parameters exported as a reference-layout
    checkpoint, and a folder of one 0.5 s wav and one 0.5 s flac named by
    class."""
    root = tmp_path_factory.mktemp("eval")
    (root / "tiny.yml").write_text(TINY_YML)
    jcfg = jax_parse_args(["--args.load", str(root / "tiny.yml")], base_dir=REPO)
    jm = JaxDAC(**jcfg.kwargs("DAC_VRVQ"))
    params = jax.jit(lambda r: jm.init(r, jnp.zeros((1, 1, 4096)), level=1.0))(
        {"params": jax.random.PRNGKey(0), "vbr": jax.random.PRNGKey(1),
         "vbr_dropout": jax.random.PRNGKey(2)})
    params = jitter(jax.tree_util.tree_map(np.asarray, params), 3)
    torch.save({"state_dict": {k: torch.tensor(v) for k, v in
                               export_torch_state_dict(params).items()}},
               root / "weights.pth")
    data = root / "clips"
    data.mkdir()
    write_wav(data / "split_0000_speech.wav", _music(0.5, 8)[None], SR)
    pcm = np.round(np.clip(_music(0.5, 9), -1, 1) * 32767).astype(np.int64)[None]
    (data / "split_0001_music+noise.flac").write_bytes(
        encode_flac(pcm, SR, block_size=1024, subframe_kind="lpc", order=2))
    long_pcm = np.round(np.clip(_music(1.2, 10), -1, 1) * 32767).astype(np.int64)[None]
    (root / "stream.flac").write_bytes(
        encode_flac(long_pcm, SR, block_size=1024, subframe_kind="fixed", order=2))
    return root


def _argv(tiny, fast, out, *extra):
    return ["--args.load", str(tiny / "tiny.yml"), "--torch_ckpt",
            str(tiny / "weights.pth"), "--data_dir", str(tiny / "clips"),
            "--num_examples", "2", "--duration", "0.5", "--levels", "0.5,1.5",
            "--visqol", "1", "--fast", str(fast), "--out", str(out), *extra]


def _jax_evaluate(argv):
    spec = importlib.util.spec_from_file_location("jax_evaluate", REPO / "scripts" / "evaluate.py")
    module = importlib.util.module_from_spec(spec)
    cache = jax.config.jax_compilation_cache_dir
    spec.loader.exec_module(module)  # it points JAX's cache at the repo's
    try:
        return module.evaluate(jax_parse_args(argv, base_dir=REPO))
    finally:
        jax.config.update("jax_compilation_cache_dir", cache)


@pytest.fixture(scope="module")
def reports(tiny):
    out = {}
    for fast in (0, 1):
        t = cli_eval.main(_argv(tiny, fast, tiny / f"t{fast}.json", "--device", "cpu"))
        j = _jax_evaluate(_argv(tiny, fast, tiny / f"j{fast}.json"))
        assert json.loads((tiny / f"t{fast}.json").read_text()) == t
        out[fast] = (t, j)
    return out


def _compare(t, j, bars):
    assert t.keys() == j.keys()
    assert t["num_examples"] == j["num_examples"] == 2
    assert t["codebook_entropy_bits"] == j["codebook_entropy_bits"]
    assert t["codebook_usage_pct"] == j["codebook_usage_pct"]
    assert t["levels"].keys() == j["levels"].keys() == {"level_2.00", "level_6.00"}
    for level, stats in t["levels"].items():
        want = j["levels"][level]
        assert stats.keys() == want.keys()
        assert stats["kbps"] == want["kbps"] and stats["bpf"] == want["bpf"]
        for m, (rtol, atol) in bars.items():
            np.testing.assert_allclose(stats[m]["mean"], want[m]["mean"],
                                       rtol=rtol, atol=atol, err_msg=f"{level} {m}")
    assert t["per_class_top_level"].keys() == {"speech", "music", "noise"}
    assert t["per_class_top_level"].keys() == j["per_class_top_level"].keys()
    for cls, ms in t["per_class_top_level"].items():
        assert ms["kbps"] == j["per_class_top_level"][cls]["kbps"]


METRICS = ("SI-SDR", "SDR", "SI-SNR", "SNR", "L1", "mel", "stft", "ViSQOL",
           "ViSQOL-MOS")


def test_cli_evaluate_matches_jax_exact_profile(reports):
    t, j = reports[0]
    _compare(t, j, {m: (1e-3, 0.0) for m in METRICS})
    np.testing.assert_allclose(t["imp_map_energy_corr"]["mean"],
                               j["imp_map_energy_corr"]["mean"], rtol=1e-3)
    for cls, ms in t["per_class_top_level"].items():
        for m, v in ms.items():
            np.testing.assert_allclose(v["mean"], j["per_class_top_level"][cls][m]["mean"],
                                       rtol=1e-3, err_msg=f"{cls} {m}")


def test_cli_evaluate_matches_jax_fast_profile(reports):
    t, j = reports[1]
    si, db = (0.0, 2.0), (0.0, 0.05)
    _compare(t, j, {"SI-SDR": si, "SI-SNR": si, "SDR": db, "SNR": db,
                    "L1": (1e-3, 0.0), "mel": (0.01, 0.0), "stft": (0.01, 0.0),
                    "ViSQOL": (0.0, 0.005), "ViSQOL-MOS": (0.0, 0.005)})


@pytest.mark.parametrize("levels,want", [
    ("0.5,1", [0.5, 1.0]), (2, [2.0]), ([1, 1.5], [1.0, 1.5]), (0.5, [0.5])])
def test_levels_parse_as_jax_does(levels, want):
    assert cli_eval.parse_levels(levels) == want


@pytest.mark.parametrize("levels", [None, True, {"a": 1}])
def test_levels_errors_as_jax(levels):
    with pytest.raises(ValueError, match="levels must be a number"):
        cli_eval.parse_levels(levels)


@pytest.mark.parametrize("extra", [[], ["--fused_quantizer", "1", "--entropy", "1"]])
def test_cli_stream_demo_writes_the_input_length(tiny, extra):
    out = tiny / f"stream{len(extra)}.wav"
    res = cli_stream.main(["--args.load", str(tiny / "tiny.yml"), "--torch_ckpt",
                           str(tiny / "weights.pth"), "--input", str(tiny / "stream.flac"),
                           "--output", str(out), "--device", "cpu", *extra])
    audio, sr = read_audio(out)
    source, _ = read_audio(tiny / "stream.flac")
    assert sr == SR and audio.shape == source.shape == (1, int(1.2 * SR))
    assert res["samples"] == source.shape[-1] and res["kbps"] > 0
    assert np.isfinite(audio).all() and np.abs(audio).max() > 0


@pytest.mark.parametrize("cli", ["evaluate", "stream_demo"])
def test_clis_run_on_the_card_by_default(tiny, cli, tmp_path):
    """No ``--device``: the card, and without CUDA an error, never the CPU."""
    if torch.cuda.is_available():
        pytest.skip("held on the card by tests/test_torch_cuda.py")
    argv = (_argv(tiny, 0, tmp_path / "e.json") if cli == "evaluate" else
            ["--args.load", str(tiny / "tiny.yml"), "--input", str(tiny / "stream.flac"),
             "--output", str(tmp_path / "o.wav")])
    main = cli_eval.main if cli == "evaluate" else cli_stream.main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)
    assert not (tmp_path / "e.json").exists() and not (tmp_path / "o.wav").exists()
