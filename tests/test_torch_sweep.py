"""The port's level sweep and resampling against the JAX package's
(``vrvq_tpu/infer/sweep.py``, ``vrvq_tpu/ops/resample.py``), at the sizes of
``tests/test_chunked.py``'s sweep test (encoder 8, decoder 64, 4 codebooks of
32 x 4) on jittered JAX parameters.

Masks, bits per frame and kbps equal JAX's exactly (the masks are compares of
an importance map that agrees to float32 rounding, and the bits are sums of
whole numbers); audio within rtol 1e-3 / atol 1e-4 (the port's decode
tolerance); the batched sweep within 1e-5 of the sequential one (the JAX
bound); resampling bit-identical (the same scipy call).
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vrvq_tpu.infer.sweep import LevelSweep as JaxSweep
from vrvq_tpu.ops.resample import resample_poly_np as jax_resample
import vrvq_tpu_torch as port
from vrvq_tpu_torch.convert import state_dict_from_jax
from vrvq_tpu_torch.infer import fast, sweep
from vrvq_tpu_torch.metrics import cal_bpf_from_mask
from vrvq_tpu_torch.ops.resample import resample_poly_np
from tests.test_torch_support import jax_model_and_params, jnp_tree

SIZES = dict(encoder_dim=8, decoder_dim=64, codebook_size=32)
LEVELS = [0.2, 1.0, 3.0]


@pytest.fixture(scope="module")
def sweeps():
    jm, params = jax_model_and_params(0, **SIZES)
    tm = port.build_model(port.small_config(**SIZES), device="cpu",
                          state_dict=state_dict_from_jax(params))
    rng = np.random.RandomState(5)
    audio = (rng.randn(1, 1, 40 * tm.hop_length) * 0.3).astype(np.float32)
    jsweep = JaxSweep(jm, jnp_tree(params))
    return jsweep, sweep.LevelSweep(tm), audio


@pytest.mark.parametrize("batched", [False, True], ids=["sequential", "batched"])
def test_sweep_matches_jax(sweeps, batched):
    jsweep, tsweep, audio = sweeps
    jres = jsweep.sweep(jnp.asarray(audio), LEVELS, batched=batched)
    tres = tsweep.sweep(torch.from_numpy(audio), LEVELS, batched=batched)
    for lv in LEVELS:
        np.testing.assert_array_equal(tres[lv]["mask"].numpy(),
                                      np.asarray(jres[lv]["mask"]))
        assert tres[lv]["bpf"] == jres[lv]["bpf"]
        assert tres[lv]["kbps"] == jres[lv]["kbps"]
        np.testing.assert_allclose(tres[lv]["audio"].numpy(),
                                   np.asarray(jres[lv]["audio"]),
                                   rtol=1e-3, atol=1e-4)
    bpfs = [tres[lv]["bpf"] for lv in LEVELS]
    assert bpfs == sorted(bpfs) and bpfs[0] < bpfs[-1]


def test_sweep_batched_matches_sequential(sweeps):
    _, tsweep, audio = sweeps
    x = torch.from_numpy(audio)
    enc = tsweep.encode(x)
    seq = tsweep.sweep(x, LEVELS, enc=enc)
    bat = tsweep.sweep(x, LEVELS, batched=True, enc=enc)
    for lv in LEVELS:
        assert torch.equal(bat[lv]["mask"], seq[lv]["mask"])
        assert bat[lv]["bpf"] == pytest.approx(seq[lv]["bpf"])
        assert (bat[lv]["audio"] - seq[lv]["audio"]).abs().max() < 1e-5


def test_sweep_windows_past_the_one_shot_limit(sweeps, monkeypatch):
    """Past the frame-batch limit the batched sweep decodes in windows."""
    _, tsweep, audio = sweeps
    x = torch.from_numpy(audio)
    one_shot = tsweep.sweep(x, LEVELS, batched=True)
    monkeypatch.setattr(sweep, "ONE_SHOT_FRAME_BATCH", 8)
    windowed = tsweep.sweep(x, LEVELS, batched=True)
    for lv in LEVELS:
        assert (windowed[lv]["audio"] - one_shot[lv]["audio"]).abs().max() < 1e-5


def test_sweep_with_fast_profile(sweeps):
    """The fast profile's sweep: the live model's masks and bits."""
    _, tsweep, audio = sweeps
    x = torch.from_numpy(audio)
    live = tsweep.sweep(x, LEVELS)
    quick = sweep.LevelSweep(fast.make_inference_model(tsweep.model)).sweep(x, LEVELS)
    for lv in LEVELS:
        assert torch.equal(quick[lv]["mask"], live[lv]["mask"])
        assert quick[lv]["bpf"] == live[lv]["bpf"]


@pytest.mark.parametrize("png", [False, True], ids=["json", "json+png"])
def test_save_results(sweeps, tmp_path, png):
    _, tsweep, audio = sweeps
    if png:
        pytest.importorskip("matplotlib")
    meta = sweep.save_results(tsweep.model, torch.from_numpy(audio), LEVELS,
                              str(tmp_path), png=png)
    out = tmp_path / "0"
    assert json.loads((out / "metadata.json").read_text()) == meta
    n_q = tsweep.model.n_codebooks
    for lv in LEVELS:
        entry = meta[f"level_{lv * n_q:.2f}"]
        assert np.isfinite(entry["sisdr"]) and entry["kbps"] > 0
        assert (out / f"recon_{lv * n_q:.2f}.wav").exists()
        assert (out / f"imp_map_{lv * n_q:.2f}.png").exists() == png
    assert (out / "input.wav").exists()


@pytest.mark.parametrize("rates", [(44100, 16000), (16000, 44100),
                                   (48000, 44100), (44100, 44100)])
def test_resample_matches_jax(rates):
    x = np.random.RandomState(0).randn(2, 1, 5000).astype(np.float32)
    got = resample_poly_np(x, *rates)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_resample(x, *rates))


def test_serving_metrics_match_jax():
    """The port's copy of the serving metrics gives the JAX package's
    values (float64 numpy in both; the bits per frame in float32)."""
    from vrvq_tpu import metrics as jmetrics
    from vrvq_tpu_torch import metrics as tmetrics

    rng = np.random.RandomState(0)
    ref = rng.randn(2, 1, 3000).astype(np.float32)
    est = (ref + 0.1 * rng.randn(2, 1, 3000)).astype(np.float32)
    for name in ("si_sdr", "si_snr", "snr"):
        got = getattr(tmetrics, name)(est, ref)
        assert got == pytest.approx(getattr(jmetrics, name)(est, ref), rel=1e-12)
    assert tmetrics.si_sdr(torch.from_numpy(est), torch.from_numpy(ref)) == \
        pytest.approx(jmetrics.si_sdr(est, ref), rel=1e-12)
    codes = rng.randint(0, 32, (2, 4, 50))
    usage = tmetrics.codebook_usage(codes, 32)
    for a, b in zip(usage, jmetrics.codebook_usage(codes, 32)):
        np.testing.assert_array_equal(a, b)
    assert tmetrics.cal_entropy(usage) == jmetrics.cal_entropy(usage)
    mask = (rng.rand(2, 4, 50) > 0.3).astype(np.float32)
    assert cal_bpf_from_mask(mask, [5] * 4) == jmetrics.cal_bpf_from_mask(mask, [5] * 4)
