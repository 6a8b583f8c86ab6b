"""The port's training step sums in a fixed order: the ops that replace
CUDA's atomic adds, against what they replace and against the JAX package.

* ``ops/stft.reflect_pad`` equals ``F.pad(mode="reflect")`` bit for bit, in
  value and in gradient, at the STFT's, MRD's and MPD's pads;
* ``ops/stft.istft`` (an overlap-add of shifted views) within rtol 1e-5
  (atol 1e-5 of the signal's scale) of JAX's ``istft`` (a scatter-add), as
  ``test_torch_train_losses.py`` holds the rest of the spectral ops, and
  ``ShiftPhase`` on a batch within 1e-5 of JAX's transform, as
  ``test_torch_trainer.py`` holds the transformed batch;
* the train and validation steps run cuDNN's deterministic algorithms,
  not its timed choice, and leave the process's flags as they were;
* a small step runs under ``torch.use_deterministic_algorithms(True)`` and
  gives the bits it gives without it.

Small sizes: seeded numpy inputs, JAX calls jitted.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from vrvq_tpu.data import transforms as jtransforms
from vrvq_tpu.ops import stft as jstft
import vrvq_tpu_torch as port
from vrvq_tpu_torch.data import transforms as ttransforms
from vrvq_tpu_torch.ops import stft as tstft
from vrvq_tpu_torch.train import trainer

torch.set_num_threads(1)


def _audio(seed, shape):
    return (0.3 * np.random.RandomState(seed).randn(*shape)).astype(np.float32)


def _close(got, want, rtol=1e-5, scale_atol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=scale_atol * float(np.max(np.abs(want))))


# (length, left, right): the STFT's centre pad at 2048 and 512, MRD's
# match_stride pads at 2048 (768 a side, up to a hop more on the right), and
# MPD's (0, period - T % period) at the flagship's periods
PADS = [(16758, 1024, 1024), (16758, 256, 256), (16758, 768, 768 + 266),
        (16384, 768, 768)] + [(16758, 0, p - 16758 % p) for p in (2, 3, 5, 7, 11)]


@pytest.mark.parametrize("length,left,right", PADS)
def test_reflect_pad_equals_f_pad_bit_for_bit(length, left, right):
    x = torch.from_numpy(_audio(length + right, (3, 1, length))).requires_grad_(True)
    want = F.pad(x, (left, right), mode="reflect")
    got = tstft.reflect_pad(x, left, right)
    assert torch.equal(got, want)
    g = torch.from_numpy(_audio(left, tuple(want.shape)))
    (want_grad,) = torch.autograd.grad(want, x, g)
    (got_grad,) = torch.autograd.grad(got, x, g)
    assert torch.equal(got_grad, want_grad)


def test_reflect_pad_as_long_as_its_input_raises():
    with pytest.raises(ValueError, match="less than"):
        tstft.reflect_pad(torch.zeros(1, 4), 4, 0)


@pytest.mark.parametrize("window,hop", [(2048, 512), (512, 128), (300, 128)])
def test_istft_overlap_add_matches_jax(window, hop):
    x = _audio(window, (2, 1, 6000))
    spec = np.array(jax.jit(lambda a: jstft.stft(a, window, hop))(jnp.asarray(x)))
    want = jax.jit(lambda s: jstft.istft(s, window, hop, x.shape[-1]))(jnp.asarray(spec))
    got = tstft.istft(torch.from_numpy(spec), window, hop, x.shape[-1])
    _close(got.numpy(), want)
    _close(got.numpy(), x)  # and it inverts


def test_overlap_add_sums_frames_at_their_offsets():
    frames = torch.arange(3 * 5, dtype=torch.float32).reshape(3, 5)
    want = torch.zeros(5 + 2 * 2)
    for f in range(3):
        want[2 * f:2 * f + 5] += frames[f]
    assert torch.equal(tstft.overlap_add(frames, 2), want)


def test_shift_phase_on_a_batch_matches_jax():
    audio = _audio(7, (4, 1, 16758))
    shift = np.random.RandomState(8).uniform(-np.pi, np.pi, 4).astype(np.float32)
    args = {"ShiftPhase": {"shift": shift, "mask": np.array([1, 1, 0, 1], np.float32)}}
    jax_args = jax.tree_util.tree_map(jnp.asarray, args)
    want = jax.jit(lambda a, kw: jtransforms.ShiftPhase()(a, **kw))(jnp.asarray(audio),
                                                                    jax_args)
    got = ttransforms.ShiftPhase()(torch.from_numpy(audio), **args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), audio[2])  # masked off


def _tiny_cfg(wav_dir):
    cfg = port.config.Config.load(port.config.FLAGSHIP_YAML,
                                  base_dir=port.config.REPO).to_dict()
    cfg.update({
        "DAC_VRVQ.encoder_dim": 8, "DAC_VRVQ.encoder_rates": [2, 4, 8],
        "DAC_VRVQ.decoder_dim": 32, "DAC_VRVQ.decoder_rates": [8, 4, 2],
        "DAC_VRVQ.n_codebooks": 4, "DAC_VRVQ.codebook_size": 16,
        "DAC_VRVQ.codebook_dim": 4, "DAC_VRVQ.quantizer_dropout": 0.25,
        "Discriminator.periods": [2], "Discriminator.fft_sizes": [512],
        "MultiScaleSTFTLoss.window_lengths": [512],
        "MelSpectrogramLoss.n_mels": [40], "MelSpectrogramLoss.window_lengths": [512],
        "MelSpectrogramLoss.mel_fmin": [0], "MelSpectrogramLoss.mel_fmax": [None],
        "train/build_dataset.folders": {"music": [str(wav_dir)]},
        "val/build_dataset.folders": {"music": [str(wav_dir)]},
        "train/AudioDataset.duration": 0.1, "val/AudioDataset.duration": 0.1,
        "batch_size": 4, "val_batch_size": 4,
    })
    return cfg


@pytest.fixture(scope="module")
def tiny_cfg(tmp_path_factory):
    root = tmp_path_factory.mktemp("wavs")
    for i in range(2):
        port.Signal(port.synthetic_clip(1.0, 44100, 200 + i), 44100).write(
            root / f"clip_{i}.wav")
    return _tiny_cfg(root)


def _flags():
    cudnn = torch.backends.cudnn
    return cudnn.deterministic, cudnn.benchmark


def _step(cfg, tmp_path, seen=None):
    """Step 0 of a state built by ``trainer.load`` alone (a rank's): its
    metrics and parameters after it; with ``seen`` the cuDNN flags at each
    generator forward."""
    state = trainer.load(cfg, trainer.Tracker(), tmp_path, device="cpu")
    ts = state.train_state
    if seen is not None:
        ts.generator.register_forward_pre_hook(lambda *_: seen.append(_flags()))
    batch = trainer.load_batch(state.train_data, 0, int(cfg["batch_size"]))
    audio = trainer.prepare_audio(state.train_data, batch, state.device)
    metrics = state.train_step(ts, audio,
                               generator=trainer.step_generator(0, 0, state.device))
    if seen is not None:
        state.val_step(ts.generator, audio)
    return metrics, [p.detach().clone() for m in (ts.generator, ts.discriminator)
                     for p in m.parameters()]


def test_a_step_runs_under_deterministic_algorithms(tiny_cfg, tmp_path):
    """The train and validation steps run with cuDNN's deterministic
    algorithms, chosen by its heuristics (``benchmark`` off), and TF32 off,
    and leave the process's flags as they were (serving keeps cuDNN's own
    choice). The whole step, transforms included, then runs under PyTorch's
    deterministic mode: nothing raises, and the metrics and parameters are
    the bits of the step without it."""
    seen, saved = [], _flags()
    try:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, True
        want_metrics, want_params = _step(tiny_cfg, tmp_path / "a", seen)
        assert not torch.backends.cudnn.allow_tf32
        assert len(seen) == 2 and set(seen) == {(True, False)}
        assert _flags() == (False, True)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    try:
        torch.use_deterministic_algorithms(True)
        metrics, params = _step(tiny_cfg, tmp_path / "b")
    finally:
        torch.use_deterministic_algorithms(False)
    assert {k: v.item() for k, v in metrics.items()} == {
        k: v.item() for k, v in want_metrics.items()}
    assert all(torch.isfinite(v) for v in metrics.values())
    assert len(params) == len(want_params)
    assert all(torch.equal(p, q) for p, q in zip(params, want_params))
