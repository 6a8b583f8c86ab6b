"""The port's trainer on the CPU: ``train()`` over seeded wavs with tagged
checkpoints, a resumed run bit for bit equal to an uninterrupted one, the
clobber guard, and the data pipeline's draws equal to the JAX package's.

A small model (encoder 16 with rates 2/4/8, decoder 128, 4 codebooks of
64 x 4) and discriminator (MPD 2 and 3, one MRD of 512) keep each step well
under a second; clips of 0.1 s from four seeded 1 s wavs.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from vrvq_tpu.data import loaders as jloaders
from vrvq_tpu.data import transforms as jtransforms
import vrvq_tpu_torch as port
from vrvq_tpu_torch.data import loaders as tloaders
from vrvq_tpu_torch.data import transforms as ttransforms
from vrvq_tpu_torch.train import checkpoint as ckpt
from vrvq_tpu_torch.train.trainer import train

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("wavs")
    for i in range(4):
        port.Signal(port.synthetic_clip(1.0, 44100, 100 + i), 44100).write(
            root / f"clip_{i}.wav")
    return root


def _cfg(wav_dir, **over):
    cfg = port.config.Config.load(port.config.FLAGSHIP_YAML,
                                  base_dir=port.config.REPO).to_dict()
    cfg.update({
        "DAC_VRVQ.encoder_dim": 16, "DAC_VRVQ.encoder_rates": [2, 4, 8],
        "DAC_VRVQ.decoder_dim": 128, "DAC_VRVQ.decoder_rates": [8, 4, 2],
        "DAC_VRVQ.n_codebooks": 4, "DAC_VRVQ.codebook_size": 64,
        "DAC_VRVQ.codebook_dim": 4, "DAC_VRVQ.quantizer_dropout": 0.25,
        "Discriminator.periods": [2, 3], "Discriminator.fft_sizes": [512],
        "MultiScaleSTFTLoss.window_lengths": [512],
        "MelSpectrogramLoss.n_mels": [40], "MelSpectrogramLoss.window_lengths": [512],
        "MelSpectrogramLoss.mel_fmin": [0], "MelSpectrogramLoss.mel_fmax": [None],
        "train/build_dataset.folders": {"music": [str(wav_dir)]},
        "val/build_dataset.folders": {"music": [str(wav_dir)]},
        "train/AudioDataset.duration": 0.1, "val/AudioDataset.duration": 0.1,
        "val/AudioDataset.n_examples": 4, "batch_size": 4, "val_batch_size": 4,
        "num_iters": 3, "valid_freq": 2, "save_iters": [2],
    })
    cfg.update(over)
    return cfg


def test_train_writes_tagged_checkpoints(wav_dir, tmp_path):
    state = train(_cfg(wav_dir), str(tmp_path / "run"), device="cpu")
    run = tmp_path / "run"
    assert state.train_state.step == 3 and len(state.metrics) == 3
    assert all(np.isfinite(v) for m in state.metrics for v in m.values())
    assert {"loss", "mel/loss", "adv/disc_loss", "other/grad_norm_g",
            "other/grad_norm_d", "vq/rate_loss"} <= set(state.metrics[0])
    for tag in ("latest", "best", "0k"):  # save_iters [2] -> 2 // 1000 = 0k
        assert (run / tag / ckpt.STATE_FILE).exists(), tag
    meta = ckpt.load_metadata(run, "latest")
    assert meta["step"] == 3 and meta["tracker"]["history"]["val"]
    assert (run / "log.txt").read_text().count("[val mean]") == 2


def _final_state(path):
    return torch.load(Path(path) / "latest" / ckpt.STATE_FILE, map_location="cpu",
                      weights_only=True)


def _assert_same_bits(a, b, where=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same_bits(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_bits(x, y, f"{where}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert torch.equal(a, b), where
    else:
        assert a == b, where


def test_resume_is_bit_exact(wav_dir, tmp_path):
    """Steps 0..2 in one run against steps 0 then 1..2 resumed from
    ``latest``: every tensor of both networks and both optimizers equal."""
    straight = train(_cfg(wav_dir, valid_freq=100), str(tmp_path / "a"), device="cpu")
    train(_cfg(wav_dir, valid_freq=100, num_iters=1), str(tmp_path / "b"), device="cpu")
    resumed = train(_cfg(wav_dir, valid_freq=100, resume=True), str(tmp_path / "b"),
                    device="cpu")
    assert resumed.metrics == straight.metrics[1:]
    _assert_same_bits(_final_state(tmp_path / "a"), _final_state(tmp_path / "b"))


def test_clobber_guard(wav_dir, tmp_path):
    train(_cfg(wav_dir, num_iters=1), str(tmp_path / "c"), device="cpu")
    with pytest.raises(FileExistsError):
        train(_cfg(wav_dir, num_iters=1), str(tmp_path / "c"), device="cpu")
    train(_cfg(wav_dir, num_iters=1, overwrite_ok=True), str(tmp_path / "c"),
          device="cpu")


def test_train_on_the_card_without_cuda_raises(wav_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: train() would run there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(_cfg(wav_dir), str(tmp_path / "d"))


def _datasets(wav_dir, pkg_loaders, pkg_transforms):
    transform = pkg_transforms.build_transform(
        augment_prob=0.5, preprocess=["Identity"], augment=["Identity"],
        postprocess=["RescaleAudio", "ShiftPhase"])
    loader = pkg_loaders.AudioLoader(sources=[str(wav_dir)], shuffle=True)
    return pkg_loaders.AudioDataset(loader, 44100, n_examples=10, duration=0.38,
                                    transform=transform)


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def test_loader_and_transform_draws_match_jax(wav_dir, monkeypatch):
    """Items 0..5: the same file, offset, samples (bit for bit) and
    transform parameters as the JAX package's; the transformed batch
    within 1e-5."""
    # the JAX Signal measures loudness (the salience cutoff) with its numpy
    # meter here, as the port does
    from vrvq_tpu import audio as jaudio
    from vrvq_tpu.ops.loudness import integrated_loudness

    monkeypatch.setattr(jaudio.Signal, "loudness", lambda self, *a, **k: np.maximum(
        integrated_loudness(np.asarray(self.audio_data, np.float64),
                            self.sample_rate), -70.0).astype(np.float32))
    jds = _datasets(wav_dir, jloaders, jtransforms)
    tds = _datasets(wav_dir, tloaders, ttransforms)
    jitems = [jds[i] for i in range(6)]
    titems = [tds[i] for i in range(6)]
    for ji, ti in zip(jitems, titems):
        assert ji["path"] == ti["path"]
        assert ji["signal"].metadata["offset"] == ti["signal"].metadata["offset"]
        np.testing.assert_array_equal(np.asarray(ji["signal"].audio_data),
                                      ti["signal"].audio_data)
        jargs, targs = dict(_leaves(ji["transform_args"])), dict(_leaves(ti["transform_args"]))
        assert jargs.keys() == targs.keys()
        for k in jargs:
            np.testing.assert_array_equal(jargs[k], targs[k], err_msg=k)
    jbatch, tbatch = jds.collate(jitems), tds.collate(titems)
    want = jtransforms.apply_on_host(jds.transform, jbatch["signal"],
                                     jbatch["transform_args"]).audio_data
    got = tds.transform(torch.from_numpy(tbatch["signal"].audio_data),
                        **tbatch["transform_args"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
