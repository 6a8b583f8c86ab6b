"""Several iterations of the port's ``train()`` against the JAX package's
``train()``, from the same parameters and the same draws: the loop across
steps (which items each batch holds, the optimizers' counts, the learning
rate's schedule, validation between steps) and the updates it compounds.

The small configuration of ``tests/test_torch_train_step.py`` (encoder 16
with rates 2/4/8, decoder 128 with rates 8/4/2, 4 codebooks of 64 x 4,
``quantizer_dropout 0.25``, ``full_codebook_rate 0.25``; MPD periods 2 and 3,
one MRD of 512) with one mel and one STFT scale of 512, on the flagship's
data and optimizer keys, with ``split_train_step: true`` as the synth demo
trains, batch 4, ``num_iters`` 3 and ``valid_freq`` 2 (validations after
iterations 0 and 2), over six seeded 1 s wavs. Each package's own
``train()`` runs; JAX initializes, and the port's ``load`` is wrapped to
start from the JAX parameters carried across with ``convert``. The level and
depth draws are pinned, every step: JAX's samplers as ``pin_jax_draws``
does, the port's through its step's ``levels=`` / ``depths=``. Nothing of
the JAX package is changed; the JAX steps are jitted by its trainer.

Bars after the 3 iterations: the item indices of every batch equal; the
step and both optimizers' update counts equal; the learning rate of the
last update and of the next within 1e-7 relative; the val mel of each
validation within 1e-4 relative; every parameter leaf of both networks
within 1e-3 relative L2, the one-step bar of 1e-4 compounded over three
updates. Measured on the CPU: the val mel 9.0e-6 and 3.4e-6 relative apart;
the median leaf 5.5e-7 (generator) and 2.3e-7 (discriminator) relative L2,
the largest 5.6e-4 and 4.9e-4, both biases that start at zero (a
quantizer's out-projection, an MRD band conv), where Adam's first updates
are about +-lr wherever the gradient is near zero.
"""

import threading

import numpy as np
import pytest
import torch

import jax

from vrvq_tpu.config import Config as JConfig
from vrvq_tpu.train import trainer as jtrainer
from vrvq_tpu.train.schedule import exponential_lr as j_exponential_lr
import vrvq_tpu_torch as port
from vrvq_tpu_torch.convert import discriminator_state_dict_from_jax, state_dict_from_jax
from vrvq_tpu_torch.train import trainer as ttrainer
from tests.test_torch_support import own_loudness_meters
from tests.test_torch_train_step import BS, DEPTHS, SMALL, U, pin_jax_draws

torch.set_num_threads(1)

ITERS = 3
N_WAVS = 6


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("wavs")
    for i in range(N_WAVS):
        port.Signal(port.synthetic_clip(1.0, 44100, 200 + i), 44100).write(
            root / f"clip_{i}.wav")
    return root


def _cfg(wav_dir) -> dict:
    cfg = port.config.Config.load(port.config.FLAGSHIP_YAML,
                                  base_dir=port.config.REPO).to_dict()
    cfg.update({f"DAC_VRVQ.{k}": list(v) if isinstance(v, tuple) else v
                for k, v in SMALL.items()})
    cfg.update({
        "Discriminator.periods": [2, 3], "Discriminator.fft_sizes": [512],
        "MultiScaleSTFTLoss.window_lengths": [512],
        "MelSpectrogramLoss.n_mels": [40], "MelSpectrogramLoss.window_lengths": [512],
        "MelSpectrogramLoss.mel_fmin": [0], "MelSpectrogramLoss.mel_fmax": [None],
        "train/build_dataset.folders": {"music": [str(wav_dir)]},
        "val/build_dataset.folders": {"music": [str(wav_dir)]},
        "train/AudioDataset.duration": 0.1, "val/AudioDataset.duration": 0.1,
        "val/AudioDataset.n_examples": 4, "batch_size": BS, "val_batch_size": 4,
        "split_train_step": True, "num_iters": ITERS, "valid_freq": 2,
        "save_iters": [], "sample_freq": 1000, "val_idx": [], "num_workers": 2,
    })
    return cfg


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / max(np.linalg.norm(np.asarray(b)), 1e-30))


def _counts(opt_state) -> list:
    """Every ``count`` leaf of an optax state (the clip's and AdamW's)."""
    return [int(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(opt_state)[0]
            if "count" in jax.tree_util.keystr(path)]


def _port_patches(mp, init, items: list) -> None:
    """The port's ``train()`` from the JAX parameters ``init``, its steps on
    the pinned draws, each train batch's item indices appended to ``items``."""
    gp, dp = init
    real_load, real_prepare, real_build = (ttrainer.load, ttrainer.prepare_audio,
                                           ttrainer.build_dataset)
    val_sets = []

    def load(*args, **kwargs):
        state = real_load(*args, **kwargs)
        ts = state.train_state
        ts.generator.load_state_dict(state_dict_from_jax(gp), strict=True)
        ts.discriminator.load_state_dict(discriminator_state_dict_from_jax(dp), strict=True)
        step = state.train_step
        levels = ts.generator.quantizer.random_levels(torch.from_numpy(U))
        state.train_step = lambda train_state, audio, generator=None: step(
            train_state, audio, levels=levels, depths=DEPTHS)
        return state

    def build_dataset(cfg, sample_rate, scope):
        dataset = real_build(cfg, sample_rate, scope)
        if scope == "val":
            val_sets.append(dataset)
        return dataset

    def prepare_audio(dataset, batch, device):
        if not any(dataset is v for v in val_sets):
            items.append(np.asarray(batch["idx"]).tolist())
        return real_prepare(dataset, batch, device)

    mp.setattr(ttrainer, "load", load)
    mp.setattr(ttrainer, "build_dataset", build_dataset)
    mp.setattr(ttrainer, "prepare_audio", prepare_audio)


@pytest.fixture(scope="module")
def runs(wav_dir, tmp_path_factory):
    """Both trainers' 3 iterations: the JAX state, its initial parameters
    and its batches' items; the port's state and its batches' items. The
    port trains in a thread started as soon as JAX's parameters exist, while
    JAX compiles its steps."""
    own_loudness_meters()
    cfg = _cfg(wav_dir)
    root = tmp_path_factory.mktemp("runs")
    jax_side, port_side = {"items": []}, {"items": []}
    mp, port_mp = pytest.MonkeyPatch(), pytest.MonkeyPatch()
    real_load, real_prepare = jtrainer.load, jtrainer._prepare_signal

    def port_train():
        try:
            port_side["state"] = ttrainer.train(dict(cfg), str(root / "port"),
                                                device="cpu")
        except BaseException as exc:  # raised again in the fixture
            port_side["error"] = exc

    def jload(*args, **kwargs):
        state = real_load(*args, **kwargs)
        # the trainer donates the state to its step: keep copies
        jax_side["init"] = jax.tree_util.tree_map(
            np.array, (state.train_state.gen_params, state.train_state.disc_params))
        jax_side["state"] = state
        _port_patches(port_mp, jax_side["init"], port_side["items"])
        port_side["thread"] = threading.Thread(target=port_train)
        port_side["thread"].start()
        return state

    def jprepare(state, batch):
        jax_side["items"].append(np.asarray(batch["idx"]).tolist())
        return real_prepare(state, batch)

    try:
        pin_jax_draws(mp)
        mp.setattr(jtrainer, "load", jload)
        mp.setattr(jtrainer, "_prepare_signal", jprepare)
        jtrainer.train(JConfig(dict(cfg)), save_path=str(root / "jax"))
    finally:
        mp.undo()
        if "thread" in port_side:
            port_side["thread"].join(timeout=600)
        port_mp.undo()
    if "error" in port_side:
        raise port_side["error"]
    assert not port_side["thread"].is_alive(), "the port's train() did not finish"
    return {"jax": jax_side, "port": port_side["state"],
            "port_items": port_side["items"], "cfg": cfg}


def test_batches_hold_the_same_items(runs):
    jitems = runs["jax"]["items"]
    assert len(jitems) == len(runs["port_items"]) == ITERS
    assert runs["port_items"] == jitems
    assert jitems[0] == list(range(BS)) and jitems[1] == list(range(BS, 2 * BS))


def test_step_counts_and_learning_rate_match_jax(runs):
    jstate = runs["jax"]["state"].train_state
    ts = runs["port"].train_state
    assert int(jstate.step) == ts.step == ITERS
    for opt, jopt in ((ts.opt_g, jstate.opt_g), (ts.opt_d, jstate.opt_d)):
        counts = _counts(jopt)
        assert counts and all(c == ITERS for c in counts), counts
        assert opt.count == ITERS
        cfg = runs["cfg"]
        schedule = j_exponential_lr(cfg["AdamW.lr"], cfg["ExponentialLR.gamma"], 0)
        # the rate of the last update, and of the next
        last = opt.adamw.param_groups[0]["lr"]
        np.testing.assert_allclose(last, float(schedule(counts[0] - 1)), rtol=1e-7)
        np.testing.assert_allclose(opt.schedule(opt.count), float(schedule(counts[0])),
                                   rtol=1e-7)


def test_validation_mel_matches_jax(runs):
    jval = runs["jax"]["state"].tracker.history["val"]
    tval = runs["port"].tracker.history["val"]
    assert [v["step"] for v in jval] == [v["step"] for v in tval] == [0, ITERS - 1]
    for j, t in zip(jval, tval):
        np.testing.assert_allclose(t["mel/loss"], j["mel/loss"], rtol=1e-4)


@pytest.mark.parametrize("net", ["generator", "discriminator"])
def test_parameters_after_three_iterations_match_jax(runs, net):
    jstate = runs["jax"]["state"].train_state
    ts = runs["port"].train_state
    if net == "generator":
        module = ts.generator
        want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.gen_params))
        start = state_dict_from_jax(runs["jax"]["init"][0])
    else:
        module = ts.discriminator
        want = discriminator_state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, jstate.disc_params))
        start = discriminator_state_dict_from_jax(runs["jax"]["init"][1])
    moved = 0
    for name, p in module.named_parameters():
        got = p.detach().numpy()
        assert _rel_l2(got, want[name].numpy()) <= 1e-3, name
        moved += not np.array_equal(got, start[name].numpy())
    assert moved == len(list(module.parameters()))  # every leaf was updated
