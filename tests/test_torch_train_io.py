"""The trainer's and the data path's edge in the port against the JAX
package's: the aligned loader, the prefetching batch iterator, TensorBoard
scalars and samples, MSD with the in-graph resample, the exports to the
reference's layout and ``cli.export_torch``, and ``compute_dtype``.

Sizes are small (the codec of ``tests/test_torch_support.py``, clips of
0.1 s). Bars:

  * the aligned ``AudioDataset``: the same aligned file lists and the same
    draws as JAX's, bit for bit;
  * ``BatchPrefetcher``: batches equal to ``load_batch``'s bit for bit, with
    and without a rank's rows; a producer's error raised in the consumer; no
    thread left behind after ``close``, an early return or an error;
  * ``resample`` against ``resample_jax`` within 1e-6 (absolute, on audio of
    amplitude < 1), with equal lengths, at 44100 -> 22050, 14700 and 11025;
  * MSD's feature maps within rtol 1e-5 of JAX's (atol 1e-5 of each map's
    scale), the LSGAN loss's gradients within 1e-3 relative L2 a leaf (the
    bar of ``tests/test_parity_grads.py``), and the ensemble's sub-
    discriminators in JAX's order (MPD, MSD, MRD);
  * the exports key for key and bit for bit against JAX's
    ``export_torch_state_dict`` and ``export_torch_discriminator_state_dict``,
    the round trips through the imports bit-exact; ``cli.export_torch``'s
    file read by JAX's ``load_torch_checkpoint`` to the port's parameters,
    bit for bit;
  * ``compute_dtype: bfloat16`` serving against JAX's bfloat16 model on the
    same parameters: latents within 2e-2 and the decoder's audio within
    3e-2 relative L2 (measured 0.85e-2 and 0.61e-2; both packages compute
    the convolutions and Snake in bfloat16 and round at other places, and
    each package's bfloat16 latents lie ~0.7e-2 off its float32 ones, its
    audio ~1.7e-2), as ``tests/test_torch_encode_dtype.py`` set its bar;
  * the JAX fault: JAX's bfloat16 gradient raises at this config, and the
    port's trainer raises with its message.
"""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_support import JAX_CFG, jitter
from tests.test_torch_trainer import _cfg
from vrvq_tpu.data import loaders as jloaders
from vrvq_tpu.losses.gan import discriminator_loss as j_disc_loss
from vrvq_tpu.models import DAC_VRVQ as JaxDAC
from vrvq_tpu.models import Discriminator as JaxDisc
from vrvq_tpu.ops.resample import resample_jax
from vrvq_tpu.train import checkpoint as jckpt
import vrvq_tpu_torch as port
from vrvq_tpu_torch import convert
from vrvq_tpu_torch.cli import export_torch
from vrvq_tpu_torch.data import loaders as tloaders
from vrvq_tpu_torch.infer.fast import make_inference_model
from vrvq_tpu_torch.losses.gan import discriminator_loss
from vrvq_tpu_torch.models.discriminator import Discriminator
from vrvq_tpu_torch.ops.resample import resample
from vrvq_tpu_torch.train import checkpoint as ckpt
from vrvq_tpu_torch.train import trainer
from vrvq_tpu_torch.train.tracker import Tracker, read_events, when

torch.set_num_threads(1)
SR = 44100


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _write(path, seconds, seed):
    path.parent.mkdir(parents=True, exist_ok=True)
    port.Signal(port.synthetic_clip(seconds, SR, seed), SR).write(path)


# ------------------------------------------------------------ aligned loader
@pytest.fixture(scope="module")
def aligned_root(tmp_path_factory):
    """Two corpora in folders named by piece: ``mix`` has pieces a-d, ``stem``
    lacks b and has an extra e, so alignment inserts and appends
    placeholders."""
    root = tmp_path_factory.mktemp("aligned")
    for i, name in enumerate("abcd"):
        _write(root / "mix" / name / "x.wav", 0.6, 10 + i)
    for i, name in enumerate("acde"):
        _write(root / "stem" / name / "y.wav", 0.6, 20 + i)
    return root


def test_aligned_dataset_matches_jax(aligned_root):
    def build(pkg):
        loaders = {k: pkg.AudioLoader(sources=[str(aligned_root / k)])
                   for k in ("mix", "stem")}
        return pkg.AudioDataset(loaders, SR, n_examples=8, duration=0.1,
                                aligned=True)

    jd, td = build(jloaders), build(tloaders)
    assert tloaders.default_matcher("r/a/x.wav", "q/a/y.wav")
    for key in ("mix", "stem"):
        assert td.loaders[key].audio_lists == jd.loaders[key].audio_lists
    assert td.loaders["stem"].audio_lists[0][1] == {"path": "none"}
    for idx in range(8):
        got, want = td[idx], jd[idx]
        for key in ("mix", "stem"):
            assert got[key]["path"] == want[key]["path"], (idx, key)
            assert (got[key]["source_idx"], got[key]["item_idx"]) == (
                want[key]["source_idx"], want[key]["item_idx"])
            np.testing.assert_array_equal(got[key]["signal"].audio_data,
                                          np.asarray(want[key]["signal"].audio_data))
        # aligned: the stem read the mix's file position and offset
        assert got["stem"]["item_idx"] == got["mix"]["item_idx"]
        if got["stem"]["path"] != "none" and got["mix"]["path"] != "none":
            assert (got["stem"]["signal"].metadata["offset"]
                    == got["mix"]["signal"].metadata["offset"])


# ---------------------------------------------------------------- prefetcher
@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("clips")
    for i in range(3):
        _write(root / f"c{i}.wav", 0.5, 40 + i)
    return tloaders.AudioDataset(tloaders.AudioLoader(sources=[str(root)]), SR,
                                 n_examples=7, duration=0.05)


def _same_batch(a, b):
    np.testing.assert_array_equal(a["signal"].audio_data, b["signal"].audio_data)
    np.testing.assert_array_equal(np.asarray(a["idx"]), np.asarray(b["idx"]))


@pytest.mark.parametrize("rows", [None, [1, 3]], ids=["all", "rank-rows"])
def test_prefetched_batches_equal_load_batch(dataset, rows):
    threads = threading.active_count()
    with trainer.BatchPrefetcher(dataset, 4, start_step=2, num_workers=3,
                                 rows=rows) as batches:
        for want_step in range(2, 6):  # wraps around the 7 items
            step, batch = next(batches)
            assert step == want_step
            _same_batch(batch, trainer.load_batch(dataset, step, 4, rows))
            assert len(batch["idx"]) == (4 if rows is None else 2)
    assert threading.active_count() == threads


class _Failing:
    def __init__(self, fail_at: int):
        self.fail_at = fail_at

    def __len__(self):
        return 100

    def __getitem__(self, i):
        if i == self.fail_at:
            raise RuntimeError(f"synthetic load failure at {i}")
        return {"x": i}

    @staticmethod
    def collate(items):
        return {"xs": [it["x"] for it in items]}


def test_producer_error_reaches_the_consumer():
    threads = threading.active_count()
    batches = trainer.BatchPrefetcher(_Failing(5), batch_size=2, num_workers=2)
    assert next(batches) == (0, {"xs": [0, 1]})
    assert next(batches) == (1, {"xs": [2, 3]})
    with pytest.raises(RuntimeError, match="synthetic load failure at 5"):
        next(batches)
    batches.close()
    assert threading.active_count() == threads


def test_early_close_leaves_no_thread():
    threads = threading.active_count()
    with trainer.BatchPrefetcher(_Failing(-1), batch_size=3,
                                 num_workers=4) as batches:
        assert next(batches)[1] == {"xs": [0, 1, 2]}
    assert threading.active_count() == threads
    with pytest.raises(StopIteration):
        next(batches)


def test_train_closes_its_threads_when_a_step_raises(tmp_path, monkeypatch):
    """The prefetcher's and the writer's threads end when ``train`` raises."""
    wavs = tmp_path / "wavs"
    _write(wavs / "c.wav", 0.5, 1)
    threads = threading.active_count()

    def boom(*args, **kwargs):
        raise RuntimeError("synthetic step failure")

    monkeypatch.setattr(trainer, "make_train_step", lambda *a, **k: boom)
    with pytest.raises(RuntimeError, match="synthetic step failure"):
        trainer.train(_cfg(wavs, num_workers=2), str(tmp_path / "run"), device="cpu")
    assert threading.active_count() == threads


def test_tracker_when_and_timer(tmp_path):
    from tensorboardX import SummaryWriter

    writer = SummaryWriter(logdir=str(tmp_path))
    tracker = Tracker(writer=writer)
    for step in range(3):
        tracker.step = step
        tracker.log_metrics("train", {"loss": float(step), "mel/loss": 2.0 * step})
    assert tracker.done("train") == {"loss": 1.0, "mel/loss": 2.0}
    writer.close()
    events = read_events(tmp_path)
    assert [(s, v) for s, _, v in events["loss/train"]] == [(0, 0.0), (1, 1.0), (2, 2.0)]
    assert events["mel/loss/train"][-1][2] == 4.0
    flag = []
    gated = when(lambda: bool(flag))(lambda: "ran")
    assert gated() is None
    flag.append(1)
    assert gated() == "ran"


# ----------------------------------------- train() with MSD, writer, samples
def test_train_with_msd_writes_scalars_and_samples(tmp_path):
    """One ``train()`` at the small config with MSD at rates 1 and 2,
    prefetched by two workers, samples at every step of two val items."""
    wavs = tmp_path / "wavs"
    for i in range(4):
        _write(wavs / f"c{i}.wav", 1.0, 100 + i)
    cfg = _cfg(wavs, **{"Discriminator.rates": [1, 2], "num_workers": 2,
                        "sample_freq": 1, "val_idx": [0, 1], "num_iters": 2})
    run = tmp_path / "run"
    state = trainer.train(cfg, str(run), device="cpu")
    disc = state.train_state.discriminator
    assert disc.names == ["mpd_2", "mpd_3", "msd_1", "msd_2", "mrd_512"]
    no_grad = [n for n, p in disc.named_parameters()
               if p.grad is None or not bool(torch.count_nonzero(p.grad))]
    assert not no_grad, no_grad
    events = read_events(run / "logs")
    for tag in ("loss/train", "mel/loss/train", "adv/disc_loss/train", "mel/loss/val"):
        assert tag in events, sorted(events)
    assert [s for s, _, _ in events["loss/train"]] == [0, 1]
    for i in range(2):
        images = events[f"imp_map/sample_{i}"]
        assert [(s, k) for s, k, _ in images] == [(0, "image"), (1, "image")]
        # tensorboardX without soundfile: the reconstructions as wav files
        audio = events.get(f"recons/sample_{i}.wav")
        if audio is None:
            for step in range(2):
                assert (run / "logs" / "samples" / f"recons_{step}_{i}.wav").exists()
        else:
            assert [k for _, k, _ in audio] == ["audio", "audio"]


# ------------------------------------------------------------- MSD, resample
@pytest.mark.parametrize("new_sr", [22050, 14700, 11025])
def test_resample_matches_jax(new_sr):
    x = (0.3 * np.random.RandomState(new_sr).randn(2, 3, 3001)).astype(np.float32)
    got = resample(torch.from_numpy(x), SR, new_sr).numpy()
    want = np.asarray(resample_jax(jnp.asarray(x), SR, new_sr))
    assert got.shape == want.shape == (2, 3, int(np.ceil(3001 * new_sr / SR)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def msd_pair():
    jd = JaxDisc(rates=(1, 2), periods=(), fft_sizes=())
    params = jax.jit(jd.init)(jax.random.PRNGKey(3), jnp.zeros((1, 1, 2048)))
    params = jitter(jax.tree_util.tree_map(np.asarray, params), 4)
    td = Discriminator(rates=(1, 2), periods=(), fft_sizes=())
    td.load_state_dict(convert.discriminator_state_dict_from_jax(params), strict=True)
    return jd, jax.tree_util.tree_map(jnp.asarray, params), td


def _audio(seed, n=2, t=2049):
    return (0.2 * np.random.RandomState(seed).randn(n, 1, t)).astype(np.float32)


def test_msd_feature_maps_match_jax(msd_pair):
    jd, params, td = msd_pair
    x = _audio(0)
    with torch.no_grad():
        got = td(torch.from_numpy(x))
    want = jax.jit(jd.apply)(params, jnp.asarray(x))
    assert len(got) == len(want) == 2
    for gd, wd in zip(got, want):
        assert len(gd) == len(wd) == 7
        for g, w in zip(gd, wd):
            w = np.asarray(w).transpose(0, 2, 1)
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                       atol=1e-5 * float(np.abs(w).max()))


def test_msd_gradients_match_jax(msd_pair):
    jd, params, td = msd_pair
    fake, real = _audio(1), _audio(2)
    td.zero_grad()
    loss = discriminator_loss(td(torch.from_numpy(fake)), td(torch.from_numpy(real)))
    loss.backward()
    want, jgrads = jax.jit(jax.value_and_grad(lambda p: j_disc_loss(
        jd.apply(p, jnp.asarray(fake)), jd.apply(p, jnp.asarray(real)))))(params)
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    jsd = convert.discriminator_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in td.named_parameters():
        assert p.grad is not None and torch.count_nonzero(p.grad) > 0, name
        assert _rel_l2(p.grad.numpy(), jsd[name].numpy()) <= 1e-3, name


def _filled(shapes, seed):
    """A parameter tree of ``shapes`` (``jax.eval_shape``'s) filled with
    seeded numpy values."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda s: rng.uniform(-0.5, 0.5, s.shape).astype(np.float32), shapes)


DISC_KW = dict(periods=(2, 3), rates=(1, 2), fft_sizes=(512, 256))


def test_ensemble_order_matches_jax():
    """The sub-discriminators' outputs in JAX's order, by their shapes."""
    jd = JaxDisc(**DISC_KW)
    x = jnp.zeros((1, 1, 3001))
    shapes = jax.eval_shape(jd.init, jax.random.PRNGKey(0), x)
    want = jax.eval_shape(jd.apply, shapes, x)
    td = Discriminator(**DISC_KW)
    convert.init_params(td, torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = td(torch.zeros(1, 1, 3001))
    assert td.names == ["mpd_2", "mpd_3", "msd_1", "msd_2", "mrd_512", "mrd_256"]
    assert len(got) == len(want)
    for gd, wd in zip(got, want):
        for g, w in zip(gd, wd):
            perm = (0, 2, 1) if len(w.shape) == 3 else (0, 3, 1, 2)
            assert tuple(g.shape) == tuple(w.shape[i] for i in perm)


# ------------------------------------------------------------------- exports
def _same(a, b, where=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, where
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), where


@pytest.mark.parametrize("model_type", ["VBR", "CBR"])
def test_generator_export_matches_jax(model_type):
    jm = JaxDAC(**{**JAX_CFG, "model_type": model_type})
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "vbr", "vbr_dropout"))}
    shapes = jax.eval_shape(lambda: jm.init(rngs, jnp.zeros((1, 1, 4096)), level=1.0))
    params = _filled(shapes, 1)
    model = port.build_model(port.small_config(model_type=model_type), device="cpu",
                             state_dict=convert.state_dict_from_jax(params))
    got = convert.state_dict_to_reference(model)
    want = jckpt.export_torch_state_dict(params)
    assert set(got) == set(want)
    for k in want:
        _same(got[k].numpy(), want[k], k)
    # round trips: back into the port, and into JAX's tree
    back = convert.state_dict_from_reference(got, model)
    for k, v in model.state_dict().items():
        _same(back[k].numpy(), v.numpy(), k)
    jtree = jckpt.convert_torch_state_dict({k: v.numpy() for k, v in got.items()})
    jax.tree_util.tree_map(_same, jtree, params)
    with pytest.raises(ValueError, match="folded"):
        convert.state_dict_to_reference(make_inference_model(model))


def test_discriminator_export_matches_jax():
    jd = JaxDisc(**DISC_KW)
    shapes = jax.eval_shape(jd.init, jax.random.PRNGKey(0), jnp.zeros((1, 1, 4096)))
    params = _filled(shapes, 2)
    td = Discriminator(**DISC_KW)
    td.load_state_dict(convert.discriminator_state_dict_from_jax(params), strict=True)
    got = convert.discriminator_state_dict_to_reference(td)
    want = jckpt.export_torch_discriminator_state_dict(params, **DISC_KW)
    assert set(got) == set(want)
    for k in want:
        _same(got[k].numpy(), want[k], k)
    back = convert.discriminator_state_dict_from_reference(got, td)
    for k, v in td.state_dict().items():
        _same(back[k].numpy(), v.numpy(), k)
    jtree = jckpt.convert_torch_discriminator_state_dict(
        {k: v.numpy() for k, v in got.items()}, **DISC_KW)
    jax.tree_util.tree_map(_same, jtree, params)
    with pytest.raises(KeyError, match="missing from the state dict"):
        convert.discriminator_state_dict_from_reference(
            got, Discriminator(**{**DISC_KW, "rates": (1,)}))


SMALL_ARGS = ["--DAC_VRVQ.encoder_dim", "16", "--DAC_VRVQ.n_codebooks", "4",
              "--DAC_VRVQ.codebook_size", "64", "--DAC_VRVQ.codebook_dim", "4",
              "--DAC_VRVQ.decoder_dim", "128"]


def test_cli_export_torch_round_trips(tmp_path):
    """``cli.export_torch`` on a checkpoint of the port's: JAX's
    ``load_torch_checkpoint`` reads the file to the port's parameters, and
    the port's ``--torch_ckpt`` reads it back bit for bit."""
    cfg = port.config.parse_args(["--args.load", port.config.FLAGSHIP_YAML, *SMALL_ARGS],
                                 base_dir=port.config.REPO)
    model = port.build_model(port.config.model_config(cfg), device="cpu", seed=7)
    for p in model.parameters():  # off the init's g = ||v||, zero biases
        p.data.add_(0.01 * torch.randn(p.shape, generator=torch.Generator().manual_seed(1)))
    (tmp_path / "ck" / "latest").mkdir(parents=True)
    torch.save({"generator": model.state_dict()},
               tmp_path / "ck" / "latest" / ckpt.STATE_FILE)
    out = tmp_path / "weights.pth"
    export_torch.main(["--args.load", port.config.FLAGSHIP_YAML, *SMALL_ARGS,
                       "--ckpt_dir", str(tmp_path / "ck"), "--tag", "latest",
                       "--out", str(out), "--device", "cpu"])
    jtree = jckpt.load_torch_checkpoint(out, n_codebooks=4, model_type="VBR")
    for k, v in convert.state_dict_from_jax(jtree).items():
        _same(v.numpy(), model.state_dict()[k].numpy(), k)
    cfg.update({"torch_ckpt": str(out)})
    back = ckpt.load_gen_params(cfg, port.DAC_VRVQ(model.config), device="cpu")
    for k, v in model.state_dict().items():
        _same(back.state_dict()[k].numpy(), v.numpy(), k)


# ------------------------------------------------------------- compute_dtype
@pytest.fixture(scope="module")
def bf16_pair():
    live = port.build_model(port.small_config(), device="cpu", seed=3)
    params = jitter(jckpt.convert_torch_state_dict(
        {k: v.numpy() for k, v in convert.state_dict_to_reference(live).items()}), 5)
    jm = JaxDAC(**{**JAX_CFG, "compute_dtype": "bfloat16"})
    tm = port.build_model(port.small_config(compute_dtype="bfloat16"), device="cpu",
                          state_dict=convert.state_dict_from_jax(params))
    return jm, jax.tree_util.tree_map(jnp.asarray, params), tm


def test_bfloat16_serving_matches_jax(bf16_pair):
    jm, params, tm = bf16_pair
    assert tm.profile.encoder_compute_dtype == tm.profile.decoder_compute_dtype == torch.bfloat16
    assert not tm.profile.encoder_snake_approx and not tm.profile.decoder_snake_approx
    assert all(p.dtype == torch.float32 for p in tm.quantizer.parameters())
    x = (0.3 * np.random.RandomState(1).randn(2, 1, 16384)).astype(np.float32)
    enc = jax.jit(lambda p, a: jm.apply(p, a, method=lambda m, a: m.encoder(a)))
    z = np.asarray(enc(params, jnp.asarray(x.transpose(0, 2, 1)))).transpose(0, 2, 1)
    zq = (0.5 * np.random.RandomState(2).randn(*z.shape)).astype(np.float32)
    dec = jax.jit(lambda p, q: jm.apply(p, q, method=lambda m, q: m.decoder(q)))
    audio = np.asarray(dec(params, jnp.asarray(zq.transpose(0, 2, 1)))).transpose(0, 2, 1)
    with torch.inference_mode():
        tz = tm.encoder(torch.from_numpy(x))
        ta = tm.decoder(torch.from_numpy(zq))
    assert tz.dtype == ta.dtype == torch.float32
    assert _rel_l2(tz.numpy(), z) <= 2e-2
    assert _rel_l2(ta.numpy(), audio) <= 3e-2


def test_bfloat16_training_fails_in_jax_and_the_port_says_so(bf16_pair, tmp_path):
    """The JAX fault the port records rather than copies: the gradient of an
    L1 loss through JAX's bfloat16 model fails in the transpose of the
    decoder's out_conv (``vrvq_tpu/nn/layers.py:241-251``)."""
    jm, params, _ = bf16_pair
    x = jnp.asarray((0.3 * np.random.RandomState(3).randn(2, 1, 4096)).astype(np.float32))
    loss = lambda p: jnp.mean(jnp.abs(jm.apply(p, x, level=1.0)["audio"] - x))
    with pytest.raises(TypeError, match="same dtypes, got bfloat16, float32"):
        jax.eval_shape(jax.value_and_grad(loss), params)
    cfg = _cfg(tmp_path, **{"DAC_VRVQ.compute_dtype": "bfloat16"})
    with pytest.raises(NotImplementedError, match="bfloat16 gradient fails"):
        trainer.load(cfg, Tracker(), tmp_path / "run", device="cpu")
