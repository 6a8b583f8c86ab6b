"""The port's train and inference CLIs on the CPU, the trainer's two repairs,
``load_gen_params``, and ``VolumeNorm`` against the JAX package's.

A small model (encoder 16 with rates 2/4/8, decoder 128, 4 codebooks of
64 x 4) on top of ``conf/vrvq/vrvq_a2_b64_1chip.yml`` (polynomial Snake in
both stacks, ``grad_accum_steps``, ``split_train_step``), at batch 4 as 2
micro-batches of 2 clips of 0.1 s from four seeded 1 s wavs.

Repairs: (a) a config key that the port does not implement raises with its
name, and ``grad_accum_steps`` is honoured (a batch it does not divide
raises), where both were silently ignored; (b) ``trainer.load`` runs on the
card unless asked otherwise, where it defaulted to the CPU.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vrvq_tpu.config import Config as JaxConfig
from vrvq_tpu.data import loaders as jloaders
from vrvq_tpu.data import transforms as jtransforms
from vrvq_tpu.models import DAC_VRVQ as JaxDAC
from vrvq_tpu.train.checkpoint import export_torch_state_dict
import vrvq_tpu_torch as port
from vrvq_tpu_torch.cli import inference as cli_inference
from vrvq_tpu_torch.cli import train as cli_train
from vrvq_tpu_torch.config import Config, model_config
from vrvq_tpu_torch.convert import state_dict_from_jax
from vrvq_tpu_torch.data import loaders as tloaders
from vrvq_tpu_torch.data import transforms as ttransforms
from vrvq_tpu_torch.parallel import dist as pdist
from vrvq_tpu_torch.train import checkpoint as ckpt
from vrvq_tpu_torch.train import trainer
from tests.test_torch_support import JAX_CFG, jitter, own_loudness_meters

torch.set_num_threads(1)

TINY_YML = """\
$include:
  - conf/vrvq/vrvq_a2_b64_1chip.yml
DAC_VRVQ.encoder_dim: 16
DAC_VRVQ.encoder_rates: [2, 4, 8]
DAC_VRVQ.decoder_dim: 128
DAC_VRVQ.decoder_rates: [8, 4, 2]
DAC_VRVQ.n_codebooks: 4
DAC_VRVQ.codebook_size: 64
DAC_VRVQ.codebook_dim: 4
Discriminator.periods: [2, 3]
Discriminator.fft_sizes: [512]
MultiScaleSTFTLoss.window_lengths: [512]
MelSpectrogramLoss.n_mels: [40]
MelSpectrogramLoss.window_lengths: [512]
MelSpectrogramLoss.mel_fmin: [0]
MelSpectrogramLoss.mel_fmax: [null]
batch_size: 4
grad_accum_steps: 2
val_batch_size: 4
valid_freq: 1
train/AudioDataset.duration: 0.1
val/AudioDataset.duration: 0.1
val/AudioDataset.n_examples: 4
"""


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    wavs = root / "wavs"
    wavs.mkdir()
    for i in range(4):
        port.Signal(port.synthetic_clip(1.0, 44100, 100 + i), 44100).write(
            wavs / f"clip_{i}.wav")
    (root / "tiny.yml").write_text(TINY_YML)
    return root


def _argv(tiny, save, *extra):
    folders = repr({"music": [str(tiny / "wavs")]})
    return ["--args.load", str(tiny / "tiny.yml"), "--save_path", str(save),
            "--device", "cpu", "--train/build_dataset.folders", folders,
            "--val/build_dataset.folders", folders, *extra]


def _state(path, tag="latest"):
    return torch.load(Path(path) / tag / ckpt.STATE_FILE, map_location="cpu",
                      weights_only=True)


def _same_bits(a, b, where=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same_bits(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            _same_bits(x, y, f"{where}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    else:
        assert a == b, (where, a, b)


@pytest.fixture(scope="module")
def runs(tiny):
    """Three steps straight; two steps, then resumed to three."""
    straight = cli_train.main(_argv(tiny, tiny / "a", "--num_iters", "3"))
    first = cli_train.main(_argv(tiny, tiny / "b", "--num_iters", "2"))
    resumed = cli_train.main(_argv(tiny, tiny / "b", "--num_iters", "3",
                                   "--resume", "true"))
    return straight, first, resumed


def test_cli_train_two_steps_then_resume(tiny, runs):
    straight, first, resumed = runs
    assert (straight["steps"], first["steps"], resumed["steps"]) == (3, 2, 1)
    assert straight["device"] == "cpu" and resumed["step"] == 3
    for out in runs:
        assert not out["params_without_gradient"], out["params_without_gradient"]
        assert all(np.isfinite(v) for m in out["metrics"] for v in m.values())
        assert out["metrics"][0]["other/batch_size"] == 4.0
    assert resumed["metrics"] == straight["metrics"][2:]
    _same_bits(_state(tiny / "a"), _state(tiny / "b"))
    assert json.loads((tiny / "a" / "latest" / "meta.json").read_text())["step"] == 3


def test_cli_inference_writes_the_sweep(tiny, runs):
    out = tiny / "results"
    n = cli_inference.main([
        "--args.load", str(tiny / "tiny.yml"), "--ckpt_dir", str(tiny / "a"),
        "--tag", "latest", "--data_dir", str(tiny / "wavs"),
        "--save_result_dir", str(out), "--device", "cpu", "--num_examples", "1",
        "--duration", "0.5", "--levels", "[0.5, 1.0]"])
    assert n == 1
    meta = json.loads((out / "0" / "metadata.json").read_text())
    assert set(meta) == {"level_2.00", "level_4.00"}
    for level in ("2.00", "4.00"):
        assert (out / "0" / f"recon_{level}.wav").exists()
    # the mask PNG (written without matplotlib) decodes to its stages' bands
    image = pytest.importorskip("matplotlib.image")
    png = image.imread(out / "0" / "imp_map_4.00.png")
    frames = -(-int(0.5 * 44100) // (2 * 4 * 8))  # the tiny model's hop
    assert png.shape == (4 * 24, 2 * frames, 3)
    colours = {tuple(np.round(c * 255).astype(int)) for c in png.reshape(-1, 3)}
    assert colours <= {(68, 1, 84), (253, 231, 37)} and len(colours) == 2


def test_unported_config_keys_raise_with_their_names(tiny, tmp_path):
    """Repair (a): each of these keys used to be ignored without a word.
    (``remat`` and the multi-host flags are ported: see the next test; the
    packing keys train: ``test_encoder_packed_trains_a_step``.)"""
    for extra, name in ((["--DAC_VRVQ.encoder_packing", "true"], "DAC_VRVQ.encoder_packing"),
                        (["--Discriminator.channels", "32"], "Discriminator.channels"),
                        (["--zero", "true"], "zero")):
        with pytest.raises(NotImplementedError, match=name):
            cli_train.main(_argv(tiny, tmp_path / name, *extra))
        assert not (tmp_path / name).exists()


def test_encoder_packed_trains_a_step(tiny, tmp_path):
    """``--DAC_VRVQ.encoder_packed true`` (a key JAX's trainer reads) trains
    one step with the time-packed first encoder stage."""
    out = cli_train.main(_argv(tiny, tmp_path / "p", "--num_iters", "1",
                               "--DAC_VRVQ.encoder_packed", "true"))
    assert out["steps"] == 1
    assert all(np.isfinite(v) for v in out["metrics"][0].values())
    cfg = Config.load(tiny / "tiny.yml", overrides={"DAC_VRVQ.encoder_packed": True})
    assert port.DAC_VRVQ(model_config(cfg)).encoder.packed


def test_remat_trains_and_multi_host_flags_reach_init_distributed(tiny, tmp_path,
                                                                  monkeypatch):
    """``--remat true`` trains; JAX's multi-host flags reach
    ``init_distributed`` as they are (one host of one CPU process: a gloo
    group of 1), and the run reports the group."""
    seen = []
    real = pdist.init_distributed

    def spy(*args, **kwargs):
        seen.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(pdist, "init_distributed", spy)
    coordinator = f"localhost:{pdist.free_port()}"
    out = cli_train.main(_argv(tiny, tmp_path / "r", "--num_iters", "1", "--remat", "true",
                               "--coordinator", coordinator, "--num_processes", "1",
                               "--process_id", "0"))
    assert seen == [dict(device=torch.device("cpu"), coordinator=coordinator,
                         num_processes=1, process_id=0)]
    assert (out["world"], out["backend"], out["steps"]) == (1, "gloo", 1)
    assert all(np.isfinite(v) for v in out["metrics"][0].values())
    assert not pdist.dist.is_initialized()


def test_grad_accum_steps_is_honoured(tiny, tmp_path):
    """Repair (a): 3 micro-batches do not divide a batch of 4."""
    with pytest.raises(ValueError, match="grad_accum_steps=3"):
        cli_train.main(_argv(tiny, tmp_path / "r", "--num_iters", "1",
                             "--grad_accum_steps", "3"))


def test_trainer_load_defaults_to_the_card(tiny, tmp_path):
    """Repair (b): ``trainer.load`` without a device runs on the card; with
    no CUDA it raises rather than build on the CPU."""
    cfg = Config.load(tiny / "tiny.yml")
    if torch.cuda.is_available():
        state = trainer.load(cfg, trainer.Tracker(), tmp_path)
        assert state.device.type == "cuda"
        assert next(state.train_state.generator.parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            trainer.load(cfg, trainer.Tracker(), tmp_path)
    state = trainer.load(cfg, trainer.Tracker(), tmp_path, device="cpu")
    assert state.device.type == "cpu"


def test_load_gen_params_three_sources(tiny, runs, tmp_path):
    jm = JaxDAC(**JAX_CFG)
    params = jax.jit(lambda r: jm.init(r, jnp.zeros((1, 1, 4096))))(
        {"params": jax.random.PRNGKey(0), "vbr": jax.random.PRNGKey(1),
         "vbr_dropout": jax.random.PRNGKey(2)})
    params = jitter(jax.tree_util.tree_map(np.asarray, params), 10)
    torch.save({"state_dict": {k: torch.tensor(v) for k, v in
                               export_torch_state_dict(params).items()}},
               tmp_path / "weights.pth")
    want = state_dict_from_jax(params)
    model = ckpt.load_gen_params(Config({"torch_ckpt": str(tmp_path / "weights.pth")}),
                                 port.DAC_VRVQ(port.small_config()), "cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    cfg = Config.load(tiny / "tiny.yml")
    cfg.update({"ckpt_dir": str(tiny / "a"), "tag": "latest"})
    model = ckpt.load_gen_params(cfg, port.DAC_VRVQ(port.config.model_config(cfg)), "cpu")
    _same_bits(model.state_dict(), _state(tiny / "a")["generator"])
    a = ckpt.load_gen_params(Config(), port.DAC_VRVQ(port.small_config()), "cpu")
    b = port.init_params(port.DAC_VRVQ(port.small_config()),
                         torch.Generator().manual_seed(0))
    _same_bits(a.state_dict(), b.state_dict())


def _volume_datasets(wavs, pkg_loaders, pkg_transforms, cfg):
    transform = pkg_transforms.build_transform(
        augment_prob=0.0, preprocess=["Identity"], augment=["Identity"],
        postprocess=["VolumeNorm", "RescaleAudio", "ShiftPhase"], cfg=cfg)
    loader = pkg_loaders.AudioLoader(sources=[str(wavs)], shuffle=True)
    return pkg_loaders.AudioDataset(loader, 44100, n_examples=6, duration=0.38,
                                    transform=transform)


@pytest.mark.parametrize("db", [["const", -16], ["uniform", -30, -10]])
def test_volume_norm_matches_jax(tiny, db):
    """conf/vrvq/vrvq_a2_lufs.yml's chain: the same gains (bit for bit) and
    the transformed batch within 1e-5."""
    own_loudness_meters()
    jds = _volume_datasets(tiny / "wavs", jloaders, jtransforms,
                           JaxConfig({"VolumeNorm.db": db}))
    tds = _volume_datasets(tiny / "wavs", tloaders, ttransforms,
                           Config({"VolumeNorm.db": db}))
    jitems = [jds[i] for i in range(6)]
    titems = [tds[i] for i in range(6)]
    gains = []
    for ji, ti in zip(jitems, titems):
        jg = ji["transform_args"]["Compose"]["postprocess"]["VolumeNorm"]["gain"]
        tg = ti["transform_args"]["Compose"]["postprocess"]["VolumeNorm"]["gain"]
        assert jg == tg
        gains.append(float(tg))
    assert len(set(gains)) > 1
    jbatch, tbatch = jds.collate(jitems), tds.collate(titems)
    want = jtransforms.apply_on_host(jds.transform, jbatch["signal"],
                                     jbatch["transform_args"]).audio_data
    got = tds.transform(torch.from_numpy(tbatch["signal"].audio_data),
                        **tbatch["transform_args"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_trainer_load_turns_tf32_off(tiny, tmp_path):
    """A rank that builds its state with ``trainer.load`` alone (no
    ``train()``) trains in float32: TF32 (PyTorch's default for cuDNN) is
    turned off by ``load`` itself."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        trainer.load(Config.load(tiny / "tiny.yml"), trainer.Tracker(), tmp_path,
                     device="cpu")
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
