"""Training orchestration: config -> state -> steps, with validation and
tagged checkpoints, resumable.

Counterpart of ``vrvq_tpu/train/trainer.py``. ``cfg`` is a ``config.Config``
(``Config.load("conf/<exp>.yml")``; a plain dict of the merged YAML's keys
is wrapped in one): binding keys such as ``DAC_VRVQ.n_codebooks``, scoped
keys read under ``cfg.scope("train")`` or ``"val"``, plain keys such as
``lambdas``. A key that the port does not implement raises with its name
(``check_keys``). Batches are drawn by index (step * batch_size + i), so a
resumed run reads what an uninterrupted one would; each step's random draws
come from a ``torch.Generator`` seeded from ``(seed, step)``, as the JAX
trainer folds the step into its key. Data are loaded on the host between
steps (no prefetch thread); the transforms run on the device.
``grad_accum_steps`` K takes each update over K micro-batches
(``loop.make_train_step``); ``split_train_step`` is the same update in the
port; ``remat`` recomputes the generator's forward in its backward.

Data parallelism, as the JAX trainer's ``data`` mesh: run in a process group
(``parallel.init_distributed``; the train CLI starts one), each rank loads
only its rows of every global batch (``parallel.local_rows``), the step
averages the gradients over the ranks, and every rank ends each step with
the same parameters, those of the single-card step on the global batch.
Validation is data-parallel where the val batch divides the ranks and
replicated otherwise, its means averaged over the ranks. Rank 0 alone
guards against clobbering, writes the log and the checkpoints. ``zero``
shards AdamW's state over the ranks (an argument, as in JAX, not a key).
Not ported: ``amp``, sample logging and TensorBoard.
"""

from __future__ import annotations

import dataclasses
import inspect
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from .. import disable_tf32, resolve_device
from ..config import Config, ModelConfig, model_config
from ..convert import init_params
from ..data.loaders import AudioDataset, AudioLoader, ConcatDataset
from ..data.transforms import TRANSFORMS, build_transform
from ..losses import L1Loss, MelSpectrogramLoss, MultiScaleSTFTLoss
from ..models.dac_vrvq import DAC_VRVQ
from ..models.discriminator import Discriminator
from ..parallel import dist as pdist
from . import checkpoint as ckpt
from .loop import make_train_step, make_val_step
from .state import TrainState, make_optimizer
from .tracker import Tracker

# plain keys the trainer and the train CLI read
TRAIN_KEYS = {"resume", "overwrite_ok", "tag", "batch_size", "val_batch_size",
              "num_iters", "save_iters", "valid_freq", "seed", "lambdas",
              "grad_accum_steps", "split_train_step", "remat", "save_path",
              "device", "coordinator", "num_processes", "process_id"}
# keys of the JAX trainer that change nothing the port computes
NO_EFFECT = {
    "num_workers": "the port loads each batch on the host, with no worker pool",
    "sample_freq": "audio samples go to TensorBoard, which the port does not "
                   "write (nor does the JAX trainer without tensorboardX)",
    "val_idx": "as sample_freq",
    "transforms_on_host": "the port applies the transforms on the device",
}
# keys the port takes only at the value it runs
FIXED = {"amp": False}


def _args(obj, skip=()) -> set:
    if dataclasses.is_dataclass(obj):
        return {f.name for f in dataclasses.fields(obj)}
    return set(inspect.signature(obj).parameters) - {"self", *skip}


def _bindings() -> Dict[str, set]:
    """Each binding's arguments that the port implements."""
    out = {
        "DAC_VRVQ": _args(ModelConfig),
        "Discriminator": _args(Discriminator),
        "AdamW": {"lr", "betas"},
        "ExponentialLR": {"gamma", "warmup"},
        "MultiScaleSTFTLoss": _args(MultiScaleSTFTLoss),
        "MelSpectrogramLoss": _args(MelSpectrogramLoss),
        "AudioDataset": _args(AudioDataset, ("loaders", "sample_rate", "transform")),
        "AudioLoader": _args(AudioLoader, ("sources",)),
        "build_dataset": {"folders"},
        "build_transform": {"augment_prob", "preprocess", "augment", "postprocess"},
    }
    out.update({name: _args(cls, ("name",)) for name, cls in TRANSFORMS.items()})
    return out


def check_keys(cfg: Config) -> None:
    """Raise on every key of ``cfg`` that the port's trainer does not
    implement (or holds at a value it does not run), naming them all."""
    bindings = _bindings()
    bad = []
    for key, value in cfg.to_dict().items():
        scope, _, scoped = key.partition("/")
        name = scoped if scoped and scope in ("train", "val", "test") else key
        if "." in name:
            prefix, arg = name.split(".", 1)
            if arg not in bindings.get(prefix, ()):
                bad.append(key)
        elif name in FIXED:
            if bool(value) != FIXED[name]:
                bad.append(f"{key}: {value!r}")
        elif name not in TRAIN_KEYS and name not in NO_EFFECT:
            bad.append(key)
    if bad:
        raise NotImplementedError(
            f"config keys the port does not implement: {bad} (ROADMAP Queue A "
            "items 6-8)")


def as_config(cfg: Union[Config, Mapping]) -> Config:
    return cfg if isinstance(cfg, Config) else Config(dict(cfg))


@dataclasses.dataclass
class State:
    """What ``train`` builds and returns: the networks and optimizers
    (``train_state``), the steps, losses, data and tracker, and each train
    step's metrics and host times (ms, after the device finished)."""

    train_state: TrainState
    train_step: Callable
    val_step: Callable
    train_data: Any
    val_data: Any
    tracker: Tracker
    device: torch.device
    metrics: List[Dict[str, float]] = dataclasses.field(default_factory=list)
    step_ms: List[float] = dataclasses.field(default_factory=list)
    data_ms: List[float] = dataclasses.field(default_factory=list)


def build_dataset(cfg: Config, sample_rate: int, scope: str):
    """The scope's (``train``/``val``) dataset over its folders, with its
    transform."""
    with cfg.scope(scope):
        transform = build_transform(
            augment_prob=cfg.get("build_transform.augment_prob", 1.0),
            preprocess=cfg.get("build_transform.preprocess"),
            augment=cfg.get("build_transform.augment"),
            postprocess=cfg.get("build_transform.postprocess"),
            cfg=cfg,
        )
        folders = cfg.get("build_dataset.folders", {}) or {}
        datasets = [
            AudioDataset(AudioLoader(sources=sources, **cfg.kwargs("AudioLoader")),
                         sample_rate, transform=transform,
                         **cfg.kwargs("AudioDataset"))
            for sources in folders.values()
        ]
    dataset = datasets[0] if len(datasets) == 1 else ConcatDataset(datasets)
    dataset.transform = transform
    return dataset


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The step's generator, seeded from ``(seed, step)`` alone."""
    key = int(np.random.SeedSequence([seed, step]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(key)


def load_batch(dataset, step: int, batch_size: int,
               rows: Optional[List[int]] = None) -> Dict:
    """The collated items ``step * batch_size + i`` (mod the dataset) of the
    global batch's ``rows`` (all ``batch_size`` of them by default)."""
    n = max(len(dataset), 1)
    rows = range(batch_size) if rows is None else rows
    items = [dataset[(step * batch_size + i) % n] for i in rows]
    return dataset.collate(items)


@torch.no_grad()
def prepare_audio(dataset, batch: Dict, device: torch.device) -> torch.Tensor:
    """The batch's audio on ``device``, through the dataset's transform."""
    audio = torch.from_numpy(np.ascontiguousarray(batch["signal"].audio_data)).to(device)
    return dataset.transform(audio, **batch.get("transform_args", {})).contiguous()


def load(cfg: Union[Config, Mapping], tracker: Tracker, save_path,
         resume: bool = False, tag: str = "latest", device=None,
         zero: bool = False) -> State:
    """Build the networks (drawn from ``seed``, or resumed from ``tag``),
    optimizers (``zero``: AdamW's state sharded over the ranks), steps and
    datasets, on the card unless ``device`` says otherwise, with TF32 off
    (float32, as the JAX package trains). In a process group every rank
    calls it and starts from rank 0's parameters."""
    cfg = as_config(cfg)
    check_keys(cfg)
    device = resolve_device("cuda" if device is None else device)
    disable_tf32()
    seed = int(cfg.get("seed", 0))
    draw = torch.Generator().manual_seed(seed)
    generator = init_params(DAC_VRVQ(model_config(cfg)), draw).to(device)
    discriminator = init_params(
        Discriminator(**cfg.kwargs("Discriminator")), draw).to(device)

    adamw, explr = cfg.kwargs("AdamW"), cfg.kwargs("ExponentialLR")
    opt_kw = dict(lr=adamw.get("lr", 1e-4), betas=tuple(adamw.get("betas", (0.8, 0.99))),
                  gamma=explr.get("gamma", 1.0), warmup=explr.get("warmup", 0))
    train_state = TrainState(
        generator, discriminator,
        make_optimizer(generator.parameters(), max_grad_norm=1e3, zero=zero,
                       **opt_kw),
        make_optimizer(discriminator.parameters(), max_grad_norm=10.0, zero=zero,
                       **opt_kw))

    waveform_loss = L1Loss()
    stft_loss = MultiScaleSTFTLoss(**cfg.kwargs("MultiScaleSTFTLoss"))
    mel_kw = cfg.kwargs("MelSpectrogramLoss")
    mel_kw.setdefault("sample_rate", generator.sample_rate)
    mel_loss = MelSpectrogramLoss(**mel_kw)
    lambdas = cfg.get("lambdas", {})

    if resume:
        tracker.print(f"Resuming from {save_path}/{tag}")
        ckpt.load_checkpoint(save_path, train_state, tag)
        meta = ckpt.load_metadata(save_path, tag)
        tracker.load_state_dict(meta.get("tracker", {}))
        tracker.step = train_state.step
    pdist.broadcast_params_(generator)
    pdist.broadcast_params_(discriminator)

    return State(
        train_state=train_state,
        train_step=make_train_step(lambdas, stft_loss, mel_loss, waveform_loss,
                                   accum_steps=int(cfg.get("grad_accum_steps", 1)),
                                   remat=bool(cfg.get("remat", False))),
        val_step=make_val_step(stft_loss, mel_loss, waveform_loss),
        train_data=build_dataset(cfg, generator.sample_rate, "train"),
        val_data=build_dataset(cfg, generator.sample_rate, "val"),
        tracker=tracker,
        device=device,
    )


def validate(state: State, batch_size: int) -> Dict[str, float]:
    """The val step over the whole val set; its means, logged as ``val``.
    In a process group a val batch that divides the ranks is split into
    their blocks (its means averaged over them), any other runs whole on
    every rank."""
    n, world, rank = len(state.val_data), pdist.world(), pdist.rank()
    for start in range(0, n, batch_size):
        idxs = list(range(start, min(start + batch_size, n)))
        sharded = world > 1 and len(idxs) % world == 0
        if sharded:
            per = len(idxs) // world
            idxs = idxs[rank * per:(rank + 1) * per]
        audio = prepare_audio(state.val_data, state.val_data.collate(
            [state.val_data[i] for i in idxs]), state.device)
        out = state.val_step(state.train_state.generator, audio)
        values = torch.stack([v.float() for v in out.values()])
        if sharded:
            values = pdist.mean_over_ranks(values)
        state.tracker.log_metrics("val", dict(zip(out, values.tolist())))
    return state.tracker.done("val", f"Iteration {state.tracker.step}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(cfg: Union[Config, Mapping], save_path: str = "ckpt",
          device=None, zero: bool = False) -> State:
    """Train for ``num_iters`` steps (from the ``tag`` checkpoint, ``latest``
    by default, with ``resume``), validating and saving at every
    ``valid_freq``-th step and the last. Runs on the card unless ``device``
    says otherwise; float32 with TF32 off, as the JAX package trains
    (``amp: false``). In a process group every rank calls it with its own
    device (``zero``: AdamW's state sharded over the ranks)."""
    cfg = as_config(cfg)
    check_keys(cfg)
    device = resolve_device("cuda" if device is None else device)
    world, rank = pdist.world(), pdist.rank()
    batch_size = int(cfg.get("batch_size", 12))
    rows = pdist.local_rows(batch_size, rank, world, int(cfg.get("grad_accum_steps", 1)))
    latest = Path(save_path) / "latest"
    # A fresh run pointed at a directory that holds a checkpoint would
    # overwrite it at its first save: demand resume or overwrite_ok.
    clobber = rank == 0 and (
        not cfg.get("resume", False) and not cfg.get("overwrite_ok", False)
        and ((latest / "meta.json").exists() or (latest / ckpt.STATE_FILE).exists()))
    if pdist.broadcast_object(clobber):
        raise FileExistsError(
            f"{str(save_path)!r} already contains checkpoints; set resume: true "
            "to continue that run, overwrite_ok: true to discard it, or pick a "
            "fresh save_path")
    if rank == 0:
        Path(save_path).mkdir(parents=True, exist_ok=True)
    tracker = Tracker(log_file=str(Path(save_path) / "log.txt") if rank == 0 else None,
                      rank=rank)
    state = load(cfg, tracker, save_path, resume=cfg.get("resume", False),
                 tag=cfg.get("tag", "latest"), device=device, zero=zero)

    seed = int(cfg.get("seed", 0))
    val_batch_size = int(cfg.get("val_batch_size", 10))
    num_iters = int(cfg.get("num_iters", 250000))
    save_iters = cfg.get("save_iters", []) or []
    valid_freq = int(cfg.get("valid_freq", 1000))
    for step in range(tracker.step, num_iters):
        tracker.step = step
        t0 = time.perf_counter()
        audio = prepare_audio(state.train_data,
                              load_batch(state.train_data, step, batch_size, rows),
                              device)
        _sync(device)
        t1 = time.perf_counter()
        metrics = state.train_step(state.train_state, audio,
                                   generator=step_generator(seed, step, device))
        values = torch.stack([v.float().to(device) for v in metrics.values()]).tolist()
        _sync(device)
        t2 = time.perf_counter()
        state.data_ms.append(1e3 * (t1 - t0))
        state.step_ms.append(1e3 * (t2 - t1))
        state.metrics.append(dict(zip(metrics, values)))
        tracker.log_metrics("train", state.metrics[-1])
        last = step == num_iters - 1
        if step % valid_freq == 0 or last:
            validate(state, val_batch_size)
            tags = ckpt.checkpoint_tags(step, save_iters,
                                        tracker.is_best("val", "mel/loss"))
            tracker.print(f"Saving to {save_path} tags={tags}")
            ckpt.save_checkpoint(state.train_state, save_path, tags,
                                 metadata={"tracker": tracker.state_dict()})
    return state
