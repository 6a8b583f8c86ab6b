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
trainer folds the step into its key. Batches are loaded on the host by
``BatchPrefetcher`` (the JAX trainer's ``_batch_iterator``: ``num_workers``
threads over the dataset's items, ``PREFETCH`` batches ahead of the step),
or serially between steps with ``num_workers: 0``; either way the batches
are the same, bit for bit, and the transforms run on the device, in the
loop. Every ``sample_freq`` steps (and at the last) ``save_samples`` writes
the ``val_idx`` items' audio and importance maps to TensorBoard, whose
writer rank 0 opens under ``{save_path}/logs`` where ``tensorboardX`` or
``torch.utils.tensorboard`` imports (``open_writer``); the tracker writes
the metrics there too.
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
Not ported: ``amp`` (nothing in the JAX package reads it) and bfloat16
training (``DAC_VRVQ.compute_dtype: bfloat16`` raises: the JAX package's
gradient fails there, see ``load``).
"""

from __future__ import annotations

import dataclasses
import inspect
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from .. import disable_tf32, resolve_device
from ..config import Config, ModelConfig, model_config
from ..convert import init_params
from ..data.audio_io import write_wav
from ..data.loaders import AudioDataset, AudioLoader, ConcatDataset
from ..data.transforms import TRANSFORMS, build_transform
from ..losses import L1Loss, MelSpectrogramLoss, MultiScaleSTFTLoss
from ..models.dac_vrvq import DAC_VRVQ
from ..models.discriminator import Discriminator
from ..parallel import dist as pdist
from ..utils import annotate
from . import checkpoint as ckpt
from .loop import make_train_step, make_val_step
from .state import TrainState, make_optimizer
from .tracker import Tracker

# plain keys the trainer and the train CLI read
TRAIN_KEYS = {"resume", "overwrite_ok", "tag", "batch_size", "val_batch_size",
              "num_iters", "save_iters", "valid_freq", "seed", "lambdas",
              "grad_accum_steps", "split_train_step", "remat", "save_path",
              "device", "coordinator", "num_processes", "process_id",
              "num_workers", "sample_freq", "val_idx"}
# keys of the JAX trainer that change nothing the port computes
NO_EFFECT = {
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
    # each step's spans ``trainer.step`` and ``trainer.data``, in ms
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
               rows: Optional[List[int]] = None, map_fn: Callable = map) -> Dict:
    """The collated items ``step * batch_size + i`` (mod the dataset) of the
    global batch's ``rows`` (all ``batch_size`` of them by default), each
    loaded through ``map_fn`` (a pool's ``map`` loads them in parallel)."""
    n = max(len(dataset), 1)
    rows = range(batch_size) if rows is None else rows
    items = list(map_fn(dataset.__getitem__,
                        [(step * batch_size + i) % n for i in rows]))
    return dataset.collate(items)


# batches a BatchPrefetcher loads ahead (the JAX trainer's _batch_iterator's)
PREFETCH = 2


class BatchPrefetcher:
    """The batches of steps ``start_step``, ``start_step + 1``, ... (each
    ``load_batch``'s, bit for bit: the items are drawn by index), loaded
    ahead by a producer thread that maps a pool of ``num_workers`` threads
    over each batch's items and keeps up to ``PREFETCH`` batches in a
    bounded queue. The counterpart of the JAX trainer's ``_batch_iterator``;
    ``rows`` are a rank's rows of every global batch (its ``local_slice``).

    Iterating yields ``(step, batch)``. An exception of the producer is
    raised in the consumer at the batch it failed on. The threads touch no
    device (the transforms stay with the consumer) and are daemons;
    ``close`` (or leaving the ``with`` block) stops and joins them."""

    def __init__(self, dataset, batch_size: int, start_step: int = 0,
                 num_workers: int = 4,
                 rows: Optional[List[int]] = None):
        self._args = (dataset, batch_size, rows)
        self._step = start_step
        self._queue: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        self._stop = threading.Event()
        self._pool = ThreadPoolExecutor(max_workers=max(1, num_workers),
                                        thread_name_prefix="batch-loader")
        self._thread = threading.Thread(target=self._produce, daemon=True,
                                        name="batch-prefetcher")
        self._thread.start()

    def _produce(self) -> None:
        dataset, batch_size, rows = self._args
        step = self._step
        try:
            while not self._stop.is_set():
                batch = load_batch(dataset, step, batch_size, rows, self._pool.map)
                if not self._put((step, batch)):
                    return
                step += 1
        except BaseException as exc:  # raised again in the consumer
            self._put(exc)

    def _put(self, item) -> bool:
        """Queue ``item`` unless the consumer closes first."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = self._queue.get()
        if isinstance(item, BaseException):
            self.close()
            raise item
        return item

    def close(self, timeout: float = 30.0) -> None:
        """Stop the producer and join it and the pool's threads."""
        self._stop.set()
        while True:  # unblock a producer waiting on a full queue
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout)
        self._pool.shutdown(wait=True, cancel_futures=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


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
    (float32, as the JAX package trains); its steps run cuDNN's
    deterministic algorithms (``loop``), so a step run twice, or resumed,
    gives the same bits. In a process group every rank calls it and starts
    from rank 0's parameters."""
    cfg = as_config(cfg)
    check_keys(cfg)
    config = model_config(cfg)
    if config.compute_dtype != "float32":
        raise NotImplementedError(
            f"DAC_VRVQ.compute_dtype: {config.compute_dtype} trains in neither "
            "package: the JAX model's bfloat16 gradient fails (the transpose of "
            "the decoder's out_conv, vrvq_tpu/nn/layers.py:241-251, raises "
            "'lax.conv_general_dilated requires arguments to have the same "
            "dtypes, got bfloat16, float32'), so the port trains in float32 "
            "only; bfloat16 serves (build_model, the CLIs)")
    device = resolve_device("cuda" if device is None else device)
    disable_tf32()
    seed = int(cfg.get("seed", 0))
    draw = torch.Generator().manual_seed(seed)
    generator = init_params(DAC_VRVQ(config), draw).to(device)
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


def open_writer(save_path):
    """A TensorBoard ``SummaryWriter`` on ``{save_path}/logs``: tensorboardX's,
    else ``torch.utils.tensorboard``'s, else None (as the JAX trainer, which
    tries tensorboardX only)."""
    logdir = f"{save_path}/logs"
    try:
        from tensorboardX import SummaryWriter

        return SummaryWriter(logdir=logdir)
    except ImportError:
        pass
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(log_dir=logdir)
    except ImportError:
        return None


def close_writer(writer) -> None:
    """Close a ``SummaryWriter`` and join the thread its close leaves
    running: tensorboardX queues events through a ``multiprocessing.Queue``,
    whose feeder thread outlives ``close``."""
    queues = [getattr(getattr(w, "event_writer", None), "_event_queue", None)
              for w in (getattr(writer, "all_writers", None) or {}).values()]
    writer.close()
    for q in queues:
        if hasattr(q, "join_thread"):
            q.join_thread()


@torch.no_grad()
def save_samples(state: State, val_idx: List[int], writer) -> None:
    """The ``val_idx`` items of the val set through the generator at level
    1: their audio at step 0 (``signal/sample_{i}.wav``), the reconstruction
    (``recons/sample_{i}.wav``) and the importance mask times 0.7
    (``imp_map/sample_{i}``, an image) at the tracker's step. Where the
    writer cannot encode audio (tensorboardX without ``soundfile``) the
    reconstructions go to ``{logdir}/samples/recons_{step}_{i}.wav``. Only
    the rank with the writer (rank 0) runs the forward: it has no collective
    here, where the JAX trainer's is a launch that every process joins."""
    if not val_idx or writer is None:
        return
    batch = state.val_data.collate([state.val_data[i] for i in val_idx])
    generator = state.train_state.generator
    audio = torch.from_numpy(np.ascontiguousarray(batch["signal"].audio_data))
    with torch.no_grad():
        out = generator(audio.to(state.device), level=1.0)
    step, sr = state.tracker.step, generator.sample_rate
    recons = out["audio"].float().cpu().numpy()
    try:
        for i in range(recons.shape[0]):
            if step == 0:
                writer.add_audio(f"signal/sample_{i}.wav", audio[i, 0].numpy(), step, sr)
            writer.add_audio(f"recons/sample_{i}.wav", recons[i, 0], step, sr)
    except ImportError:
        folder = Path(getattr(writer, "logdir", None) or writer.get_logdir()) / "samples"
        folder.mkdir(parents=True, exist_ok=True)
        for i in range(recons.shape[0]):
            write_wav(folder / f"recons_{step}_{i}.wav", recons[i], sr)
    if out.get("mask_imp") is not None:
        mask = out["mask_imp"].float().cpu().numpy() * 0.7
        for i in range(mask.shape[0]):
            writer.add_image(f"imp_map/sample_{i}", mask[i][None], step)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(cfg: Union[Config, Mapping], save_path: str = "ckpt",
          device=None, zero: bool = False) -> State:
    """Train for ``num_iters`` steps (from the ``tag`` checkpoint, ``latest``
    by default, with ``resume``), writing samples at every
    ``sample_freq``-th step and the last, validating and saving at every
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
    writer = open_writer(save_path) if rank == 0 else None
    try:
        tracker = Tracker(log_file=str(Path(save_path) / "log.txt") if rank == 0 else None,
                          rank=rank, writer=writer)
        state = load(cfg, tracker, save_path, resume=cfg.get("resume", False),
                     tag=cfg.get("tag", "latest"), device=device, zero=zero)
        num_workers = int(cfg.get("num_workers", 8))
        if num_workers > 0:
            with BatchPrefetcher(state.train_data, batch_size, tracker.step,
                                 num_workers, rows=rows) as batches:
                _loop(cfg, state, save_path, batch_size, rows, writer, batches)
        else:
            _loop(cfg, state, save_path, batch_size, rows, writer, None)
    finally:
        if writer is not None:
            close_writer(writer)
    return state


def _loop(cfg: Config, state: State, save_path, batch_size: int,
          rows: Optional[List[int]], writer,
          batches: Optional[BatchPrefetcher]) -> None:
    """``train``'s steps, from the tracker's step to ``num_iters``; each
    step's batch from ``batches`` or, without it, loaded here."""
    tracker, device = state.tracker, state.device
    seed = int(cfg.get("seed", 0))
    val_batch_size = int(cfg.get("val_batch_size", 10))
    num_iters = int(cfg.get("num_iters", 250000))
    save_iters = cfg.get("save_iters", []) or []
    valid_freq = int(cfg.get("valid_freq", 1000))
    sample_freq = int(cfg.get("sample_freq", 10000))
    val_idx = list(cfg.get("val_idx", range(8)))
    for step in range(tracker.step, num_iters):
        tracker.step = step
        with annotate("trainer.data") as data:
            if batches is None:
                batch = load_batch(state.train_data, step, batch_size, rows)
            else:
                loaded, batch = next(batches)
                assert loaded == step, (loaded, step)
            audio = prepare_audio(state.train_data, batch, device)
            _sync(device)
        with annotate("trainer.step") as timed:
            metrics = state.train_step(state.train_state, audio,
                                       generator=step_generator(seed, step, device))
            values = torch.stack([v.float().to(device) for v in metrics.values()]).tolist()
            _sync(device)
        state.data_ms.append(data.ns / 1e6)
        state.step_ms.append(timed.ns / 1e6)
        state.metrics.append(dict(zip(metrics, values)))
        tracker.log_metrics("train", state.metrics[-1])
        last = step == num_iters - 1
        if step % sample_freq == 0 or last:
            save_samples(state, val_idx, writer)
        if step % valid_freq == 0 or last:
            validate(state, val_batch_size)
            tags = ckpt.checkpoint_tags(step, save_iters,
                                        tracker.is_best("val", "mel/loss"))
            tracker.print(f"Saving to {save_path} tags={tags}")
            ckpt.save_checkpoint(state.train_state, save_path, tags,
                                 metadata={"tracker": tracker.state_dict()})
