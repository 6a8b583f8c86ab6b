"""The GAN train step, closed loop: each step takes ``rows`` excerpts of
``excerpt_s`` seconds at seeded offsets of a seeded pool of ``clips``
clips, made on the card before the step, with each row's VBR level drawn
from the seed in the configuration's range and pinned.

The program: the ``State`` that ``train/trainer.load`` builds from the
configuration (TF32 off, cuDNN's deterministic algorithms), the weights
replaced by the benchmark's, and its ``train_step`` (``train/loop.py``).
Set-up drives that same state through the first ``checked_steps`` steps,
which the reference follows; the window then runs steps until ``--seconds``
have passed.

``train_clips_per_s``: clips of the global batch over every step of the
window, over the window's seconds. Correct: the reference (plain PyTorch,
float32) takes the same weights, batches and levels through the checked
steps, and the harness compares, each as the gap between the program's
number and the reference's relative to the reference's: the first step's
generator and discriminator loss (``loss_gap``); the norm of each leaf's
first gradient as AdamW received it, read back from its first moment after
one step, against the larger of the leaf's norm and the median leaf's
(``grad_gap``: the median leaf's gap); and the norm of each leaf's change
over the checked steps, likewise (``change_gap``: the median leaf's gap,
leaving out leaves whose reference gradient is under a thousandth of the
median leaf's). The later steps' loss gaps and the worst leaves' gaps are
kept as counters: a code or a stage mask that flips at a near tie in a
forward moves the few leaves it feeds, and Adam's first updates amplify
rounding into the later steps' losses, so those swing from seed to seed. With the mix's ``impl`` set to
``control`` (the reference in TF32) or ``half_batch`` (the reference on the
first half of each batch) those stand in for the program."""

from __future__ import annotations

import gc
import os
import re
import shutil
import tempfile
import time
import wave

import numpy as np
import torch

from .. import clips, judge, weights, work
from ..reference.codec import Codec
from ..reference.train import Discriminator, TrainStep
from ..tracing import Tracer

_UNIT = {"snake1": 0, "conv1": 1, "snake2": 2, "conv2": 3}
_LEAF = {"v": "weight_v", "g": "weight_g", "bias": "bias", "alpha": "alpha",
         "codebook": "codebook.weight"}


def reference_name(key: str, n_enc: int, n_dec: int) -> str:
    """The reference's name of a program parameter (a frozen copy of the
    rules of ``vrvq_tpu_torch/convert.py``, with the discriminator's)."""
    path, leaf = key.rsplit(".", 1)
    rules = [
        (r"encoder\.in_conv", lambda m: "encoder.block.0"),
        (r"encoder\.block_(\d+)\.res(\d)\.(\w+)", lambda m: (
            f"encoder.block.{int(m[1]) + 1}.block.{m[2]}.block.{_UNIT[m[3]]}")),
        (r"encoder\.block_(\d+)\.snake", lambda m: f"encoder.block.{int(m[1]) + 1}.block.3"),
        (r"encoder\.block_(\d+)\.down", lambda m: f"encoder.block.{int(m[1]) + 1}.block.4"),
        (r"encoder\.snake", lambda m: f"encoder.block.{n_enc + 1}"),
        (r"encoder\.out_conv", lambda m: f"encoder.block.{n_enc + 2}"),
        (r"quantizer\.quantizers_(\d+)(\.in_proj|\.out_proj)?",
         lambda m: f"quantizer.quantizers.{m[1]}{m[2] or ''}"),
        (r"quantizer\.imp_subnet\.in_snake", lambda m: "quantizer.imp_subnet.in_block.0"),
        (r"quantizer\.imp_subnet\.in_conv", lambda m: "quantizer.imp_subnet.in_block.1"),
        (r"quantizer\.imp_subnet\.snake_(\d+)", lambda m: f"quantizer.imp_subnet.blocks.{m[1]}.0"),
        (r"quantizer\.imp_subnet\.conv_(\d+)", lambda m: f"quantizer.imp_subnet.blocks.{m[1]}.1"),
        (r"decoder\.in_conv", lambda m: "decoder.model.0"),
        (r"decoder\.block_(\d+)\.snake", lambda m: f"decoder.model.{int(m[1]) + 1}.block.0"),
        (r"decoder\.block_(\d+)\.up", lambda m: f"decoder.model.{int(m[1]) + 1}.block.1"),
        (r"decoder\.block_(\d+)\.res(\d)\.(\w+)", lambda m: (
            f"decoder.model.{int(m[1]) + 1}.block.{int(m[2]) + 2}.block.{_UNIT[m[3]]}")),
        (r"decoder\.snake", lambda m: f"decoder.model.{n_dec + 1}"),
        (r"decoder\.out_conv", lambda m: f"decoder.model.{n_dec + 2}"),
    ]
    for pattern, name in rules:
        m = re.fullmatch(pattern, path)
        if m:
            return f"{name(m)}.{_LEAF[leaf]}"
    raise KeyError(key)


def disc_reference_name(key: str, subs) -> str:
    sub, conv, leaf = key.split(".")
    base = f"discriminators.{subs.index(sub)}"
    m = re.fullmatch(r"conv_(\d+)|band_(\d+)_conv_(\d+)|conv_post", conv)
    if m[1] is not None:
        ref = f"{base}.convs.{m[1]}.0"
    elif m[2] is not None:
        ref = f"{base}.band_convs.{m[2]}.{m[3]}.0"
    else:
        ref = f"{base}.conv_post"
    return f"{ref}.{_LEAF[leaf]}"


class Feed:
    """The batches and levels of every step, from the seed: excerpts at
    seeded clips and offsets, gathered on the card."""

    def __init__(self, run, dev):
        mix, keys = run.mix, run.keys
        sr = keys["DAC_VRVQ.sample_rate"]
        self.rows, self.length = mix["rows"], int(mix["excerpt_s"] * sr)
        samples = int(mix["clip_s"] * sr)
        self.pool = clips.clips(mix["clips"], samples, sr,
                                weights.generator(run.seed, dev, 1), dev)
        self.rng = judge.rng(run.seed, 6)
        self.lo, self.hi = keys["DAC_VRVQ.level_min"], keys["DAC_VRVQ.level_max"]
        self.samples, self.dev = samples, dev
        self.steps = []

    def step(self, k: int):
        while len(self.steps) <= k:
            which = self.rng.integers(0, len(self.pool), self.rows)
            start = self.rng.integers(0, self.samples - self.length, self.rows)
            levels = self.rng.uniform(self.lo, self.hi, self.rows)
            self.steps.append((which, start, levels))
        which, start, levels = self.steps[k]
        idx = torch.from_numpy(start[:, None] + np.arange(self.length)).to(self.dev)
        audio = self.pool[torch.from_numpy(which).to(self.dev)[:, None], idx][:, None]
        return audio, torch.tensor(levels, dtype=torch.float32, device=self.dev)


def _data_dir() -> str:
    """A folder of one short wav under the temporary directory, for the
    datasets that ``trainer.load`` builds (the steps are fed by ``Feed``)."""
    folder = tempfile.mkdtemp(prefix="codec_bench_")
    with wave.open(os.path.join(folder, "a.wav"), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(44100)
        f.writeframes(np.zeros(44100, np.int16).tobytes())
    return folder


def _program(run, host_g, host_d, dev):
    from vrvq_tpu_torch.train import trainer
    from vrvq_tpu_torch.train.tracker import Tracker

    from .. import program

    folder = _data_dir()
    keys = dict(run.keys)
    for scope in ("train", "val", "test"):
        keys[f"{scope}/build_dataset.folders"] = {"music": [folder]}
    try:
        state = trainer.load(program.config(keys), Tracker(), os.path.join(folder, "ckpt"),
                             device=dev)
    finally:
        shutil.rmtree(folder, ignore_errors=True)  # the datasets are built, not read
    program.load_generator(state.train_state.generator, host_g)
    program.load_discriminator(state.train_state.discriminator, host_d)
    return state


def _first_grads(ts, n_enc, n_dec):
    """Each leaf's first gradient norm, from AdamW's first moment."""
    out = {}
    for net, opt, name_of in ((ts.generator, ts.opt_g, lambda k: reference_name(k, n_enc, n_dec)),
                              (ts.discriminator, ts.opt_d,
                               lambda k: disc_reference_name(k, ts.discriminator.names))):
        beta1 = opt.adamw.param_groups[0]["betas"][0]
        for key, p in net.named_parameters():
            m = opt.adamw.state[p]["exp_avg"]
            out[name_of(key)] = float(torch.linalg.vector_norm(m) / (1 - beta1))
    return out


def drive(run) -> None:
    dev = torch.device(run.device)
    keys, mix = run.keys, run.mix
    n_enc, n_dec = len(keys["DAC_VRVQ.encoder_rates"]), len(keys["DAC_VRVQ.decoder_rates"])
    checked = mix["checked_steps"]
    ref_g = weights.draw(Codec(keys).to(dev), run.seed, 0)
    ref_d = weights.draw(Discriminator(keys).to(dev), run.seed, 2)
    host_g, host_d = weights.host_state(ref_g), weights.host_state(ref_d)
    del ref_g, ref_d
    feed = Feed(run, dev)
    impl = mix.get("impl", "program")
    if impl != "program":
        return stand_in(run, feed, dev, impl)
    state = _program(run, host_g, host_d, dev)
    del host_g, host_d
    ts, step = state.train_state, state.train_step
    seen = {"losses": [], "grads": None}

    def one_step(k):
        audio, levels = feed.step(k)
        if run.fault == "half_batch":
            audio, levels = audio[: len(audio) // 2], levels[: len(levels) // 2]
        if run.fault == "unchanged_state":
            return {"loss": torch.tensor(0.0), "adv/disc_loss": torch.tensor(0.0)}
        with run.span("step"):
            out = step(ts, audio, levels=levels, depths=[])
        return out

    def snapshot():
        out = {}
        for net, name_of in ((ts.generator, lambda k: reference_name(k, n_enc, n_dec)),
                             (ts.discriminator,
                              lambda k: disc_reference_name(k, ts.discriminator.names))):
            for key, p in net.named_parameters():
                out[name_of(key)] = p.detach().to("cpu", copy=True)
        return out

    before = snapshot()
    for k in range(checked):
        out = one_step(k)
        seen["losses"].append((float(out["loss"]), float(out["adv/disc_loss"])))
        if k == 0 and run.fault != "unchanged_state":
            seen["grads"] = _first_grads(ts, n_enc, n_dec)
    after = snapshot()
    seen["change"] = {n: float(torch.linalg.vector_norm(after[n] - before[n])) for n in after}
    del before, after
    if dev.type == "cuda":
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    run.spans.clear()
    run.setup_s = time.perf_counter() - run.started

    tracer = Tracer() if run.trace else None
    if tracer:
        tracer.prime()
        tracer.start()
    t0 = time.perf_counter()
    k = 0
    while True:
        out = one_step(checked + k)
        k += 1
        if not torch.isfinite(out["loss"]):
            run.failed += 1
        elapsed = time.perf_counter() - t0
        if tracer and tracer.active and elapsed >= mix["trace_s"]:
            tracer.stop(units=k, run=run)
        if elapsed >= run.seconds:
            break
    if dev.type == "cuda":
        torch.cuda.synchronize()
    end = time.perf_counter()
    run.window_s = end - t0
    if tracer and tracer.active:
        tracer.stop(units=k)
    run.traced = tracer.summary if tracer else None
    run.units = run.attempted = k
    run.counters["rest_s"], run.counters["rest_units"] = run.untraced(end)
    run.e2e["train_clips_per_s"] = k * mix["rows"] * run.chips / run.window_s
    run.work = {"step_flops": work.train_step(keys, mix["rows"] * run.chips, feed.length)}
    if dev.type == "cuda":
        run.counters["window_peak_bytes"] = torch.cuda.max_memory_allocated()
        run.memory_peak_bytes = max(setup_peak, run.counters["window_peak_bytes"])
    del state, ts, step, out
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    judge_steps(run, feed, dev, seen)


def reference_steps(run, feed, dev, precision="exact", rows=None):
    """The reference through the checked steps: (losses, first-gradient
    norms, parameters after, initial parameters)."""
    keys = run.keys
    gen = weights.draw(Codec(keys).to(dev), run.seed, 0)
    disc = weights.draw(Discriminator(keys).to(dev), run.seed, 2)
    start = {**{k: v.detach().cpu().clone() for k, v in gen.state_dict().items()},
             **{k: v.detach().cpu().clone() for k, v in disc.state_dict().items()}}
    ref = TrainStep(gen, disc, keys)
    losses = []
    with judge.precision(precision):
        for k in range(run.mix["checked_steps"]):
            audio, levels = feed.step(k)
            if rows is not None:
                audio, levels = audio[:rows], levels[:rows]
            out = ref.step(audio, levels)
            losses.append((out["loss"], out["adv/disc_loss"]))
    names = list(gen.state_dict()) + list(disc.state_dict())
    firsts = ref.opt_g.first_grad + ref.opt_d.first_grad
    grads = {n: float(torch.linalg.vector_norm(g)) for n, g in zip(names, firsts)}
    end = {**{k: v.detach().cpu() for k, v in gen.state_dict().items()},
           **{k: v.detach().cpu() for k, v in disc.state_dict().items()}}
    return losses, grads, end, start


def _gaps(prog: dict, ref: dict, groups) -> np.ndarray:
    """Each leaf's |prog - ref| over the larger of its reference value and
    its network's median leaf's."""
    out = []
    for names in groups:
        names = [n for n in names if n in ref]
        if names:
            med = float(np.median([ref[n] for n in names]))
            out += [abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], med, 1e-30) for n in names]
    return np.array(out)


def judge_steps(run, feed, dev, seen) -> None:
    losses, grads, end, start = reference_steps(run, feed, dev)
    groups = [[n for n in grads if not n.startswith("discriminators.")],
              [n for n in grads if n.startswith("discriminators.")]]
    gaps = [[abs(p - r) / max(abs(r), 1e-30) for p, r in zip(ps, rs)]
            for ps, rs in zip(seen["losses"], losses)]
    run.counters["loss_gaps"] = gaps  # each checked step's (generator, discriminator)
    run.check("loss_gap", max(gaps[0]))
    grad = _gaps(seen["grads"] or {}, grads, groups)
    run.counters["grad_gap_worst"] = float(grad.max())
    run.check("grad_gap", float(np.median(grad)))
    moved = []
    for names in groups:
        med = float(np.median([grads[n] for n in names]))
        moved.append([n for n in names if grads[n] >= 1e-3 * med])
    d_ref = {n: float(torch.linalg.vector_norm(end[n] - start[n])) for g in moved for n in g}
    change = _gaps(seen["change"], d_ref, moved)
    run.counters["change_gap_worst"] = float(change.max())
    run.check("change_gap", float(np.median(change)))


def stand_in(run, feed, dev, impl) -> None:
    """The reference in the program's place: in TF32 (``control``) or on
    the first half of each batch (``half_batch``)."""
    rows = feed.rows // 2 if impl == "half_batch" else None
    losses, grads, end, start = reference_steps(
        run, feed, dev, "tf32" if impl == "control" else "exact", rows)
    seen = {"losses": losses, "grads": grads,
            "change": {n: float(torch.linalg.vector_norm(end[n] - start[n])) for n in end}}
    del end, start
    run.attempted = run.mix["checked_steps"]
    judge_steps(run, feed, dev, seen)
