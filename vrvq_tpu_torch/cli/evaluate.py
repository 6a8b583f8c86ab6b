"""Offline codec evaluation, the counterpart of ``scripts/evaluate.py``: the
full metric menu at each VBR level over a folder of audio::

    python -m vrvq_tpu_torch.cli.evaluate --args.load conf/vrvq/vrvq_a2.yml \
        --ckpt_dir ckpt --tag latest --data_dir <folder> --num_examples 30 \
        --out eval.json [--levels 0.5,1,2] [--visqol 1] [--duration 10]

The folder may hold wav, flac, mp3, mp4 and m4a files (``data/audio_io.py``).
The generator comes from ``--torch_ckpt``, ``--ckpt_dir``/``--ckpt_path`` at
``--tag``, or a seeded draw (``train/checkpoint.py: load_gen_params``);
``--fast`` (on by default) serves the fast profile
(``infer/fast.serving_model``). Each example (``--duration`` s of a
file, in sorted order) is encoded once and decoded at every level in one
batched pass (``LevelSweep``). Per level: SI-SDR, SDR, SI-SNR, SNR, L1, the
mel and multi-scale STFT losses of the config and, with ``--visqol``,
ViSQOL's NSIM and MOS (mean and std over examples), kbps and bits per frame;
then the codebooks' usage entropy at full depth, the Pearson r of the
importance map against frame energy, and the top level's metrics by class
for files named ``split_NNNN_<class>[+<class>]``. Writes ``--out``
(``eval.json``), prints the levels' report as JSON on stdout and returns the
report. Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import disable_tf32, resolve_device
from ..config import REPO, model_config, parse_args
from ..data.loaders import AudioLoader
from ..infer.fast import serving_model
from ..infer.sweep import DEFAULT_LEVELS, LevelSweep
from ..losses import L1Loss, MelSpectrogramLoss, MultiScaleSTFTLoss
from ..metrics import (_visqol_batch, cal_entropy, cal_metrics, codebook_usage,
                       mean_std)
from ..models.dac_vrvq import DAC_VRVQ
from ..train.checkpoint import load_gen_params

METRICS = ("SI-SDR", "SDR", "SI-SNR", "SNR", "L1", "mel", "stft")
LOSS_METRICS = ("mel", "stft")  # computed on the card, the rest on the host


def parse_levels(levels) -> List[float]:
    """``--levels`` as a list of floats: a comma-separated string, a lone
    number or a list."""
    if isinstance(levels, str):
        return [float(x) for x in levels.split(",")]
    if isinstance(levels, bool) or levels is None:
        raise ValueError(
            f"levels must be a number, comma-separated string, or list of "
            f"numbers; got {levels!r}")
    if isinstance(levels, (int, float)):
        return [float(levels)]
    if isinstance(levels, (list, tuple)):
        return [float(x) for x in levels]
    raise ValueError(
        f"levels must be a number, comma-separated string, or list of "
        f"numbers; got {type(levels).__name__}: {levels!r}")


def load_model(cfg, device, fast: bool = True) -> DAC_VRVQ:
    """The config's generator on ``device``, in the fast profile with
    ``fast`` (``infer/fast.serving_model``)."""
    disable_tf32()
    model = load_gen_params(cfg, DAC_VRVQ(model_config(cfg)), device).eval()
    return serving_model(model, fast)


def evaluate(cfg, model: Optional[DAC_VRVQ] = None,
             seconds: Optional[Dict[str, float]] = None) -> dict:
    """The report of ``cfg`` (see the module's docstring) for ``model`` (by
    default the config's, on ``--device``); ``seconds``, when given, gets the
    host-clock seconds of loading, the sweep, the metrics and ViSQOL."""
    if model is None:
        model = load_model(cfg, resolve_device(cfg.get("device", "cuda")),
                           fast=cfg.get("fast", True))
    device = next(model.parameters()).device
    seconds = {} if seconds is None else seconds
    seconds.update(load=0.0, sweep=0.0, metrics=0.0, visqol=0.0)
    mel_kwargs = cfg.kwargs("MelSpectrogramLoss")
    mel_kwargs.setdefault("sample_rate", model.sample_rate)
    state = SimpleNamespace(
        mel_loss=MelSpectrogramLoss(**mel_kwargs),
        stft_loss=MultiScaleSTFTLoss(**cfg.kwargs("MultiScaleSTFTLoss")),
        waveform_loss=L1Loss())

    levels = parse_levels(cfg.get("levels", DEFAULT_LEVELS))
    do_visqol = bool(cfg.get("visqol"))
    metrics = list(METRICS) + (["ViSQOL", "ViSQOL-MOS"] if do_visqol else [])

    loader = AudioLoader(sources=[cfg.get("data_dir")], shuffle=False)
    n = min(cfg.get("num_examples", 30), len(loader.audio_indices))
    sweeper = LevelSweep(model)
    n_q = model.n_codebooks
    codebook_size = model.config.codebook_size

    per_level = {lv: {m: [] for m in metrics + ["kbps", "bpf"]} for lv in levels}
    usage = [np.zeros(codebook_size, np.int64) for _ in range(n_q)]
    imp_energy_r = []
    clip_classes = []  # from split_0007_speech+noise-style stems
    for idx in range(n):
        t0 = time.perf_counter()
        item = loader(state=np.random.RandomState(idx),
                      sample_rate=model.sample_rate,
                      duration=cfg.get("duration", 10), num_channels=1,
                      global_idx=idx)  # every file in turn
        stem_parts = Path(item["path"]).stem.split("_", 2)
        clip_classes.append(stem_parts[2] if len(stem_parts) > 2 else "")
        audio = model.preprocess(torch.from_numpy(
            np.asarray(item["signal"].audio_data, np.float32)).to(device),
            model.sample_rate)
        t1 = time.perf_counter()
        enc = sweeper.encode(audio)
        results = sweeper.sweep(audio, levels, batched=True, enc=enc)
        ref = audio.cpu().numpy()
        recons = {lv: r["audio"][..., : ref.shape[-1]] for lv, r in results.items()}
        host = {lv: r.cpu().numpy() for lv, r in recons.items()}
        t2 = time.perf_counter()
        with torch.inference_mode():
            for lv in levels:
                for m in METRICS:
                    pair = ((recons[lv], audio) if m in LOSS_METRICS
                            else (host[lv], ref))
                    per_level[lv][m].append(cal_metrics(*pair, state, m))
                per_level[lv]["kbps"].append(results[lv]["kbps"])
                per_level[lv]["bpf"].append(results[lv]["bpf"])
        t3 = time.perf_counter()
        if do_visqol:  # NSIM and MOS from one gammatonegram pass a pair
            for lv in levels:
                v, mos = _visqol_batch(host[lv], ref)
                per_level[lv]["ViSQOL"].append(v)
                per_level[lv]["ViSQOL-MOS"].append(mos)
        t4 = time.perf_counter()
        # full-depth codebook usage (which entries the quantizers pick at
        # all, whatever the level's mask)
        for q, bc in enumerate(codebook_usage(enc["codes"].cpu().numpy(),
                                              codebook_size)):
            usage[q] += bc.astype(np.int64)
        # does the importance map follow each frame's energy? (Pearson r)
        if enc.get("imp_map") is not None:
            imp = enc["imp_map"].float().cpu().numpy()[0, 0]  # (T',)
            hop = model.hop_length
            t = imp.shape[0]
            frames = ref[0, 0, : t * hop].reshape(t, hop)
            energy_db = 10 * np.log10((frames ** 2).mean(axis=1) + 1e-10)
            if imp.std() > 0 and energy_db.std() > 0:
                imp_energy_r.append(float(np.corrcoef(imp, energy_db)[0, 1]))
        for part, dt in (("load", t1 - t0), ("sweep", t2 - t1),
                         ("metrics", t3 - t2), ("visqol", t4 - t3)):
            seconds[part] += dt
        print(f"evaluated {idx + 1}/{n}", file=sys.stderr)

    entropy, pct = cal_entropy(usage)
    report = {
        "num_examples": n,
        "levels": {
            f"level_{lv * n_q:.2f}": {
                **{m: dict(zip(("mean", "std"), mean_std(per_level[lv][m])))
                   for m in metrics},
                "kbps": float(np.mean(per_level[lv]["kbps"])),
                "bpf": float(np.mean(per_level[lv]["bpf"])),
            }
            for lv in levels
        },
        "codebook_entropy_bits": entropy,
        "codebook_usage_pct": pct,
    }
    if imp_energy_r:
        report["imp_map_energy_corr"] = dict(
            zip(("mean", "std"), mean_std(imp_energy_r)))

    if any(clip_classes):
        # the top level's rate-distortion by class: a mixed corpus hides
        # class-dependent failures (noise textures, harmonics) in the mean
        top = max(levels)
        by_class: dict = {}
        for metric in ("SI-SDR", "mel", "kbps") + (
                ("ViSQOL-MOS",) if do_visqol else ()):
            for cls, v in zip(clip_classes, per_level[top][metric]):
                for c in (cls.split("+") if cls else ["unknown"]):
                    by_class.setdefault(c, {}).setdefault(metric, []).append(float(v))
        report["per_class_top_level"] = {
            c: {m: dict(zip(("mean", "std"), mean_std(vs))) for m, vs in ms.items()}
            for c, ms in by_class.items()
        }

    out = cfg.get("out", "eval.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report["levels"], indent=2))
    print(f"wrote {out}", file=sys.stderr)
    return report


def main(argv: Optional[List[str]] = None,
         seconds: Optional[Dict[str, float]] = None) -> dict:
    return evaluate(parse_args(argv, base_dir=REPO), seconds=seconds)


if __name__ == "__main__":
    main(sys.argv[1:])
