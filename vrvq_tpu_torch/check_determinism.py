"""Whether a training step on the card is a pure function of its inputs.

``python -m vrvq_tpu_torch.check_determinism [--args.load CONF] [--out
PATH]`` builds the state of the config (``conf/vrvq/vrvq_a2.yml`` by
default) through ``trainer.load``, as ``train()`` does, on 32 seeded
synthetic 1 s wavs, in micro-batches of 16 x 0.38 s (``profile_train``'s
config). Then:

  * builds the state twice from the seed, and in each loads step 0's batch,
    runs its transforms and takes step 0 with the step's draws: how many
    elements of the two transformed batches differ, which metrics differ,
    and for each module (a generator's block, a sub-discriminator) how many
    elements of the gradients the update took, of the parameters and of
    AdamW's moments differ, with the gradients' relative L2;
  * runs the batch's transforms and a step under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``: every op
    that PyTorch knows has no deterministic CUDA version warns once, listed;
    then under ``torch.use_deterministic_algorithms(True)``: the error the
    first such op raises, or none. Ops that PyTorch makes deterministic in
    that mode (``index_add_``) neither warn nor raise there: the comparison
    of two runs is what shows them.

Prints one JSON line (also written to ``--out``) with the card's name and
power limit. The first run of a step builds the kernels.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
import warnings
from pathlib import Path

import torch

import vrvq_tpu_torch as port
from vrvq_tpu_torch.config import FLAGSHIP_YAML
from vrvq_tpu_torch.profile_train import WAVS, config
from vrvq_tpu_torch.train import trainer


def module_of(name: str) -> str:
    """``generator.<part>.<block>`` or ``discriminator.<sub-discriminator>``."""
    net, *rest = name.split(".")
    return ".".join([net, *rest[:2 if net == "generator" else 1]])


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"not read: {exc}"


def build(cfg, tmp: str, device: torch.device):
    state = trainer.load(cfg, trainer.Tracker(), tmp, device=device)
    batch = trainer.load_batch(state.train_data, 0, int(cfg["batch_size"]))
    return state, batch


def one_step(cfg, tmp: str, device: torch.device) -> dict:
    """Step 0 from the seed's state: its batch, metrics, and each
    parameter's gradient, value and AdamW moments after it, on the host."""
    state, batch = build(cfg, tmp, device)
    ts = state.train_state
    audio = trainer.prepare_audio(state.train_data, batch, device)
    metrics = state.train_step(ts, audio, generator=trainer.step_generator(
        int(cfg["seed"]), 0, device))
    out = {"audio": audio.cpu(), "metrics": {k: v.item() for k, v in metrics.items()},
           "grad": {}, "param": {}, "moments": {}}
    for net, opt in (("generator", ts.opt_g), ("discriminator", ts.opt_d)):
        for n, p in getattr(ts, net).named_parameters():
            key = f"{net}.{n}"
            out["grad"][key] = p.grad.detach().cpu()
            out["param"][key] = p.detach().cpu()
            moments = opt.adamw.state[p]
            out["moments"][key] = torch.cat([moments["exp_avg"].reshape(-1),
                                             moments["exp_avg_sq"].reshape(-1)]).cpu()
    del state, ts
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def bits_differ(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.reshape(-1).view(torch.int32) != b.reshape(-1).view(torch.int32)).sum())


def compare(a: dict, b: dict) -> dict:
    """Two ``one_step`` runs, module by module."""
    modules: dict = {}
    for kind in ("grad", "param", "moments"):
        for key, x in a[kind].items():
            row = modules.setdefault(module_of(key), {
                "elements": 0, "grad_elements_differ": 0,
                "param_elements_differ": 0, "moments_elements_differ": 0,
                "_sq": 0.0, "_ref": 0.0})
            row[f"{kind}_elements_differ"] += bits_differ(x, b[kind][key])
            if kind == "grad":
                row["elements"] += x.numel()
                row["_sq"] += float((x - b[kind][key]).double().square().sum())
                row["_ref"] += float(b[kind][key].double().square().sum())
    for row in modules.values():
        sq, ref = row.pop("_sq"), row.pop("_ref")
        row["grad_rel_l2"] = (sq / ref) ** 0.5 if ref > 0 else (0.0 if sq == 0 else float("inf"))
    return {
        "metrics_differ": {k: v - b["metrics"][k] for k, v in a["metrics"].items()
                           if v != b["metrics"][k]},
        "modules_differ": sorted(m for m, r in modules.items()
                                 if r["grad_elements_differ"] or r["param_elements_differ"]
                                 or r["moments_elements_differ"]),
        "modules": modules,
    }


def under_deterministic_mode(cfg, tmp: str, device: torch.device) -> dict:
    """The ops that warn under ``warn_only``, then the strict mode's error."""
    state, batch = build(cfg, tmp, device)
    seed = int(cfg["seed"])
    out = {}
    try:
        torch.use_deterministic_algorithms(True, warn_only=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            audio = trainer.prepare_audio(state.train_data, batch, device)
            state.train_step(state.train_state, audio,
                             generator=trainer.step_generator(seed, 0, device))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        out["warnings"] = sorted({str(w.message).split("\n")[0] for w in caught
                                  if "deterministic" in str(w.message)})
        torch.use_deterministic_algorithms(True)
        try:
            audio = trainer.prepare_audio(state.train_data, batch, device)
            state.train_step(state.train_state, audio,
                             generator=trainer.step_generator(seed, 1, device))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            out["raised"] = None
        except RuntimeError as exc:
            out["raised"] = str(exc).split("\n")[0]
    finally:
        torch.use_deterministic_algorithms(False)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--args.load", dest="load", default=FLAGSHIP_YAML)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    device = port.resolve_device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        wav_dir = Path(tmp) / "wavs"
        wav_dir.mkdir()
        for i in range(WAVS):
            port.Signal(port.synthetic_clip(1.0, 44100, 100 + i), 44100).write(
                wav_dir / f"clip_{i:02d}.wav")
        cfg = config(args.load, wav_dir)
        first, second = (one_step(cfg, tmp, device) for _ in range(2))
        result = {
            "card": power_limit(), "config": args.load,
            "batch": int(cfg["batch_size"]),
            "transforms_elements_differ": bits_differ(first["audio"], second["audio"]),
            "elements": sum(x.numel() for x in first["param"].values()),
            **compare(first, second),
            "deterministic_mode": under_deterministic_mode(cfg, tmp, device),
        }
    result["bit_identical"] = (not result["transforms_elements_differ"]
                               and not result["metrics_differ"]
                               and not result["modules_differ"])
    line = json.dumps(result)
    if args.out:
        Path(args.out).write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
