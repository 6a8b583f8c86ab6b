"""Train CLI, the counterpart of ``scripts/train.py``::

    python -m vrvq_tpu_torch.cli.train --args.load conf/vrvq/vrvq_a2.yml \
        --save_path ckpt [--key value ...]

Any config key can be overridden (``--batch_size 16``, ``--num_iters 3``,
``--train/build_dataset.folders "{'music': ['wavs']}"``). Runs on the card
unless ``--device cpu`` is given. Training on more than one card is not
ported: the multi-host flags of ``scripts/train.py`` (``--coordinator``,
``--num_processes``, ``--process_id``) raise.

Prints, as the last line of its output, a JSON summary of the run: the
device, each step's metrics and host times (ms, after the device finished),
the peak device memory, the kernels' launch counts, and the parameters that
the last update left without a non-zero gradient.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional

import torch

from .. import resolve_device
from ..config import REPO, parse_args
from ..kernels import LAUNCHES
from ..train.trainer import State, train

MULTI_HOST = ("coordinator", "num_processes", "process_id")


def params_without_gradient(state: State) -> List[str]:
    ts = state.train_state
    return [f"{net}.{name}"
            for net, module in (("generator", ts.generator),
                                ("discriminator", ts.discriminator))
            for name, p in module.named_parameters()
            if p.grad is None or not bool(torch.count_nonzero(p.grad))]


def summary(state: State) -> Dict:
    device = state.device
    cuda = device.type == "cuda"
    return {
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "steps": len(state.step_ms), "step": state.train_state.step,
        "step_ms": state.step_ms, "data_ms": state.data_ms,
        "metrics": state.metrics,
        "peak_memory_gib": (torch.cuda.max_memory_allocated(device) / 2 ** 30
                            if cuda else None),
        "launches": dict(LAUNCHES),
        "params_without_gradient": params_without_gradient(state),
    }


def main(argv: Optional[List[str]] = None) -> Dict:
    cfg = parse_args(argv, base_dir=REPO)
    multi = [key for key in MULTI_HOST if cfg.get(key) is not None]
    if multi:
        raise NotImplementedError(
            f"{multi}: training on more than one card is not ported "
            "(ROADMAP Queue A item 7)")
    device = resolve_device(cfg.get("device", "cuda"))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    LAUNCHES.clear()
    state = train(cfg, save_path=cfg.get("save_path", "ckpt"), device=device)
    out = summary(state)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
