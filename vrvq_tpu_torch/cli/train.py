"""Train CLI, the counterpart of ``scripts/train.py``::

    python -m vrvq_tpu_torch.cli.train --args.load conf/vrvq/vrvq_a2.yml \
        --save_path ckpt [--key value ...]

Any config key can be overridden (``--batch_size 16``, ``--num_iters 3``,
``--train/build_dataset.folders "{'music': ['wavs']}"``). Runs on the card
unless ``--device cpu`` is given.

On several cards it trains data-parallel, one process a card
(``vrvq_tpu_torch.parallel``):

  * under torchrun (``python -m torch.distributed.run --nproc_per_node N -m
    vrvq_tpu_torch.cli.train ...``) each process joins the group its
    environment names;
  * with the JAX trainer's flags across hosts (``--coordinator host:port
    --num_processes H --process_id h``, run once a host) it starts one
    process a card of this host, ranks h x C + local rank of H x C;
  * with neither, where more than one card is visible, it starts one
    process a card on ``spawn_world`` cards (the most that divide every
    micro-batch), as the JAX trainer puts every local device on its mesh;
    with one card it runs in this process.

Prints, as the last line of its output, a JSON summary of the run (rank 0's):
the device and the ranks, each step's metrics and host times (ms, after the
device finished), the peak device memory, the kernels' launch counts, and
the parameters that the last update left without a non-zero gradient.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from .. import resolve_device
from ..config import REPO, Config, parse_args
from ..kernels import LAUNCHES
from ..parallel import dist as pdist
from ..train.trainer import State, train

TORCHRUN = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


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
        "world": pdist.world(),
        "backend": dist.get_backend() if dist.is_initialized() else None,
        "steps": len(state.step_ms), "step": state.train_state.step,
        "step_ms": state.step_ms, "data_ms": state.data_ms,
        "metrics": state.metrics,
        "peak_memory_gib": (torch.cuda.max_memory_allocated(device) / 2 ** 30
                            if cuda else None),
        "launches": dict(LAUNCHES),
        "params_without_gradient": params_without_gradient(state),
    }


def run(cfg: Config, device: torch.device) -> Dict:
    """Train on ``device`` (this rank's) and return the summary."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    LAUNCHES.clear()
    state = train(cfg, save_path=cfg.get("save_path", "ckpt"), device=device)
    return summary(state)


def _rank(device: torch.device, cfg: dict, out_path: str) -> None:
    """One rank of a group this CLI started: rank 0 writes the summary."""
    out = run(Config(cfg), device)
    if pdist.rank() == 0:
        Path(out_path).write_text(json.dumps(out))


def spawn_world(batch_size: int, accum_steps: int, cards: int) -> int:
    """The ranks the start without flags takes: ``data_world_size`` of one
    micro-batch (``batch_size / accum_steps`` rows), since each rank holds
    its block of every micro-batch (``local_rows``)."""
    if batch_size % accum_steps:
        raise ValueError(f"batch_size {batch_size} is not divisible by "
                         f"grad_accum_steps={accum_steps}")
    return pdist.data_world_size(batch_size // accum_steps, cards)


def _start(n: int, cfg: Config, **jax_flags) -> Dict:
    """``n`` ranks of this host, one a card, in processes of their own (a
    group of this host, or with ``jax_flags`` this host's part of one across
    hosts); rank 0's summary (empty where rank 0 runs on another host)."""
    with tempfile.TemporaryDirectory() as tmp:
        out_path = Path(tmp) / "summary.json"
        pdist.spawn(_rank, n, cfg.to_dict(), str(out_path), **jax_flags)
        return json.loads(out_path.read_text()) if out_path.exists() else {}


def _worker_here(cfg: Config, device, **jax_flags) -> Dict:
    """This process as one rank (torchrun's, or of the JAX flags' group)."""
    device = pdist.init_distributed(device=device, **jax_flags)
    try:
        out = run(cfg, device)
        return out if pdist.rank() == 0 else {}
    finally:
        dist.destroy_process_group()


def main(argv: Optional[List[str]] = None) -> Dict:
    cfg = parse_args(argv, base_dir=REPO)
    device = resolve_device(cfg.get("device", "cuda"))
    cuda = device.type == "cuda"
    cards = torch.cuda.device_count() if cuda else 1
    jax_flags = {k: cfg.get(k) for k in ("coordinator", "num_processes", "process_id")
                 if cfg.get(k) is not None}
    if jax_flags:
        if cards > 1:
            out = _start(cards, cfg, **jax_flags)
        else:
            out = _worker_here(cfg, None if cuda else device, **jax_flags)
    elif all(k in os.environ for k in TORCHRUN):
        out = _worker_here(cfg, None if cuda else device)
    else:
        n = spawn_world(int(cfg.get("batch_size", 12)),
                        int(cfg.get("grad_accum_steps", 1)), cards)
        out = _start(n, cfg) if n > 1 else run(cfg, device)
    if out:
        print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
