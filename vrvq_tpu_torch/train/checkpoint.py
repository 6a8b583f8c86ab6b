"""Tagged checkpoints (counterpart of ``vrvq_tpu/train/checkpoint.py``).

Layout: ``{save_path}/{tag}/state.pt`` (``torch.save`` of both networks'
state dicts, both optimizers and the step) and ``{save_path}/{tag}/meta.json``
(the step and the tracker's state). ``latest`` is written at every save,
``best`` when the validation mel loss improves, ``{N}k`` at ``save_iters``.
Tensors are saved as they are, so a load restores them bit for bit.
``load_gen_params`` gives an inference CLI its generator's parameters.
``save_torch_checkpoint`` and ``load_torch_checkpoint`` write and read the
reference's ``weights.pth`` (``{"state_dict": ...}`` in the reference's
layout, ``convert.state_dict_to_reference``), as the JAX package's do.

In a process group every rank calls ``save_checkpoint`` (a ZeRO optimizer's
state is gathered to rank 0 by all of them), rank 0 alone writes, and the
ranks wait for it. The file holds the replicated layout, so a checkpoint
saved by N ranks loads on M.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from ..parallel import dist as pdist
from .state import TrainState

STATE_FILE = "state.pt"


def checkpoint_tags(step: int, save_iters: List[int], is_best: bool) -> List[str]:
    """The tags to write at ``step``."""
    tags = ["latest"]
    if is_best:
        tags.append("best")
    if step in save_iters:
        tags.append(f"{step // 1000}k")
    return tags


def save_checkpoint(state: TrainState, save_path, tags: List[str],
                    metadata: Optional[Dict[str, Any]] = None) -> None:
    """Write ``state`` under every tag: the state file through a temporary
    name (serialized once; a further tag gets a hard link to it, or a copy
    where links fail), then ``meta.json``. Collective in a process group:
    rank 0 writes, every rank returns once it has."""
    sd = {"step": state.step,
          **{name: getattr(state, name).state_dict()
             for name in ("generator", "discriminator", "opt_g", "opt_d")}}
    if pdist.rank() == 0:
        _write(sd, save_path, tags, metadata)
    pdist.barrier()


def _write(sd: Dict[str, Any], save_path, tags: List[str],
           metadata: Optional[Dict[str, Any]]) -> None:
    first = None
    for tag in tags:
        tag_dir = Path(save_path) / tag
        tag_dir.mkdir(parents=True, exist_ok=True)
        tmp = tag_dir / f"{STATE_FILE}.tmp"
        tmp.unlink(missing_ok=True)
        if first is None:
            torch.save(sd, tmp)
        else:
            try:
                os.link(first, tmp)
            except OSError:
                shutil.copyfile(first, tmp)
        os.replace(tmp, tag_dir / STATE_FILE)
        first = first or tag_dir / STATE_FILE
        meta = {"step": sd["step"], **(metadata or {})}
        with open(tag_dir / "meta.json", "w") as f:
            json.dump(meta, f, indent=2, default=str)


def load_checkpoint(save_path, state: TrainState, tag: str = "latest") -> TrainState:
    """Load the tag's checkpoint into ``state`` (its modules and optimizers,
    in place, on their devices) and return it. The file is read to the CPU:
    ``load_state_dict`` moves each tensor to its parameter's device, and
    AdamW keeps its step counts on the CPU, where it made them."""
    sd = torch.load(Path(save_path) / tag / STATE_FILE, map_location="cpu",
                    weights_only=True)
    state.generator.load_state_dict(sd["generator"])
    state.discriminator.load_state_dict(sd["discriminator"])
    state.opt_g.load_state_dict(sd["opt_g"])
    state.opt_d.load_state_dict(sd["opt_d"])
    state.step = int(sd["step"])
    return state


def load_metadata(save_path, tag: str = "latest") -> Dict[str, Any]:
    with open(Path(save_path) / tag / "meta.json") as f:
        return json.load(f)


def save_torch_checkpoint(model, path) -> None:
    """Write ``model`` (a live codec) as a reference-loadable ``weights.pth``:
    ``{"state_dict": ...}`` of CPU float32 tensors in the reference's layout."""
    from ..convert import state_dict_to_reference

    torch.save({"state_dict": state_dict_to_reference(model)}, path)


def load_torch_checkpoint(path, model):
    """Load a reference ``weights.pth`` (``{"state_dict": ...}``, or the dict
    itself) into ``model`` (a live codec of its config); returns ``model``."""
    from ..convert import state_dict_from_reference

    sd = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state_dict_from_reference(sd.get("state_dict", sd), model))
    return model


def load_gen_params(cfg, model, device=None):
    """``model`` (a live ``DAC_VRVQ``) with its parameters from the config,
    on ``device`` (the card by default), as the JAX package's
    ``load_gen_params`` gives them: a reference-layout state dict at
    ``torch_ckpt`` (``{"state_dict": ...}`` as the JAX package's
    ``save_torch_checkpoint`` writes, or the dict itself); else the
    generator of the port's checkpoint ``ckpt_path`` (or ``ckpt_dir``) at
    ``tag`` (``latest`` by default); else drawn from seed 0."""
    from .. import resolve_device
    from ..convert import init_params

    device = resolve_device("cuda" if device is None else device)
    torch_ckpt = cfg.get("torch_ckpt")
    base = cfg.get("ckpt_path") or cfg.get("ckpt_dir")
    if torch_ckpt:
        load_torch_checkpoint(torch_ckpt, model)
    elif base:
        sd = torch.load(Path(base) / cfg.get("tag", "latest") / STATE_FILE,
                        map_location="cpu", weights_only=True)
        model.load_state_dict(sd["generator"])
    else:
        init_params(model, torch.Generator().manual_seed(0))
    return model.to(device)
