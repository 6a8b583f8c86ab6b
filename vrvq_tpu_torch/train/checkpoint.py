"""Tagged checkpoints (counterpart of ``vrvq_tpu/train/checkpoint.py``).

Layout: ``{save_path}/{tag}/state.pt`` (``torch.save`` of both networks'
state dicts, both optimizers and the step) and ``{save_path}/{tag}/meta.json``
(the step and the tracker's state). ``latest`` is written at every save,
``best`` when the validation mel loss improves, ``{N}k`` at ``save_iters``.
Tensors are saved as they are, so a load restores them bit for bit.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

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
    where links fail), then ``meta.json``."""
    first = None
    for tag in tags:
        tag_dir = Path(save_path) / tag
        tag_dir.mkdir(parents=True, exist_ok=True)
        tmp = tag_dir / f"{STATE_FILE}.tmp"
        tmp.unlink(missing_ok=True)
        if first is None:
            torch.save({"step": state.step,
                        **{name: getattr(state, name).state_dict()
                           for name in ("generator", "discriminator", "opt_g",
                                        "opt_d")}}, tmp)
        else:
            try:
                os.link(first, tmp)
            except OSError:
                shutil.copyfile(first, tmp)
        os.replace(tmp, tag_dir / STATE_FILE)
        first = first or tag_dir / STATE_FILE
        meta = {"step": state.step, **(metadata or {})}
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
